"""The whole cook's share of the card's peak: the least time of all the
work one cook needs (the mix's `work` layers) over the wall of the
profiled cooks."""


def read(run):
    return run.mfu() if run.unit == "cooks" else None
