"""The whole shot's share of the card's peak: the least time of all the
work one shot needs (the mix's `work` layers) over the wall of the
profiled shots."""


def read(run):
    return run.mfu() if run.unit == "frames" else None
