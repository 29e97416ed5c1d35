"""1 - the union of the card's operation intervals over the wall of the
profiled shots."""


def read(run):
    return run.idle_pct() if run.unit == "frames" else None
