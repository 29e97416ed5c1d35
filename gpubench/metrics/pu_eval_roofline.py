"""The PU eval's share of its roofline in a cook: the least time of one
pose's needed PU eval (roofline/pu_eval.py) over the device time of every
kernel launched inside the node's `eval` range (#7 and its packing, the
falloff), profiled cooks; None where the program recorded no pu.tiles
span (#7's call) under the cooks."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    if cooks is None:
        return None
    from facedeform_tpu_torch.utils.profiling import spans as recorded

    ids = {s.request for s in cooks}
    if not any(s.name == "pu.tiles" and s.request in ids for s in recorded()):
        return None
    return run.roofline_pct("pu_eval", "eval")
