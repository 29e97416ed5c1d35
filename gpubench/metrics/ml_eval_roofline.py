"""The layered, framed eval's share of its roofline in a cook: the least
time of one pose's needed multilayer eval (roofline/ml_eval.py) over the
device time of the kernels launched inside the node's `eval.apply` range
(#1 or #2 and its packing; the autotune's launches lie outside it),
profiled cooks.  None unless the profiled cooks' refits solved more than
one layer each (the program's fit.layers) and some launch of #1/#2
projected onto a tangent frame (eval.frame_launches); None where the
program has no such counters."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    if cooks is None:
        return None
    from facedeform_tpu_torch.utils.profiling import counters

    if not {"fit.layers", "eval.frame_launches"} <= set(counters()):
        return None
    if spans.total(cooks, "fit.layers") <= len(cooks) or \
            spans.total(cooks, "eval.frame_launches") == 0:
        return None
    return run.roofline_pct("ml_eval", "eval.apply")
