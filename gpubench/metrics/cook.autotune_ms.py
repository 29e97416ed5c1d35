"""Host ms a cook spent re-measuring the dense and culled eval kernels:
the eval.autotune spans under the FaceDeformNode.cook span (0 in a cook
that reuses its choice)."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    return None if cooks is None else spans.inner_ms(cooks, "eval.autotune") / len(cooks)
