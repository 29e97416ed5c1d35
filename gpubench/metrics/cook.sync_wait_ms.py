"""Host ms a cook spent blocked in its syncs: the program's sync.wait_ns
over the FaceDeformNode.cook span."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    return None if cooks is None else spans.total(cooks, "sync.wait_ns") * 1e-6 / len(cooks)
