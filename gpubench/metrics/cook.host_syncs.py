"""The node's host syncs a cook: the program's sync.count over the
FaceDeformNode.cook span (every blocking copy, event wait and host read
of a device value; the traced run's stage fences are not counted)."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    return None if cooks is None else spans.total(cooks, "sync.count") / len(cooks)
