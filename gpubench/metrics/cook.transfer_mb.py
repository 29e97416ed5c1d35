"""MB (1e6 bytes) a cook copied between host and card: the program's
copy.dtoh_bytes + copy.htod_bytes over the FaceDeformNode.cook span."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    if cooks is None:
        return None
    return spans.total(cooks, "copy.dtoh_bytes", "copy.htod_bytes") * 1e-6 / len(cooks)
