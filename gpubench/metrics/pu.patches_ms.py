"""Host ms a cook spent building the PU patch geometry (ops/pu.py
build_patches): the program's pu.patches spans under the
FaceDeformNode.cook span; None where the program records no such span."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    if cooks is None:
        return None
    from facedeform_tpu_torch.utils.profiling import spans as recorded

    ids = {s.request for s in cooks}
    ms = [s.ms for s in recorded() if s.name == "pu.patches" and s.request in ids]
    return sum(ms) / len(cooks) if ms else None
