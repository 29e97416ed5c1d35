"""PU patch sets and eval plans built a cook: the program's pu.patch_sets +
pu.plans over the FaceDeformNode.cook span (2 where every pose rebuilds
both; 0 where a pose-only refit keeps them); None where the program has
no such counters."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    if cooks is None:
        return None
    from facedeform_tpu_torch.utils.profiling import counters

    if not {"pu.patch_sets", "pu.plans"} <= set(counters()):
        return None
    return spans.total(cooks, "pu.patch_sets", "pu.plans") / len(cooks)
