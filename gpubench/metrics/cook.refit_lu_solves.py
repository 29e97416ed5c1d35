"""LU solves (triangular-solve pairs) a cook: the program's fit.lu_solves
over the FaceDeformNode.cook span; the refit's share of the solve stage,
whatever the solves cost."""

from gpubench import spans


def read(run):
    if run.unit != "cooks":
        return None
    cooks = spans.roots(run, spans.COOK)
    return None if cooks is None else spans.total(cooks, "fit.lu_solves") / len(cooks)
