"""The node's host path, mean ms a cook: its `copy` and `output` stages
(Mesh.copy, the host copy of P) and the cook's wall outside every stage
(StageTimes, traced run)."""


def read(run):
    if run.unit != "cooks" or not run.requests:
        return None
    total = 0.0
    for r in run.requests:
        stages = sum(v for k, v in r.items() if k != "wall")
        total += r.get("copy", 0.0) + r.get("output", 0.0) + (r["wall"] - stages)
    return total / len(run.requests)
