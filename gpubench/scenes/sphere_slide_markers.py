"""The configurations' "scene": "sphere_slide_markers": the mesh, rig and
classes of sphere_markers (config "mesh", "rig"), with blendshapes that
slide as well as bulge: each of sphere_markers' seeded normal bumps
(config "shapes": count, bump_radius, amplitude, the same sites) also
moves its vertices along the tangent plane, in a seeded direction of its
own, by "slide" times the amplitude, as a face's blendshapes move skin
along the face as well as off it.  A tangent-space pass's displacement has
no normal part, so a morph basis of normal bumps alone would give it zero
DBSE weights.  Made on the card, one pass a shape, and copied to the host
once."""

import numpy as np
import torch

from gpubench import inputs
from gpubench.scenes import sphere_markers


def slide_shapes(points: torch.Tensor, n: int, radius: float, amplitude: float, slide: float,
                 seed: int) -> torch.Tensor:
    """(n, V, 3) f32 blendshapes on points' device: inputs.bump_shapes'
    bumps (the same seeded sites), each also displaced along the tangent
    plane by slide * amplitude * bump in its own seeded direction."""
    g = inputs.rng(seed, inputs.STREAM_SHAPES)
    sites = inputs.fibonacci_points(4 * n)[g.choice(4 * n, n, replace=False)]
    sites = torch.as_tensor(sites, device=points.device)
    dirs = inputs.rng(seed, inputs.STREAM_SHAPES, 1).normal(0.0, 1.0, (n, 3))
    dirs = torch.as_tensor(dirs / np.linalg.norm(dirs, axis=1, keepdims=True),
                           dtype=torch.float32, device=points.device)
    normal = points / torch.linalg.norm(points, dim=1, keepdim=True)
    out = torch.empty((n,) + tuple(points.shape), dtype=torch.float32, device=points.device)
    for k in range(n):
        bump = torch.exp(-((points - sites[k]) ** 2).sum(-1) / (radius * radius))
        along = dirs[k] - (normal @ dirs[k])[:, None] * normal
        out[k] = points + amplitude * bump[:, None] * (normal + slide * along)
    return out


def make(config: dict, seed: int, device) -> inputs.Scene:
    s = sphere_markers.make(dict(config, shapes=None), seed, device)
    sh = config.get("shapes")
    shapes = None
    if sh and sh["count"]:
        dev_pts = torch.as_tensor(s.points, device=device)
        shapes = slide_shapes(dev_pts, sh["count"], sh["bump_radius"], sh["amplitude"],
                              sh["slide"], seed).cpu().numpy()
    return inputs.Scene(s.points, s.faces, s.normals, s.rest, s.classes, shapes)
