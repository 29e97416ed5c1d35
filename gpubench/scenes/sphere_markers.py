"""The configurations' "scene": "sphere_markers": the mesh a UV sphere
(config "mesh": n_u x n_v interior vertices and two poles, quad faces), the
rig Fibonacci points on it (config "rig": markers; classes "octants" or
one class), and the blendshapes seeded normal bumps (config "shapes":
count, bump_radius, amplitude), made on the card and copied to the host
once, since the program takes host meshes."""

import numpy as np
import torch

from gpubench import inputs


def make(config: dict, seed: int, device) -> inputs.Scene:
    mesh, rig = config["mesh"], config["rig"]
    points, faces = inputs.uv_sphere(mesh["n_u"], mesh["n_v"])
    normals = (points / np.linalg.norm(points, axis=1, keepdims=True)).astype(np.float32)
    rest = inputs.fibonacci_points(rig["markers"])
    classes = (inputs.octants(rest) if rig["classes"] == "octants"
               else np.zeros(len(rest), np.int32))
    shapes = None
    sh = config.get("shapes")
    if sh and sh["count"]:
        dev_pts = torch.as_tensor(points, device=device)
        shapes = inputs.bump_shapes(dev_pts, sh["count"], sh["bump_radius"], sh["amplitude"],
                                    seed).cpu().numpy()
    return inputs.Scene(points, faces, normals, rest, classes, shapes)
