"""Displacement-field Jacobians and attribute transport (port of
facedeform_tpu/ops/jacobian.py).

    d(x) = sum_l sum_j w_lj phi(|x - c_j| / eps_lj) + P(x) c
    J(x) = grad d = sum_lj w_lj phi'(s) 2 (x - c_j) / eps_lj^2 + C
    y    = x + f T d(x)    (f: per-vertex falloff, T: optional tangent
                            projection; both per-vertex data)
    F    = dy/dx = I + f T J
    n'   ~ F^-T n = cof(F) n / det(F)

J assembles from two contractions per layer, with g = 2 phi'(s) / eps^2:

    J[v,a,b] = (sum_lj g w)[va] x[vb] - (sum_lj g (w outer c))[vab]

This is the plain path: the CPU route and the twin of the CUDA Jacobian
kernel (ops/cuda_jacobian.py).  The mesh field gradient
(field_gradient_plan, apply_field_gradient, mesh_field_gradient) is the
least-squares gradient of a discrete per-vertex field over mesh 1-rings,
for fields with no closed-form Jacobian (the node's morph and PSD passes).
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops.kernels import pairwise_sqdist, phi_prime_s
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision


def jacobian_block(model, points: torch.Tensor, kernel: RBFKernel, term: PolyTerm) -> torch.Tensor:
    """Jacobian J[v, a, b] = d disp_a / d x_b at points; (V, 3, 3).
    Materializes (L, V, N) scratch: displacement_jacobian chunks it."""
    pts = points.float()
    d2 = pairwise_sqdist(pts, model.ctrl)                    # (V, N)
    inv_e2 = 1.0 / (model.eps * model.eps)                   # (L, N)
    s = d2[None, :, :] * inv_e2[:, None, :]                  # (L, V, N)
    g = 2.0 * phi_prime_s(kernel, s) * inv_e2[:, None, :]    # (L, V, N)
    n_layers, n = model.w_rbf.shape[0], model.w_rbf.shape[1]
    w_outer_c = (
        model.w_rbf[:, :, :, None] * model.ctrl[None, :, None, :]
    ).reshape(n_layers, n, 9)                                # (L, N, 3a*3b)
    with highest_precision():
        sum_gw = torch.einsum("lvn,lna->va", g, model.w_rbf)                 # (V, 3)
        t = torch.einsum("lvn,lnz->vz", g, w_outer_c).reshape(-1, 3, 3)
    jac = sum_gw[:, :, None] * pts[:, None, :] - t
    if PolyTerm(term) == PolyTerm.LINEAR and model.w_poly.shape[0] >= 4:
        # poly_basis = [1, x, y, z]: d(P c)_a / d x_b = w_poly[1 + b, a]
        jac = jac + model.w_poly[1:4].T[None, :, :]
    return jac


def displacement_jacobian(model, points: torch.Tensor, kernel: RBFKernel, term: PolyTerm,
                          chunk: int = 16384) -> torch.Tensor:
    """Chunked dense Jacobian of the displacement field; (V, 3, 3).
    Scratch is bounded at L * chunk * N regardless of V."""
    if points.shape[0] <= chunk:
        return jacobian_block(model, points, kernel, term)
    return torch.cat([
        jacobian_block(model, p, kernel, term) for p in torch.split(points, chunk)
    ])


#: degree cap for the transport neighbor table (padded_neighbors
#: max_degree=): the 1-ring LSQ gradient only needs a tangent-plane-
#: spanning subset, and the (V, Dmax, 3) gather temps scale with the
#: WORST degree (a 1M uv-sphere's poles have degree ~1000: ~12 GB
#: uncapped, ~200 MB at 16).  padded_neighbors stride-subsamples capped
#: rings, so they stay angularly spread.
TRANSPORT_MAX_DEGREE = 16


def _ring_outer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_d a[v, d, i] b[v, d, j] of (V, D, 3) stacks; (V, 3, 3).  A
    broadcast multiply and a sum over the ring: elementwise f32 has no
    TF32 path, and a million 3 x D x 3 batched GEMMs cost more on the GPU
    (see _matmul33)."""
    return torch.sum(a[:, :, :, None] * b[:, :, None, :], dim=1)


def field_gradient_plan(points: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The 1-ring least-squares gradient COEFFICIENTS c[v, d] =
    M_v^-1 (s_v e_vd); (V, D, 3).

    The LSQ gradient is linear in the field, G_v = sum_d u_vd (x) c_vd
    with u the neighbor field differences, so everything that depends only
    on the geometry (the edge gather, the Gram, its Cholesky solve) is
    this per-mesh plan, and apply_field_gradient's per-cook cost is one
    (V, D) gather and one contraction.

    Ridge: pole-adjacent uv-grid cells reach ~160:1 anisotropy, putting
    the smallest tangential Gram eigenvalue at ~4e-5 of the trace.  A
    1e-4 relative ridge sat above it and wiped out the azimuthal gradient
    there (a transported-normal error of 0.026 on a 1M uv-sphere); 3e-7
    keeps the whole tangent plane while staying ~3x above the f32 Gram
    noise floor.  The along-normal derivative is whatever the ring's
    curvature supports; the cofactor normal rule never reads it.

    Solved by a closed-form 3x3 Cholesky of the trace-normalized Gram
    (backward stable for PD matrices without pivoting; clamped pivots
    absorb the rank-2 + ridge edge): elementwise operations, where a
    batched linear solve of a million 3x3 systems dominated the pass.
    Padded self-slots give e = 0, so c = 0 there: they stay inert.
    """
    points = points.float()
    nbr = nbr.long()
    e = points[nbr] - points[:, None, :]                  # (V, D, 3)
    a = _ring_outer(e, e)                                 # E E^T (V, 3, 3)
    tr = a[:, 0, 0] + a[:, 1, 1] + a[:, 2, 2]
    s = 1.0 / (tr + 1e-30)                                # scale-invariant
    m = a * s[:, None, None] + 3e-7 * torch.eye(3, dtype=a.dtype, device=a.device)
    rhs = e * s[:, None, None]                            # (V, D, 3)
    # closed-form Cholesky m = L L^T (m normalized: diag in [3e-7, 1])
    eps = 1e-12
    l11 = torch.sqrt(torch.clamp(m[:, 0, 0], min=eps))
    l21 = m[:, 1, 0] / l11
    l31 = m[:, 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(m[:, 1, 1] - l21 * l21, min=eps))
    l32 = (m[:, 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(m[:, 2, 2] - l31 * l31 - l32 * l32, min=eps))
    # m c = rhs_d per slot: L y = r, L^T c = y, batched over the D slots
    l11, l21, l31, l22, l32, l33 = (t[:, None] for t in (l11, l21, l31, l22, l32, l33))
    r1, r2, r3 = rhs[..., 0], rhs[..., 1], rhs[..., 2]    # (V, D) each
    y1 = r1 / l11
    y2 = (r2 - l21 * y1) / l22
    y3 = (r3 - l31 * y1 - l32 * y2) / l33
    c3 = y3 / l33
    c2 = (y2 - l32 * c3) / l22
    c1 = (y1 - l21 * c2 - l31 * c3) / l11
    return torch.stack([c1, c2, c3], dim=-1)              # (V, D, 3)


def apply_field_gradient(values: torch.Tensor, nbr: torch.Tensor,
                         coeff: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) LSQ gradient of a field given a field_gradient_plan:
    G_v = sum_d (u_j - u_v) c_vd^T, one gather and one contraction."""
    values = values.float()
    u = values[nbr.long()] - values[:, None, :]           # (V, D, 3)
    return _ring_outer(u, coeff)


def mesh_field_gradient(points: torch.Tensor, values: torch.Tensor,
                        nbr: torch.Tensor) -> torch.Tensor:
    """(V, 3, 3) least-squares spatial gradient of a discrete vector field
    over mesh 1-rings: G_v minimizes sum_j |G (x_j - x_v) - (u_j - u_v)|^2
    over the neighbors in nbr (the self-padded table of
    geometry.topology.padded_neighbors; padded slots contribute exact
    zeros).  field_gradient_plan + apply_field_gradient in one call;
    callers with a stable topology (the node) cache the plan."""
    return apply_field_gradient(values, nbr, field_gradient_plan(points, nbr))


def _matmul33(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-vertex 3x3 products a @ b of (V, 3, 3) stacks.  Written as one
    broadcast multiply and a 3-term sum: einsum sends these to batched
    GEMMs, a million 3x3 tiles that cost 10x more on the GPU (PERF.md,
    PR 2).  Elementwise f32 has no TF32 path."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _matvec3(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-vertex a @ x of a (V, 3, 3) stack and (V, 3) vectors."""
    return torch.sum(a * x[..., None, :], dim=-1)


def deformation_gradient(jac: torch.Tensor, weight: torch.Tensor, proj=None) -> torch.Tensor:
    """F = I + f (T) J for the applied map y = x + f (T) d(x); (V, 3, 3).

    weight: (V,) falloff weights apply() used (falloff * group gate);
    proj: optional (V, 3, 3) tangent projections
    (ops.tangent.tangent_projection_matrix) when cfg.tangent is on."""
    if proj is not None:
        jac = _matmul33(proj, jac)
    eye = torch.eye(3, dtype=jac.dtype, device=jac.device)
    return eye[None, :, :] + weight[:, None, None] * jac


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return profiling.to_device(x, like.device, torch.float32)


def tangent_projection(cfg, frame, like: torch.Tensor):
    """The (V, 3, 3) tangent projections apply() composes, or None: only
    when cfg.tangent is set AND a frame is given."""
    if cfg is None or not getattr(cfg, "tangent", False) or frame is None:
        return None
    from facedeform_tpu_torch.ops.tangent import tangent_projection_matrix

    return tangent_projection_matrix(*(_f32(f, like) for f in frame))


def _applied_gradient(jac, weight, cfg=None, frame=None) -> torch.Tensor:
    """jac -> (tangent proj) -> F for the map the deformer applied."""
    return deformation_gradient(jac, _f32(weight, jac), tangent_projection(cfg, frame, jac))


def transport_normals(jac, normals, weight, cfg=None, frame=None) -> torch.Tensor:
    """jac -> (tangent proj) -> F -> cofactor transport of normals."""
    f = _applied_gradient(jac, weight, cfg, frame)
    return transform_normals(_f32(normals, f), f)


def _cofactor(m: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix, columns (m2 x m3, m3 x m1, m1 x m2)."""
    c1, c2, c3 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    return torch.stack([
        torch.linalg.cross(c2, c3), torch.linalg.cross(c3, c1), torch.linalg.cross(c1, c2),
    ], dim=-1)


def transform_normals(normals: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Transport unit normals through deformation gradients F; (V, 3).
    n' ~ cof(F) n, re-normalized; degenerate (zero cofactor) rows keep
    the input normal."""
    normals = normals.float()
    out = _matvec3(_cofactor(f), normals)
    nrm2 = torch.sum(out * out, dim=-1, keepdim=True)
    ok = nrm2 > 1e-24
    return torch.where(ok, out * torch.rsqrt(torch.clamp(nrm2, min=1e-24)), normals)


def transform_vectors(vectors: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Push tangent vectors through F: v' = F v; (V, 3).  Length is not
    preserved on purpose (Houdini's 'vector' typeinfo)."""
    return _matvec3(f, vectors.float())


def polar_rotation(f: torch.Tensor, iters: int = 14) -> torch.Tensor:
    """Rotation factor R of F = R S; (V, 3, 3).

    Higham determinant-scaled Newton: R <- (g R + (g R)^-T) / 2 with
    g = |det R|^(-1/3), the inverse-transpose from the cofactor matrix.
    Det scaling keeps the iteration count independent of anisotropy.
    Rows with det(F) <= 1e-12, or not orthogonal after the budget, return
    identity."""
    f = f.float()
    eye = torch.eye(3, dtype=torch.float32, device=f.device).expand(f.shape)

    def cof_det(m):
        cof = _cofactor(m)
        return cof, torch.sum(m[..., :, 0] * cof[..., :, 0], dim=-1)

    _, det0 = cof_det(f)
    valid = det0 > 1e-12
    r = torch.where(valid[..., None, None], f, eye)
    for _ in range(iters):
        cof, det = cof_det(r)
        g = torch.abs(det) ** (-1.0 / 3.0)
        # (gR)^-T = cof(gR) / det(gR) = g^2 cof(R) / (g^3 det R)
        inv_t = cof / (g * det)[..., None, None]
        r = 0.5 * (g[..., None, None] * r + inv_t)
    rtr = _matmul33(r.transpose(-1, -2), r)
    ortho = torch.amax(torch.abs(rtr - eye), dim=(-2, -1)) < 1e-2
    return torch.where((valid & ortho)[..., None, None], r, eye)


def quaternion_from_rotation(r: torch.Tensor) -> torch.Tensor:
    """Unit quaternions (x, y, z, w), Houdini `orient` layout, from
    rotation matrices (V, 3, 3): branch-free Shepperd, the best-conditioned
    of four pivot candidates per row; canonical sign w >= 0."""
    def m(a, b):
        return r[..., a, b]

    t0 = 1.0 + m(0, 0) + m(1, 1) + m(2, 2)
    t1 = 1.0 + m(0, 0) - m(1, 1) - m(2, 2)
    t2 = 1.0 - m(0, 0) + m(1, 1) - m(2, 2)
    t3 = 1.0 - m(0, 0) - m(1, 1) + m(2, 2)
    c0 = torch.stack([m(2, 1) - m(1, 2), m(0, 2) - m(2, 0), m(1, 0) - m(0, 1), t0], dim=-1)
    c1 = torch.stack([t1, m(0, 1) + m(1, 0), m(0, 2) + m(2, 0), m(2, 1) - m(1, 2)], dim=-1)
    c2 = torch.stack([m(0, 1) + m(1, 0), t2, m(1, 2) + m(2, 1), m(0, 2) - m(2, 0)], dim=-1)
    c3 = torch.stack([m(0, 2) + m(2, 0), m(1, 2) + m(2, 1), t3, m(1, 0) - m(0, 1)], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)                    # (V, 4, 4)
    pick = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)
    idx = pick[..., None, None].expand(*pick.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.rsqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True), min=1e-24))
    return q * torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b of (x, y, z, w) quaternions, broadcasting."""
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def transform_quaternions(quats: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Rotate orientation quaternions by F's rotation factor:
    q' = quat(polar(F)) * q, renormalized; (V, 4).  Stretch is discarded:
    an orient frame stays orthonormal."""
    qr = quaternion_from_rotation(polar_rotation(f))
    out = quaternion_multiply(qr, quats.float())
    return out * torch.rsqrt(torch.clamp(torch.sum(out * out, dim=-1, keepdim=True), min=1e-24))


def principal_stretches(f: torch.Tensor) -> torch.Tensor:
    """Singular values of F, descending, float32; (V, 3): sqrt of the
    eigenvalues of F^T F by the closed-form trigonometric symmetric-3x3
    formula.  The formula loses ~2e-5 in f32 when two singular values are
    within ~1e-4 of each other (the arccos of a near-+-1 argument), so it
    runs in float64: the JAX package's f32 was the TPU's limit, not the
    contract."""
    f = f.double()
    a = _matmul33(f.transpose(-1, -2), f)                           # F^T F
    a11, a22, a33 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a12, a13, a23 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a11 + a22 + a33) / 3.0
    p1 = a12 * a12 + a13 * a13 + a23 * a23
    p2 = (a11 - q) ** 2 + (a22 - q) ** 2 + (a33 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    safe_p = torch.clamp(p, min=1e-12)
    b11, b22, b33 = (a11 - q) / safe_p, (a22 - q) / safe_p, (a33 - q) / safe_p
    b12, b13, b23 = a12 / safe_p, a13 / safe_p, a23 / safe_p
    det_b = (b11 * (b22 * b33 - b23 * b23)
             - b12 * (b12 * b33 - b23 * b13)
             + b13 * (b12 * b23 - b22 * b13))
    r = torch.clamp(det_b / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.sqrt(torch.clamp(torch.stack([e1, e2, e3], dim=-1), min=0.0)).float()


#: transport rules by Houdini typeinfo-style kind
ATTR_KINDS = ("vector", "normal", "quaternion")

RULES = {
    "vector": transform_vectors,
    "normal": transform_normals,
    "quaternion": transform_quaternions,
}


def infer_attr_kind(name: str, values, typeinfo: str | None = None) -> str | None:
    """Best-effort kind from Houdini typeinfo, naming conventions + width.

    An explicit typeinfo is authoritative: vector/normal/quaternion when
    the width matches, None for anything else.  Without it: N/normal-ish
    (3-wide) -> normal, 4-wide -> quaternion, other 3-wide -> vector,
    anything else -> None."""
    width = values.shape[-1] if values.ndim == 2 else 1
    if typeinfo is not None:
        if typeinfo in ("vector", "normal") and width == 3:
            return typeinfo
        if typeinfo == "quaternion" and width == 4:
            return "quaternion"
        return None
    if width == 4:
        return "quaternion"
    if width != 3:
        return None
    if name in ("N", "normal") or name.startswith("N_"):
        return "normal"
    return "vector"


def transport_attrs(jac, attrs: dict, weight, cfg=None, frame=None, kinds: dict | None = None,
                    want_stretch: bool = False, f_map=None):
    """Transport point attributes through ONE shared F.

    attrs: {name: (V, 3) or (V, 4)}; kinds: optional {name: kind}
    overrides, the rest inferred (an uninferable kind raises ValueError);
    f_map: optional (V, 3, 3) -> (V, 3, 3) post-composition of F.
    Returns {name: transported} in input order, plus the (V, 3) principal
    stretches when want_stretch."""
    f = _applied_gradient(jac, weight, cfg, frame)
    if f_map is not None:
        f = f_map(f)
    out = {}
    for name, values in attrs.items():
        kind = (kinds or {}).get(name) or infer_attr_kind(name, values)
        if kind not in RULES:
            raise ValueError(
                f"attribute {name!r}: no transport rule for kind {kind!r} "
                f"(shape {tuple(values.shape)}); expected one of {ATTR_KINDS}"
            )
        out[name] = RULES[kind](_f32(values, f), f)
    if want_stretch:
        return out, principal_stretches(f)
    return out
