"""PyTorch port: what the dense and culled eval kernels (csrc/eval.cu) read,
checked on the CPU where the kernels cannot run.

- The packed control records (cuda_eval.control_records, culled_tables;
  on the CPU their plain twins, which the card's packing kernels are held
  to bit for bit), read back through the layout the kernels use, hold the
  model's controls, 1/eps^2 and weights, padded rows included.
- The 32-control sub-slab table holds its controls, inside its slab.
- A mirror of the culled kernel's two-level skip (block bbox against
  128-control slabs, warp bbox against 32-control sub-slabs) never drops a
  pair within the cutoff and computes fewer pairs than a block-only rule,
  at the block and warp sizes of one, two and four vertices a thread.
- An emulation of the kernels' pair loop over the records, in their
  summation order and skips, matches the plain twin at the kernels'
  on-card tolerances.
- The C ABI the Python side declares matches the sources.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.geometry.primitives import fibonacci_points, uv_sphere
from facedeform_tpu_torch.ops import cuda_eval
from facedeform_tpu_torch.ops.evaluate import _center_phi
from facedeform_tpu_torch.ops.fit import GROWING_KERNELS, RBFModel
from facedeform_tpu_torch.ops.kernels import apply_kernel
from facedeform_tpu_torch.ops.morton import spatial_order
from facedeform_tpu_torch.utils import profiling

K = RBFKernel
CSRC = Path(cuda_eval.__file__).resolve().parent.parent / "csrc"
# kernel vs plain tolerances on the card (chip_smoke.py): positions,
# decaying / growing bases, and falloff
POS_TOL_DECAYING, POS_TOL_GROWING, FALLOFF_TOL = 5e-6, 5e-5, 1e-6
# (vertices a block, vertices a warp) of 128-thread blocks at 2, 4 and 1
# vertices a thread; the built kernel's is cuda_eval.cull_geometry()
GEOMETRIES = ((256, 64), (512, 128), (128, 32))


def _model(n, n_layers, kernel, seed=0, radii=None):
    """Fibonacci controls with seeded radii and weights (layer-0 weights sum
    to zero); radii (lo, hi), by default wide for growing bases and a few
    control spacings for decaying ones."""
    rng = np.random.default_rng(seed)
    lo, hi = radii or ((1.0, 2.0) if kernel in GROWING_KERNELS else (0.15, 0.4))
    w = rng.standard_normal((n_layers, n, 3)) * (0.05 / np.sqrt(n))
    w[0] -= w[0].mean(axis=0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return RBFModel(ctrl=t(fibonacci_points(n)), w_rbf=t(w),
                    w_poly=t(rng.standard_normal((4, 3)) * 0.01),
                    eps=t(rng.uniform(lo, hi, (n_layers, n))))


def _read_records(rec):
    """Walk the records as the kernels do: control j's first float4 at
    j * (1 + L), then one per layer, 1/eps^2 of layer l + 1 in the fourth
    word of layer l's record."""
    n, r, _ = rec.shape
    flat = rec.reshape(-1, 4)
    ctrl, ie, w = [], [], []
    for j in range(n):
        c = flat[j * r]
        ctrl.append(c[:3])
        ies, ws, nxt = [], [], c[3]
        for layer in range(r - 1):
            rw = flat[j * r + 1 + layer]
            ies.append(nxt)
            ws.append(rw[:3])
            nxt = rw[3]
        assert nxt == 0.0  # the last layer's fourth word
        ie.append(torch.stack(ies))
        w.append(torch.stack(ws))
    return torch.stack(ctrl), torch.stack(ie, 1), torch.stack(w, 1)


@pytest.mark.parametrize("tail_rows", [0, 1, 4])
@pytest.mark.parametrize("n_layers", [1, 3, 6])
def test_control_records_layout(n_layers, tail_rows):
    m = _model(300, n_layers, K.GAUSSIAN)
    m = RBFModel(ctrl=m.ctrl, w_rbf=m.w_rbf, eps=m.eps, w_poly=m.w_poly[:tail_rows].contiguous())
    ie = cuda_eval._inv_eps2(m.eps)
    before = profiling.counter("launches.control_records")
    rec, wp = cuda_eval.control_records(m)
    assert profiling.counter("launches.control_records") == before == 0   # the CPU runs the twin
    assert rec.shape == (300, 1 + n_layers, 4) and rec.dtype == torch.float32
    assert rec.is_contiguous()
    ctrl, got_ie, got_w = _read_records(rec)
    assert torch.equal(ctrl, m.ctrl) and torch.equal(got_ie, ie) and torch.equal(got_w, m.w_rbf)
    assert torch.equal(wp[:tail_rows], m.w_poly) and not wp[tail_rows:].any()


@pytest.mark.parametrize("n_layers", [1, 3, 6])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.WENDLAND_C2], ids=["GAUSSIAN", "WENDLAND_C2"])
def test_culled_tables_padded(kernel, n_layers):
    """The culled records are the sorted, padded controls of culled_slabs
    (padded rows: the last control, zero weight, 1/eps^2 = 1), and the
    slab table is culled_slabs' bit for bit."""
    m = _model(300, n_layers, kernel)        # 300 = 2 slabs + 44: padded
    ctrl, w_rbf, inv_eps2, bbox = cuda_eval.culled_slabs(m, kernel)
    rec, bbox2, sub, wp = cuda_eval.culled_tables(m, kernel)
    assert profiling.counter("launches.culled_tables") == 0
    assert torch.equal(wp, cuda_eval._w_poly4(m))
    assert rec.shape == (384, 1 + n_layers, 4)
    assert torch.equal(bbox2, bbox) and sub.shape == (12, 8)
    got_ctrl, got_ie, got_w = _read_records(rec)
    assert torch.equal(got_ctrl, ctrl) and torch.equal(got_ie, inv_eps2)
    assert torch.equal(got_w, w_rbf)
    assert not got_w[:, 300:].any() and (got_ie[:, 300:] == 1.0).all()
    assert (got_ctrl[300:] == ctrl[299]).all()


@pytest.mark.parametrize("n", [300, 1000, 4096])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.WENDLAND_C2], ids=["GAUSSIAN", "WENDLAND_C2"])
def test_sub_slab_boxes_hold_their_controls(kernel, n):
    m = _model(n, 3, kernel)
    rec, bbox, sub, _ = cuda_eval.culled_tables(m, kernel)
    ctrl = rec[:, 0, :3].reshape(-1, 32, 3)
    assert torch.equal(sub[:, :3], ctrl.amin(1)) and torch.equal(sub[:, 3:6], ctrl.amax(1))
    assert (sub[:, 7] == 0).all()
    # each sub-slab's cutoff^2 covers its own controls' radii, and each
    # slab's box and cutoff cover its four sub-slabs'
    ie = torch.cat([rec[:, :1, 3], rec[:, 1:-1, 3]], 1)          # (NP, L)
    need = (cuda_eval._CULL_S_CUTOFF[kernel] / ie).amax(1)
    need[n:] = 0.0                                               # padding: zero weight
    need = need.reshape(-1, 32).amax(1)
    assert (sub[:, 6] >= need * (1 - 1e-6)).all()
    per_slab = sub.reshape(-1, 4, 8)
    assert (per_slab[:, :, :3].amin(1) == bbox[:, :3]).all()
    assert (per_slab[:, :, 3:6].amax(1) == bbox[:, 3:6]).all()
    assert (per_slab[:, :, 6].amax(1) == bbox[:, 6]).all()


def _gap_ok(lo, hi, row):
    """The kernels' test: squared gap between a box and a table row within
    the row's cutoff^2 (rows broadcast)."""
    g = np.maximum(np.maximum(row[..., 0:3] - hi, lo - row[..., 3:6]), 0.0)
    return (g * g).sum(-1) <= row[..., 6]


def _two_level(pts, active, bbox, sub, block_v, warp_v):
    """Mirror of culled_kernel's skip: per warp (warp_v consecutive vertices)
    the box of its active vertices, per block (block_v) the union of its
    warps' boxes; (warps, sub-slabs) that compute = the block reaches the
    slab and the warp reaches the sub-slab."""
    nw = -(-pts.shape[0] // warp_v)
    lo = np.full((nw * warp_v, 3), np.inf, np.float32)
    hi = np.full((nw * warp_v, 3), -np.inf, np.float32)
    lo[: pts.shape[0]][active] = pts[active]
    hi[: pts.shape[0]][active] = pts[active]
    wlo, whi = lo.reshape(nw, warp_v, 3).min(1), hi.reshape(nw, warp_v, 3).max(1)
    per = block_v // warp_v
    blk = np.arange(nw) // per
    blo = np.stack([wlo[blk == b].min(0) for b in range(blk[-1] + 1)])
    bhi = np.stack([whi[blk == b].max(0) for b in range(blk[-1] + 1)])
    slab_ok = _gap_ok(blo[:, None], bhi[:, None], bbox[None])             # (blocks, NB)
    sub_ok = _gap_ok(wlo[:, None], whi[:, None], sub[None])               # (warps, 4 NB)
    return sub_ok & np.repeat(slab_ok, 4, axis=1)[blk]


def _block_rule(pts, bbox, block_v):
    """A block-only rule: blocks of block_v vertices against 128-slabs (at
    128 vertices, the JAX package's culled kernel)."""
    nb = -(-pts.shape[0] // block_v)
    pad = nb * block_v - pts.shape[0]
    lo = np.concatenate([pts, np.full((pad, 3), np.inf, np.float32)]).reshape(nb, block_v, 3)
    hi = np.concatenate([pts, np.full((pad, 3), -np.inf, np.float32)]).reshape(nb, block_v, 3)
    return _gap_ok(lo.min(1)[:, None], hi.max(1)[:, None], bbox[None])


def _point_sets():
    uv = uv_sphere(40, 57).points * 1.02                     # 2282 points, ragged
    fib = torch.as_tensor(fibonacci_points(3001) * 0.98)
    fib = fib[spatial_order(fib)[0]].numpy()                  # Morton-sorted
    return {"uv_ragged": uv.astype(np.float32), "fibonacci_morton": fib.astype(np.float32)}


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "%d-%d" % g)
@pytest.mark.parametrize("points", ["uv_ragged", "fibonacci_morton"])
@pytest.mark.parametrize("n", [1000, 1003])
def test_two_level_skip_keeps_needed_pairs(n, points, geometry):
    """Every pair within its control's cutoff is computed by the two-level
    rule, which computes fewer pairs than the JAX package's block-only rule
    (128-vertex blocks) and than blocks of the same size alone."""
    block_v, warp_v = geometry
    kernel = K.GAUSSIAN
    m = _model(n, 2, kernel, radii=(0.08, 0.13))              # a QNN fit's spacing
    rec, bbox, sub, _ = (t.numpy() for t in cuda_eval.culled_tables(m, kernel))
    pts = _point_sets()[points]
    active = np.ones(pts.shape[0], bool)
    active[::7] = False                                       # a sparse capture gate
    ok = _two_level(pts, active, bbox, sub, block_v, warp_v)
    ctrl = rec[:, 0, :3]
    cut2 = cuda_eval._CULL_S_CUTOFF[kernel] / np.concatenate(
        [rec[:, :1, 3], rec[:, 1:-1, 3]], 1).min(1)
    d2 = ((pts[:, None] - ctrl[None]) ** 2).sum(-1)
    needed = (d2 <= cut2[None]) & active[:, None]
    needed[:, n:] = False                                     # padding: zero weight
    warp = np.arange(pts.shape[0]) // warp_v
    computed = ok[warp][:, np.arange(ctrl.shape[0]) // 32]  # (V, NP)
    assert not (needed & ~computed).any()
    two_level = int(ok.sum()) * warp_v * 32
    jax_rule = int(_block_rule(pts, bbox, 128).sum()) * 128 * 128
    block_alone = int(np.repeat(_block_rule(pts, bbox, block_v), 4, 1).sum()) * block_v * 32
    assert 0 < int(needed.sum()) <= two_level < jax_rule and two_level < block_alone


def _phi(kernel, s):
    return apply_kernel(kernel, s, 1.0)                       # phi of s = d2 / eps^2


def _emulate_pairs(rec, pts, kernel, center, idx=None, acc=None):
    """The kernels' pair loop: controls of rec (N, 1 + L, 4) in order, each
    control's layers in order, phi(d2 * 1/eps^2) times the record weights
    into acc (V, 3); center: the layer-0 mean subtracted (two passes)."""
    n, r, _ = rec.shape
    p = pts if idx is None else pts[idx]
    acc = torch.zeros_like(p) if acc is None else acc
    cen = 0.0
    if center:
        total = torch.zeros(p.shape[0])
        for j in range(n):
            c = rec[j, 0]
            d = c[:3] - p
            total = total + _phi(kernel, (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                                          + d[:, 2] * d[:, 2]) * c[3])
        cen = total / float(n)
    for j in range(n):
        c = rec[j, 0]
        d = c[:3] - p
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        ie = c[3]
        for layer in range(r - 1):
            w = rec[j, 1 + layer]
            ph = _phi(kernel, d2 * ie)
            if center and layer == 0:
                ph = ph - cen
            acc = acc + ph[:, None] * w[None, :3]
            ie = w[3]
    return acc


def _finish(pts, disp, dist2, gate, radius, rate, strict):
    from facedeform_tpu_torch.ops.falloff import falloff_weight

    w, _ = falloff_weight(dist2, radius, rate, strict_parity=strict)
    w = w * gate
    return pts + disp * w[:, None], w


def _inputs(v=700, seed=1):
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(uv_sphere(20, 34).points[:v] * 1.03)
    dist2 = ((pts - torch.tensor([0.0, 1.03, 0.0])) ** 2).sum(-1)
    dist2[::31] = -1.0
    gate = torch.as_tensor((rng.uniform(size=pts.shape[0]) > 0.2).astype(np.float32))
    return pts, dist2, gate


def _tail(m, pts):
    wp = cuda_eval._w_poly4(m)
    return wp[0] + wp[1] * pts[:, :1] + wp[2] * pts[:, 1:2] + wp[3] * pts[:, 2:3]


@pytest.mark.parametrize("n_layers", [1, 3, 6])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.THIN_PLATE, K.WENDLAND_C2],
                         ids=["GAUSSIAN", "THIN_PLATE", "WENDLAND_C2"])
def test_emulated_dense_matches_twin(kernel, n_layers):
    """dense_kernel's arithmetic over control_records (centering for the
    growing thin plate) against the plain twin, at N = 203 (not a multiple
    of the pair loop's unroll)."""
    m = _model(203, n_layers, kernel)
    pts, dist2, gate = _inputs()
    rec, _ = cuda_eval.control_records(m)
    center = _center_phi(kernel, PolyTerm.LINEAR)
    assert center == (kernel in GROWING_KERNELS)
    disp = _emulate_pairs(rec, pts, kernel, center) + _tail(m, pts)
    got_p, got_w = _finish(pts, disp, dist2, gate, 0.9, 1.5, True)
    want_p, want_w = cuda_eval.evaluate_reference(m, pts, dist2, gate, 0.9, 1.5, kernel,
                                                  PolyTerm.LINEAR, strict_parity=True)
    tol = POS_TOL_GROWING if kernel in GROWING_KERNELS else POS_TOL_DECAYING
    assert float((got_p - want_p).abs().max()) <= tol
    assert float((got_w - want_w).abs().max()) <= FALLOFF_TOL


@pytest.mark.parametrize("n_layers", [1, 3, 6])
@pytest.mark.parametrize("kernel", [K.GAUSSIAN, K.WENDLAND_C2], ids=["GAUSSIAN", "WENDLAND_C2"])
def test_emulated_culled_matches_twin(kernel, n_layers):
    """culled_kernel's arithmetic: the tail first, then per warp only the
    32-control sub-slabs the two-level rule keeps, over culled_tables'
    records, against the plain twin."""
    m = _model(300, n_layers, kernel)
    pts, dist2, gate = _inputs()
    rec, bbox, sub, _ = cuda_eval.culled_tables(m, kernel)
    radius = 0.9
    active = ((torch.clamp(dist2, min=0.0) <= radius * radius) & (gate > 0)).numpy()
    block_v, wv = GEOMETRIES[0]
    ok = _two_level(pts.numpy(), active, bbox.numpy(), sub.numpy(), block_v, wv)
    disp = _tail(m, pts)
    for w in range(ok.shape[0]):
        idx = torch.arange(w * wv, min((w + 1) * wv, pts.shape[0]))
        acc = disp[idx]
        for q in np.flatnonzero(ok[w]):
            acc = _emulate_pairs(rec[32 * q: 32 * q + 32], pts, kernel, False, idx, acc)
        disp[idx] = acc
    assert ok.any() and not ok.all()                          # the rule skips some
    got_p, got_w = _finish(pts, disp, dist2, gate, radius, 1.5, False)
    want_p, want_w = cuda_eval.evaluate_reference(m, pts, dist2, gate, radius, 1.5, kernel,
                                                  PolyTerm.LINEAR)
    assert float((got_p - want_p).abs().max()) <= POS_TOL_DECAYING
    assert float((got_w - want_w).abs().max()) <= FALLOFF_TOL


def test_c_abi_matches_the_sources():
    """Every extern "C" entry point of csrc/*.cu has the argument list
    cuda_eval.ABI declares to ctypes (p pointer, i int, f float)."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', path.read_text()):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                kinds.append("p" if "*" in arg else "f" if arg.startswith("float ") else "i")
                assert "*" in arg or arg.split()[0] in ("int", "float"), arg
            found[name] = "".join(kinds)
    assert found == cuda_eval.ABI
