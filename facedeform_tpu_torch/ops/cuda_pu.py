"""Partition-of-unity tile eval on the GPU: the host tile plan, the wrapper
of the hand-written CUDA kernel in csrc/pu.cu and its plain PyTorch twin.

Counterpart of facedeform_tpu/ops/pallas_pu.py:
  PUTilePlan, plan_eval_tiles    <- the same (numpy, copied), plus the
                                    per-tile item offsets the kernel reads
  evaluate_pu_tiles              <- evaluate_pu_tiles
  evaluate_pu_tiles_frames       <- evaluate_pu_tiles_frames (_pu_accum_kernel)
  evaluate_pu_tiles_reference    <- the kernel's function, plain

The plan lists (vertex tile, patch) items sorted by vertex tile over the
Z-ordered query points.  The kernel runs one block per vertex tile, walks
that tile's items and accumulates sum_k W_k s_k and sum_k W_k in
registers, then normalizes and writes each point back to the caller's
order; it contracts phi with the weight columns of several frames on the
tensor cores (3xTF32, ops/tf32.py), so the wrapper hands it the weights
pre-split into fragments, with the centered controls, per k-step of 8
controls (_pack_launch); one pose it contracts on the CUDA cores, so a
frame of a shot equals its one-pose launch within the kernel's tolerance,
not bit for bit (frames of any two shot launches are bit-equal).  The
wrapper runs the plain twin only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises.  Each entry counts its own launches,
in the counters launches.evaluate_pu_tiles and
launches.evaluate_pu_tiles_frames (utils/profiling.py).  The kernel is built with the others by
ops.cuda_eval.build().
"""

from __future__ import annotations

import numpy as np
import torch

from facedeform_tpu_torch.config import RBFKernel
from facedeform_tpu_torch.ops import cuda_eval, tf32
from facedeform_tpu_torch.ops.kernels import apply_kernel
from facedeform_tpu_torch.ops.pu import _TILES_PER_BLOCK, coverage_and_fallback
from facedeform_tpu_torch.utils import profiling
from facedeform_tpu_torch.utils.precision import highest_precision

for _name in ("evaluate_pu_tiles", "evaluate_pu_tiles_frames"):
    profiling.count(f"launches.{_name}", 0)

# Frames per launch: the kernel keeps 3F columns per point in registers,
# at most 6 n8 tiles of the mma, so longer shots loop over chunks.
FRAMES_PER_LAUNCH = 16
# n8 tiles of weight columns the kernel is instantiated for (NT; one pose
# takes NT = 0, its CUDA-core path).
PU_TILES = (1, 2, 3, 6)
# Threads per block of the kernel: one per point of a vertex tile.
KERNEL_TILE_V = 256


class PUTilePlan:
    """Vertex-tile-major eval plan (host-built; cache alongside the model).

    The items (vertex_tile, patch) are sorted by vertex tile;
    item_offsets[t] .. item_offsets[t + 1] are tile t's items (CSR).  Query
    points are Z-ordered internally (perm) so each vertex tile meets few
    patch balls; forced_patch[i] is the Z-ordered point i's fallback patch
    (-1: none).
    """

    def __init__(self, item_patch, item_vt, forced_patch, perm, inv_perm,
                 num_points, tile_v):
        self.item_patch = item_patch      # (T',) int32
        self.item_vt = item_vt            # (T',) int32, sorted ascending
        self.forced_patch = forced_patch  # (Vp,) int32 (-1 = none)
        self.perm = perm                  # (V,) Z-order permutation
        self.inv_perm = inv_perm
        self.num_points = num_points
        self.tile_v = tile_v
        n_vt = forced_patch.shape[0] // tile_v
        self.item_offsets = np.searchsorted(
            item_vt, np.arange(n_vt + 1), side="left").astype(np.int32)
        self._device: dict = {}

    def device_arrays(self, device="cuda") -> tuple:
        """(item_patch, item_vt, forced_patch, perm, inv_perm, item_offsets)
        as int32 tensors on `device`, copied once per device."""
        key = str(torch.device(device))
        if key not in self._device:
            self._device[key] = tuple(
                torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)
                for a in (self.item_patch, self.item_vt, self.forced_patch,
                          self.perm, self.inv_perm, self.item_offsets)
            )
        return self._device[key]


def plan_eval_tiles(patches, points, tile_v: int = 256) -> PUTilePlan:
    """Build a PUTilePlan: Z-order the queries, list (vertex tile, patch)
    items, and the per-point nearest-patch fallback assignments."""
    points = np.asarray(points, np.float32)
    v = points.shape[0]
    # host Z-order (cheap mirror of ops.morton on numpy)
    lo, hi = points.min(0), points.max(0)
    scale = 1023.0 / np.maximum(hi - lo, 1e-12)
    q = np.clip((points - lo) * scale, 0, 1023).astype(np.uint32)

    def expand(x):
        x = x.astype(np.uint32)
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    code = expand(q[:, 0]) | (expand(q[:, 1]) << 1) | (expand(q[:, 2]) << 2)
    perm = np.argsort(code, kind="stable").astype(np.int32)
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(v, dtype=np.int32)
    pz = points[perm]

    vp = v + ((-v) % tile_v)
    n_vt = vp // tile_v
    point_vt = np.arange(v) // tile_v                  # in Z order

    vt_sets: list[set] = [set() for _ in range(n_vt)]
    per_patch, covered, (un, pick) = coverage_and_fallback(patches, pz)
    for k, hits in enumerate(per_patch):
        if hits.size:
            for vt in np.unique(point_vt[hits]):
                vt_sets[vt].add(int(k))
    forced_patch = np.full(vp, -1, np.int32)
    forced_patch[un] = pick.astype(np.int32)
    for vi, k in zip(un, pick):
        vt_sets[point_vt[vi]].add(int(k))

    item_vt, item_patch = [], []
    for vt in range(n_vt):
        ks = sorted(vt_sets[vt]) or [0]   # empty tile: one no-op item
        item_vt.extend([vt] * len(ks))
        item_patch.extend(ks)
    return PUTilePlan(
        item_patch=np.asarray(item_patch, np.int32),
        item_vt=np.asarray(item_vt, np.int32),
        forced_patch=forced_patch,
        perm=perm, inv_perm=inv_perm,
        num_points=v, tile_v=tile_v,
    )


def _pack_frames_operands(models):
    """Pack F per-frame PUModels (shared geometry, distinct weights) into
    one operand set: ctrl (K, P, 3), cvalid (K, P), w (K, P, 3F) with frame
    f's weights w_hi + w_lo (f32) in columns 3f..3f+2, poly (K, 4, 3F) the
    tails zero-padded to 4 rows, geom (K, 8) = center xyz, 1/max(eps^2,
    1e-30), 1/max(R^2, 1e-30), 0, 0, 0."""
    base = models[0]
    k_ = base.ctrl.shape[0]
    w = torch.cat([m.w_hi + m.w_lo for m in models], dim=2)
    m_ = base.poly_hi.shape[1]
    poly = base.ctrl.new_zeros((k_, 4, 3 * len(models)))
    if m_:
        poly[:, :m_] = torch.cat([m.poly_hi + m.poly_lo for m in models], dim=2)
    inv_eps2 = 1.0 / torch.clamp(base.eps * base.eps, min=1e-30)
    inv_r2 = 1.0 / torch.clamp(base.radii * base.radii, min=1e-30)
    geom = torch.cat([base.centers.float(), inv_eps2[:, None], inv_r2[:, None],
                      base.ctrl.new_zeros((k_, 3))], dim=1)
    c = lambda a: a.float().contiguous()  # noqa: E731
    return c(base.ctrl), c(base.valid), c(w), c(poly), c(geom)


def launch_tiles(nf: int) -> int:
    """NT of a launch of nf frames: 0 for one pose, else the n8 tiles of
    its 3nf weight columns."""
    return 0 if nf == 1 else tf32.n_tiles(3 * nf, PU_TILES)


def _centered_controls(ctrl, cvalid, geom) -> torch.Tensor:
    """(K, 8T, 4): per control (ctrl - c_k) * valid and valid, the rows
    padded with zeros to whole k-steps of 8 (a padded control's phi is
    finite and multiplied by 0)."""
    k_, p_, _ = ctrl.shape
    lc4 = ctrl.new_zeros((k_, -(-p_ // 8) * 8, 4))
    lc4[:, :p_, :3] = (ctrl - geom[:, None, :3]) * cvalid[..., None]
    lc4[:, :p_, 3] = cvalid
    return lc4


def _pack_launch(lc4, w, poly, f0: int, nf: int):
    """Operands of the launch of frames [f0, f0 + nf): the stream, per
    k-step the 8 centered controls, then for several frames (K, T, 32 +
    128 NT) the weight columns 3 f0 .. 3 (f0 + nf) zero-padded to cp = 8 NT,
    split into tf32 words in mma fragment order, or for one frame (K, T,
    64) its f32 weights (x, y, z, 0) per control (NT = 0: the kernel
    contracts one pose on the CUDA cores); the tails (K, 4, cp), cp = 8 for
    one frame; NT."""
    k_, pp, _ = lc4.shape
    nt = launch_tiles(nf)
    cp = 8 * max(nt, 1)
    cols = slice(3 * f0, 3 * (f0 + nf))
    wc = w.new_zeros((k_, pp, 4 if nf == 1 else cp))
    wc[:, :w.shape[1], :3 * nf] = w[:, :, cols]
    words = wc if nf == 1 else tf32.mma_fragments(wc)           # (K, T, NT, 32, 4)
    stream = torch.cat([lc4.reshape(k_, pp // 8, 32), words.reshape(k_, pp // 8, -1)], dim=2)
    pc = poly.new_zeros((k_, 4, cp))
    pc[:, :, :3 * nf] = poly[:, :, cols]
    return stream.contiguous(), pc, nt


def _phi_s(kernel, s):
    """phi of an already normalized s = d2 / eps^2 (the kernel's form)."""
    return apply_kernel(kernel, s, 1.0)


def _check_plan(points, plan: PUTilePlan):
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (V, 3), got {tuple(points.shape)}")
    if points.shape[0] != plan.num_points:
        raise ValueError(
            f"plan was built for {plan.num_points} points, got {points.shape[0]} "
            "— stale plan? (a mismatched gather reads out of range)"
        )


def evaluate_pu_tiles_reference(models, points, plan: PUTilePlan,
                                kernel: RBFKernel, contract=None) -> torch.Tensor:
    """Plain PyTorch twin of the tile kernel: (F, V, 3).

    Per item (vertex tile, patch k), as the kernel computes it: centered
    points xl = x - c_k and controls lc = (ctrl - c_k) * valid, d2 from
    exact differences (lc - xl)^2, phi(d2 * inv_eps2) * valid contracted
    against the 3F weight columns, the centered linear tail, the partition
    weight (Wendland of |xl|^2 * inv_r2, or 1 where k is the point's forced
    patch, compared as integers; times the lane's valid flag; 0 for dead
    items k < 0); accumulate w * s and w per point, normalize
    where(acc_w > 1e-30, acc_d / acc_w, 0) and un-permute.  The tail's
    terms are implied by the models' poly rows.  contract(phi, w) forms the
    contraction: by default an f32 matmul at full precision;
    tf32.matmul_3xtf32 models the kernel's tensor-core passes."""
    _check_plan(points, plan)
    item_patch, item_vt, forced_patch, perm, inv_perm, _ = plan.device_arrays(points.device)
    tile_v = plan.tile_v
    kernel = RBFKernel(kernel)
    ctrl, cvalid, w_all, poly, geom = _pack_frames_operands(models)
    f_n = len(models)
    c_ = 3 * f_n
    dev = points.device
    v = plan.num_points
    n_vt = forced_patch.shape[0] // tile_v
    vp = n_vt * tile_v
    pz = points.new_zeros((vp, 3))
    pz[:v] = points.float()[perm.long()]
    pz = pz.reshape(n_vt, tile_v, 3)
    lane_valid = (torch.arange(vp, device=dev) < v).float().reshape(n_vt, tile_v)
    forced = forced_patch.long().reshape(n_vt, tile_v)
    acc_d = points.new_zeros((n_vt, tile_v, c_))
    acc_w = points.new_zeros((n_vt, tile_v))
    ip, iv = item_patch.long(), item_vt.long()
    for s in range(0, ip.shape[0], _TILES_PER_BLOCK):
        k, vt = ip[s:s + _TILES_PER_BLOCK], iv[s:s + _TILES_PER_BLOCK]
        kc = torch.clamp(k, min=0)
        c = geom[kc, None, :3]                                  # (B, 1, 3)
        inv_eps2, inv_r2 = geom[kc, 3, None, None], geom[kc, 4, None]
        xl = pz[vt] - c                                         # (B, tv, 3)
        d2c = xl[..., 0] * xl[..., 0] + xl[..., 1] * xl[..., 1] + xl[..., 2] * xl[..., 2]
        bw = _phi_s(RBFKernel.WENDLAND_C2, d2c * inv_r2)
        wgt = torch.where(forced[vt] == k[:, None], torch.ones_like(bw), bw) * lane_valid[vt]
        wgt = torch.where(k[:, None] >= 0, wgt, torch.zeros_like(wgt))
        cv = cvalid[kc]                                         # (B, P)
        lc = (ctrl[kc] - c) * cv[..., None]                     # (B, P, 3)
        d = [lc[:, None, :, a] - xl[:, :, None, a] for a in range(3)]
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]            # (B, tv, P)
        phi = _phi_s(kernel, d2 * inv_eps2) * cv[:, None, :]
        if contract is None:
            with highest_precision():
                disp = phi @ w_all[kc]                          # (B, tv, C)
        else:
            disp = contract(phi, w_all[kc])
        wp = poly[kc]                                           # (B, 4, C)
        disp = (disp + wp[:, None, 0] + wp[:, None, 1] * xl[..., 0:1]
                + wp[:, None, 2] * xl[..., 1:2] + wp[:, None, 3] * xl[..., 2:3])
        acc_d.index_add_(0, vt, disp * wgt[..., None])
        acc_w.index_add_(0, vt, wgt)
    acc_d = acc_d.reshape(vp, c_)[:v]
    acc_w = acc_w.reshape(vp)[:v]
    out_z = torch.where((acc_w > 1e-30)[:, None],
                        acc_d / torch.clamp(acc_w, min=1e-30)[:, None],
                        torch.zeros_like(acc_d))
    return out_z[inv_perm.long()].reshape(v, f_n, 3).transpose(0, 1).contiguous()


def _tiles(models, points, plan: PUTilePlan, kernel: RBFKernel, entry: str) -> torch.Tensor:
    """(F, V, 3) through the plain twin on CPU tensors, else the kernel;
    each launch adds one to the counter launches.<entry>."""
    if points.device.type == "cpu":
        return evaluate_pu_tiles_reference(models, points, plan, kernel)
    if points.device.type != "cuda":
        raise ValueError(f"{entry} takes CPU or CUDA tensors, got {points.device}")
    _check_plan(points, plan)
    tile_v, num_points = plan.tile_v, plan.num_points
    if tile_v != KERNEL_TILE_V:
        raise ValueError(f"the CUDA tile kernel takes tile_v = {KERNEL_TILE_V}, got {tile_v}")
    item_patch, _, forced_patch, perm, _, item_offsets = plan.device_arrays(points.device)
    kernel = RBFKernel(kernel)
    dev = points.device
    ctrl, cvalid, w, poly, geom = _pack_frames_operands(models)
    k_, p_, _ = ctrl.shape
    f_n = len(models)
    n_vt = forced_patch.shape[0] // tile_v
    cuda_eval._need("points", points, (num_points, 3), dev)
    for name, t, shape in (("ctrl", ctrl, (k_, p_, 3)), ("valid", cvalid, (k_, p_)),
                           ("w", w, (k_, p_, 3 * f_n)), ("poly", poly, (k_, 4, 3 * f_n)),
                           ("geom", geom, (k_, 8))):
        cuda_eval._need(f"model.{name}", t, shape, dev)
    out = torch.empty((f_n, num_points, 3), dtype=torch.float32, device=dev)
    if num_points == 0:
        return out
    # controls past the last live one contribute phi * 0: skip them
    n_live = ((cvalid > 0).int() * torch.arange(1, p_ + 1, device=dev, dtype=torch.int32)
              ).amax(1).to(torch.int32).contiguous()
    lc4 = _centered_controls(ctrl, cvalid, geom)
    cuda_eval.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for f0 in range(0, f_n, FRAMES_PER_LAUNCH):
            nf = min(FRAMES_PER_LAUNCH, f_n - f0)
            stream_t, poly_c, nt = _pack_launch(lc4, w, poly, f0, nf)
            err = cuda_eval._lib.fd_pu_tiles(
                points.data_ptr(), perm.data_ptr(), forced_patch.data_ptr(),
                item_patch.data_ptr(), item_offsets.data_ptr(), stream_t.data_ptr(),
                n_live.data_ptr(), poly_c.data_ptr(), geom.data_ptr(), out.data_ptr(),
                num_points, n_vt, k_, lc4.shape[1] // 8, f_n, f0, nf, nt, int(kernel), stream,
            )
            if err != 0:
                raise RuntimeError(f"fd_pu_tiles launch failed: CUDA error {err}")
            profiling.count(f"launches.{entry}")
    return out


def evaluate_pu_tiles_frames(models, points, plan: PUTilePlan,
                             kernel: RBFKernel) -> torch.Tensor:
    """(F, V, 3) PU displacement of F frames through one tile plan: phi and
    the partition weights once per (tile, patch) item, contracted against
    all 3F weight columns, up to FRAMES_PER_LAUNCH frames a launch.
    `models` share geometry (fit_pu_frames output); `plan` was built by
    plan_eval_tiles for these points."""
    return _tiles(models, points, plan, kernel, "evaluate_pu_tiles_frames")


@profiling.traced("pu.tiles")
def evaluate_pu_tiles(model, points, plan: PUTilePlan, kernel: RBFKernel) -> torch.Tensor:
    """Scatter-free PU displacement (V, 3) in the caller's point order: the
    F = 1 case of evaluate_pu_tiles_frames (one launch on the card); a
    span, pu.tiles."""
    return _tiles((model,), points, plan, kernel, "evaluate_pu_tiles")[0]
