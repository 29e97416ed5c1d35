"""Fused per-vertex RBF eval on the GPU: wrappers of the hand-written CUDA
kernels in csrc/eval.cu and csrc/frames.cu, their plain PyTorch twins, and
the culled kernel's control-slab preparation.

Counterpart of facedeform_tpu/ops/pallas_eval.py:
  evaluate_cuda              <- evaluate_pallas         (_eval_kernel)
  evaluate_cuda_culled       <- evaluate_pallas_culled  (_eval_kernel_culled)
  evaluate_cuda_frames       <- evaluate_pallas_frames  (_eval_frames_kernel)
  evaluate_cuda_diff         <- evaluate_pallas_diff    (custom VJP over #1)
  evaluate_reference         <- _dense_reference
  evaluate_frames_reference  <- per-frame evaluate_reference

A wrapper runs the plain version only for tensors on the CPU.  For CUDA
tensors it launches its kernel or raises; it never falls back.  Each
wrapper counts its launches in the counter launches.<wrapper>
(utils/profiling.py).  The dense and
culled kernels read the controls as packed records, built once per call on
the card (control_records, culled_tables; their plain twins
control_records_reference, culled_tables_reference); the culled kernel
also reads a bbox table per 128-control slab and per 32-control sub-slab.
The frames kernel contracts phi with the weights on the tensor cores
(3xTF32, ops/tf32.py), up to FRAMES_PER_LAUNCH frames a launch in balanced
chunks (frames_launch_plan); each launch reads a stream of control records
and pre-split weight fragments built on the card by one launch
(frames_stream; plain twin frames_stream_reference).

The kernels (these, csrc/jacobian.cu's in ops/cuda_jacobian.py,
csrc/precise.cu's in ops/cuda_precise.py, csrc/pu.cu's in
ops/cuda_pu.py and csrc/lu_solve.cu's in ops/cuda_solve.py) are compiled with nvcc for
sm_90a at first use, from the sources in csrc/ alone, one nvcc per source
started together, then linked into one library in csrc/build/ under a
name keyed by a hash of the sources and flags (a stale library is never
loaded).  Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

from facedeform_tpu_torch.config import PolyTerm, RBFKernel
from facedeform_tpu_torch.ops import tf32
from facedeform_tpu_torch.ops.evaluate import _center_phi, evaluate
from facedeform_tpu_torch.ops.falloff import falloff_weight
from facedeform_tpu_torch.ops.fit import RBFModel
from facedeform_tpu_torch.ops.morton import morton_codes
from facedeform_tpu_torch.ops.tangent import project_to_tangents
from facedeform_tpu_torch.utils import profiling

for _name in ("control_records", "evaluate_cuda", "evaluate_cuda_diff", "culled_tables",
              "evaluate_cuda_culled", "frames_stream", "evaluate_cuda_frames"):
    profiling.count(f"launches.{_name}", 0)
# launches of the dense and culled kernels (#1, #2) that project onto a
# tangent frame
profiling.count("eval.frame_launches", 0)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Control-slab size of the culled kernel and its sub-slab, the unit of a
# warp's skip (kCullSlab, kCullSub in csrc/eval.cu; build() checks them
# against the library's cull_geometry).
_CULL_BLOCK = 128
_CULL_SUB = 32

# phi(s) <= 1e-12 beyond these squared-normalized-distance cutoffs.
_CULL_S_CUTOFF = {
    RBFKernel.GAUSSIAN: 27.7,      # exp(-s) = 1e-12
    RBFKernel.WENDLAND_C2: 1.0,    # compact support (exact)
}

# The C entry points of csrc/*.cu, one letter an argument: p a pointer (or
# the stream), i an int, f a float; each returns a cudaError_t as int.
ABI = {
    "fd_eval_dense": "p" * 10 + "i" * 6 + "ffp",
    "fd_eval_culled": "p" * 13 + "i" * 5 + "ffp",
    "fd_cull_geometry": "p",
    "fd_pack_records": "p" * 6 + "iiip",
    "fd_morton": "ppip",
    "fd_cull_pack": "p" * 9 + "i" * 4 + "fp",
    "fd_eval_frames": "p" * 10 + "i" * 11 + "ffp",
    "fd_frames_pack": "p" * 6 + "i" * 7 + "p",
    "fd_frames_geometry": "pi",
    "fd_jacobian": "p" * 3 + "i" * 8 + "p",
    "fd_eval_precise": "p" * 13 + "i" * 8 + "ffp",
    "fd_log_probe": "p" * 3 + "ip",
    "fd_pu_tiles": "p" * 10 + "i" * 9 + "p",
    "fd_lu_solve": "p" * 6 + "i" * 4 + "p",
}

_lib = None


def kernel_is_cullable(kernel: RBFKernel) -> bool:
    """True when phi decays fast enough for slab culling to be exact to
    <= 1e-12 (gaussian) or exactly (compact support)."""
    return RBFKernel(kernel) in _CULL_S_CUTOFF


def build() -> str:
    """Compile csrc/*.cu unless the hash-keyed library exists, and load it.

    Each source compiles in its own nvcc process, all started together,
    then one nvcc links the objects.  Returns nvcc's output (register and
    spill counts from ptxas), or "" when the library was already built or
    loaded.  Raises RuntimeError when the CUDA toolkit is missing or nvcc
    fails.
    """
    global _lib
    if _lib is not None:
        return ""
    from torch.utils.cpp_extension import CUDA_HOME

    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for path in sources + sorted(_CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    digest.update(" ".join(_NVCC_FLAGS).encode())
    build_dir = _CSRC / "build"
    so = build_dir / f"libfd_eval_{digest.hexdigest()[:16]}.so"
    log = ""
    if not so.exists():
        if CUDA_HOME is None:
            raise RuntimeError("the CUDA toolkit (nvcc) was not found; set CUDA_HOME")
        build_dir.mkdir(exist_ok=True)
        nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc")
        tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
        objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
        logs = [obj.with_suffix(".log") for obj in objs]
        procs = []
        for src, obj, log_path in zip(sources, objs, logs):
            with open(log_path, "w") as out:
                procs.append(subprocess.Popen(
                    [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=out, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait()
        log = "".join(path.read_text() for path in logs)
        failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        if not failed:
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed = ["link"]
        for path in objs + logs:
            path.unlink(missing_ok=True)
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    lib = ctypes.CDLL(str(so))
    kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
    for name, sig in ABI.items():
        fn = getattr(lib, name)
        fn.argtypes = [kinds[k] for k in sig]
        fn.restype = ctypes.c_int
    _lib = lib
    geom = cull_geometry()
    if (geom["slab"], geom["sub"]) != (_CULL_BLOCK, _CULL_SUB):
        _lib = None
        raise RuntimeError(f"csrc/eval.cu culls by {geom}, this module by "
                           f"{_CULL_BLOCK}-control slabs of {_CULL_SUB}-control sub-slabs")
    for n_layers in (1, 2, 4):
        geom = frames_geometry(n_layers)
        want = {"max_frames": FRAMES_PER_LAUNCH, "tiles": FRAMES_TILES,
                "step_floats": tuple(frames_step_floats(nt, n_layers) for nt in FRAMES_TILES)}
        if geom != want:
            _lib = None
            raise RuntimeError(f"csrc/frames.cu launches {geom} at L = {n_layers}, "
                               f"this module plans {want}")
    return log


def cull_geometry() -> dict:
    """The built culled kernel's geometry: vertices a block and a warp
    (block_verts, warp_verts), controls a slab and a sub-slab (slab,
    sub).  Builds the library if needed."""
    build()
    geom = (ctypes.c_int * 4)()
    _lib.fd_cull_geometry(ctypes.addressof(geom))
    return dict(zip(("block_verts", "warp_verts", "slab", "sub"), geom))


def frames_geometry(n_layers: int = 1) -> dict:
    """The built frames kernel's launch geometry: frames a launch at most
    (max_frames), the n8 tile counts it is instantiated for (tiles) and the
    floats of a staged k-step at each for n_layers layers (step_floats).
    Builds the library if needed."""
    build()
    geom = (ctypes.c_int * 34)()
    _lib.fd_frames_geometry(ctypes.addressof(geom), n_layers)
    k = geom[1]
    return {"max_frames": geom[0], "tiles": tuple(geom[2:2 + k]),
            "step_floats": tuple(geom[2 + k:2 + 2 * k])}


def evaluate_reference(
    model, points, dist2, gate, radius, falloffrate, kernel, term,
    strict_parity=False, frame=None,
):
    """Plain PyTorch twin of both kernels: (new_points (V, 3), falloff (V,))."""
    disp = evaluate(model, points, kernel, term)
    if frame is not None:
        disp = project_to_tangents(*frame, disp)
    w, _ = falloff_weight(dist2, radius, falloffrate, strict_parity=strict_parity)
    w = w * gate
    return points + disp * w[:, None], w


def _need(name, t, shape, dev):
    """Raise unless t is a contiguous float32 tensor of `shape` on `dev`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, points on {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(model, points, dist2, gate, frame, frames=False):
    """Raise on anything the kernels do not take.  frames=True expects the
    frames-stacked model: w_rbf (F, L, N, 3), w_poly (F, m, 3)."""
    dev = points.device
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be (V, 3), got {tuple(points.shape)}")
    v = points.shape[0]
    n = model.ctrl.shape[0]
    lead = tuple(model.w_rbf.shape[:1]) if frames else ()
    if model.w_rbf.ndim != len(lead) + 3:
        raise ValueError(f"model.w_rbf has shape {tuple(model.w_rbf.shape)}")
    n_layers = model.w_rbf.shape[len(lead)]
    _need("points", points, (v, 3), dev)
    _need("dist2", dist2, (v,), dev)
    _need("gate", gate, (v,), dev)
    _need("model.ctrl", model.ctrl, (n, 3), dev)
    _need("model.w_rbf", model.w_rbf, lead + (n_layers, n, 3), dev)
    _need("model.eps", model.eps, (n_layers, n), dev)
    m = model.w_poly.shape[-2] if model.w_poly.ndim == len(lead) + 2 else -1
    if not 0 <= m <= 4:
        raise ValueError(f"model.w_poly has shape {tuple(model.w_poly.shape)}: "
                         "at most 4 rows (linear tail)")
    _need("model.w_poly", model.w_poly, lead + (m, 3), dev)
    if frame is not None:
        if len(frame) != 3:
            raise ValueError("frame must be a (u, v, n) triple")
        for name, f in zip("uvn", frame):
            _need(f"frame.{name}", f, (v, 3), dev)
    if n == 0 or n_layers == 0 or (frames and model.w_rbf.shape[0] == 0):
        raise ValueError("the model has no controls or no frames")


def _w_poly4(model) -> torch.Tensor:
    """The tail zero-padded to (4, 3): absent rows contribute nothing."""
    w = torch.zeros((4, 3), dtype=torch.float32, device=model.ctrl.device)
    w[: model.w_poly.shape[0]] = model.w_poly
    return w


def _inv_eps2(eps: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.clamp(eps * eps, min=1e-30)


def _r2(radius) -> float:
    """radius^2 rounded as the f32 product the plain version forms."""
    r = torch.tensor(float(radius), dtype=torch.float32)
    return float(r * r)


def _frame_ptrs(frame):
    return [None] * 3 if frame is None else [f.data_ptr() for f in frame]


def pack_records(ctrl: torch.Tensor, w_rbf: torch.Tensor, inv_eps2: torch.Tensor) -> torch.Tensor:
    """(N, 3) controls, (L, N, 3) weights and (L, N) 1/eps^2 -> the
    (N, 1 + L, 4) control records the dense and culled kernels stage:
    (x, y, z, 1/eps_0^2), then per layer l (w_l.xyz, 1/eps_{l+1}^2), the
    last layer's fourth word 0.  A pair then reads two 16-byte records a
    layer."""
    n_layers, n = inv_eps2.shape
    rec = torch.empty((n, 1 + n_layers, 4), dtype=torch.float32, device=ctrl.device)
    rec[:, 0, :3] = ctrl
    rec[:, 0, 3] = inv_eps2[0]
    rec[:, 1:, :3] = w_rbf.transpose(0, 1)
    rec[:, 1:, 3] = torch.nn.functional.pad(inv_eps2[1:], (0, 0, 0, 1)).T
    return rec


def control_records_reference(model):
    """Plain twin of control_records: (records (N, 1 + L, 4), w_poly (4, 3))."""
    return pack_records(model.ctrl, model.w_rbf, _inv_eps2(model.eps)), _w_poly4(model)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def control_records(model):
    """The dense kernel's control inputs, (records (N, 1 + L, 4), w_poly
    (4, 3)) as pack_records lays them out and _w_poly4 pads the tail: on
    CUDA one launch of csrc/eval.cu's pack_kernel, on the CPU the plain
    twin.  The model's tensors must pass _check_inputs."""
    if model.ctrl.device.type == "cpu":
        return control_records_reference(model)
    build()
    n_layers, n = model.eps.shape
    dev = model.ctrl.device
    buf = torch.empty(n * (1 + n_layers) * 4 + 12, dtype=torch.float32, device=dev)
    rec, wp = buf[:-12].view(n, 1 + n_layers, 4), buf[-12:].view(4, 3)
    with torch.cuda.device(dev):
        _raise_on(_lib.fd_pack_records(
            model.ctrl.data_ptr(), model.w_rbf.data_ptr(), model.eps.data_ptr(),
            model.w_poly.data_ptr(), rec.data_ptr(), wp.data_ptr(), model.w_poly.shape[0],
            n, n_layers, _stream(dev)), "fd_pack_records")
    profiling.count("launches.control_records")
    return rec, wp


def evaluate_cuda(
    model, points, dist2, gate, radius, falloffrate,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False, frame=None,
):
    """Fused deform step: (new_points (V, 3), falloff (V,)).

    Same arguments and returns as pallas_eval.evaluate_pallas minus
    tile_v/interpret.  frame=(u, v, n) of (V, 3) tangent attributes fuses
    the tangent projection (applied to the raw displacement, before
    falloff).  Every tensor must be float32, contiguous and on the points'
    device."""
    if points.device.type == "cpu":
        return evaluate_reference(model, points, dist2, gate, radius, falloffrate,
                                  kernel, term, strict_parity, frame)
    if points.device.type != "cuda":
        raise ValueError(f"evaluate_cuda takes CPU or CUDA tensors, got {points.device}")
    _check_inputs(model, points, dist2, gate, frame)
    kernel = RBFKernel(kernel)
    v, n = points.shape[0], model.ctrl.shape[0]
    out = torch.empty_like(points)
    falloff = torch.empty_like(dist2)
    if v == 0:
        return out, falloff
    rec, w_poly = control_records(model)
    with torch.cuda.device(points.device):
        _raise_on(_lib.fd_eval_dense(
            points.data_ptr(), dist2.data_ptr(), gate.data_ptr(), rec.data_ptr(),
            w_poly.data_ptr(), *_frame_ptrs(frame), out.data_ptr(),
            falloff.data_ptr(), v, n, model.w_rbf.shape[0], int(kernel),
            int(strict_parity), int(_center_phi(kernel, term)),
            _r2(radius), float(falloffrate), _stream(points.device)), "fd_eval_dense")
    profiling.count("launches.evaluate_cuda")
    if frame is not None:
        profiling.count("eval.frame_launches")
    return out, falloff


class _EvalDiff(torch.autograd.Function):
    """evaluate_cuda forward, autograd of evaluate_reference backward.

    Inputs after the static (kernel, term, strict_parity) triple: ctrl,
    w_rbf, w_poly, eps, points, dist2, gate, radius, falloffrate, u, v, n;
    radius/falloffrate may be Python numbers and u/v/n None."""

    @staticmethod
    def forward(ctx, static, *inputs):
        kernel, term, strict_parity = static
        ctrl, w_rbf, w_poly, eps, points, dist2, gate, radius, rate, u, v, n = inputs
        frame = None if u is None else (u, v, n)
        out = evaluate_cuda(RBFModel(ctrl, w_rbf, w_poly, eps), points, dist2, gate,
                            radius, rate, kernel, term, strict_parity, frame)
        if points.device.type == "cuda":
            profiling.count("launches.evaluate_cuda_diff")
        ctx.static = static
        ctx.numbers = [None if isinstance(t, torch.Tensor) else t for t in inputs]
        ctx.save_for_backward(*(t if isinstance(t, torch.Tensor) else None for t in inputs))
        return out

    @staticmethod
    def backward(ctx, g_out, g_w):
        kernel, term, strict_parity = ctx.static
        inputs = [t if num is None else num for t, num in zip(ctx.saved_tensors, ctx.numbers)]
        want = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need) if isinstance(t, torch.Tensor) else t
                      for t, need in zip(inputs, want)]
            ctrl, w_rbf, w_poly, eps, points, dist2, gate, radius, rate, u, v, n = leaves
            out = evaluate_reference(
                RBFModel(ctrl, w_rbf, w_poly, eps), points, dist2, gate, radius, rate,
                kernel, term, strict_parity, None if u is None else (u, v, n))
            diff = [t for t, need in zip(leaves, want) if need]
            # the falloff depends on none of the model or the points
            pairs = [(o, g) for o, g in zip(out, (g_out, g_w)) if o.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in pairs], diff,
                                             [g for _, g in pairs], allow_unused=True))
        return (None, *(next(grads) if need else None for need in want))


def evaluate_cuda_diff(
    model, points, dist2, gate, radius, falloffrate, frame,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False,
):
    """evaluate_cuda with gradients: the dense kernel forward, a backward
    through the plain twin's autograd on the saved inputs (the JAX
    package's evaluate_pallas_diff, same argument order).

    Differentiable with respect to the model's ctrl, w_rbf, w_poly and
    eps, points, dist2, gate, radius, falloffrate (tensors) and the
    frame's (u, v, n); kernel, term and strict_parity are static.  The lo
    words play no part, as in the f32 kernel."""
    u, v, n = (None, None, None) if frame is None else frame
    return _EvalDiff.apply(
        (RBFKernel(kernel), PolyTerm(term), bool(strict_parity)),
        model.ctrl, model.w_rbf, model.w_poly, model.eps, points, dist2, gate,
        radius, falloffrate, u, v, n)


def _sorted_controls(model):
    """Controls Morton-sorted and padded to whole 128-row slabs, as the JAX
    package sorts them: (ctrl (NP, 3), w_rbf (L, NP, 3), inv_eps2 (L, NP),
    eps (L, NP)).  Padding rows repeat the last control (tight bboxes) with
    zero weight, 1/eps^2 = 1 and eps = 1e-6."""
    n = model.ctrl.shape[0]
    order = torch.argsort(morton_codes(model.ctrl), stable=True)
    ctrl = model.ctrl[order]
    w_rbf = model.w_rbf[:, order]
    inv_eps2 = _inv_eps2(model.eps)[:, order]
    eps = model.eps[:, order]
    n_pad = (-n) % _CULL_BLOCK
    if n_pad:
        ctrl = torch.cat([ctrl, ctrl[-1:].expand(n_pad, 3)])
        w_rbf = torch.nn.functional.pad(w_rbf, (0, 0, 0, n_pad))
        inv_eps2 = torch.nn.functional.pad(inv_eps2, (0, n_pad), value=1.0)
        eps = torch.nn.functional.pad(eps, (0, n_pad), value=1e-6)
    return ctrl, w_rbf, inv_eps2, eps


def _slab_boxes(ctrl, eps, size: int, kernel: RBFKernel) -> torch.Tensor:
    """(NP / size, 8) per slab of `size` sorted controls: lo.xyz, hi.xyz,
    cutoff^2, 0; the cutoff^2 is max eps^2 over the slab and layers times
    the kernel's s cutoff."""
    n_layers = eps.shape[0]
    nb = ctrl.shape[0] // size
    slab = ctrl.reshape(nb, size, 3)
    eps_slab = torch.amax(eps.reshape(n_layers, nb, size), dim=(0, 2))
    cutoff2 = (eps_slab * eps_slab) * _CULL_S_CUTOFF[RBFKernel(kernel)]
    return torch.cat([
        slab.amin(dim=1), slab.amax(dim=1), cutoff2[:, None],
        torch.zeros((nb, 1), dtype=ctrl.dtype, device=ctrl.device),
    ], dim=1)


def culled_slabs(model, kernel: RBFKernel):
    """Controls Morton-sorted and padded to whole 128-row slabs, with the
    per-slab bbox table, as pallas_eval builds them: (ctrl (NP, 3), w_rbf
    (L, NP, 3), inv_eps2 (L, NP), bbox (NB, 8) = lo.xyz, hi.xyz,
    cutoff^2, 0).  Padding rows repeat the last control (tight bboxes) with
    zero weight; the cutoff^2 is max eps^2 over the slab and layers times
    the kernel's s cutoff."""
    ctrl, w_rbf, inv_eps2, eps = _sorted_controls(model)
    return (ctrl.contiguous(), w_rbf.contiguous(), inv_eps2.contiguous(),
            _slab_boxes(ctrl, eps, _CULL_BLOCK, kernel))


def culled_tables_reference(model, kernel: RBFKernel):
    """Plain twin of culled_tables: (records (NP, 1 + L, 4) of the sorted,
    padded controls (pack_records), bbox (NB, 8) per 128-control slab,
    equal to culled_slabs', sub (4 NB, 8) per 32-control sub-slab, the same
    columns, w_poly (4, 3))."""
    ctrl, w_rbf, inv_eps2, eps = _sorted_controls(model)
    return (pack_records(ctrl, w_rbf, inv_eps2), _slab_boxes(ctrl, eps, _CULL_BLOCK, kernel),
            _slab_boxes(ctrl, eps, _CULL_SUB, kernel), _w_poly4(model))


def culled_tables(model, kernel: RBFKernel):
    """What the culled kernel reads, built once per call: on CUDA
    csrc/eval.cu's morton_kernel, a stable argsort of its codes and
    cull_pack_kernel (gathers, padding, records and both bbox tables in
    one launch), equal to culled_tables_reference bit for bit; on the CPU
    that twin."""
    if model.ctrl.device.type == "cpu":
        return culled_tables_reference(model, kernel)
    build()
    n_layers, n = model.eps.shape
    nb = -(-n // _CULL_BLOCK)
    n_rec = nb * _CULL_BLOCK * (1 + n_layers) * 4
    dev = model.ctrl.device
    codes = torch.empty(n, dtype=torch.int64, device=dev)
    buf = torch.empty(n_rec + 40 * nb + 12, dtype=torch.float32, device=dev)
    rec = buf[:n_rec].view(nb * _CULL_BLOCK, 1 + n_layers, 4)
    bbox = buf[n_rec:n_rec + 8 * nb].view(nb, 8)
    sub = buf[n_rec + 8 * nb:n_rec + 40 * nb].view(4 * nb, 8)
    wp = buf[n_rec + 40 * nb:].view(4, 3)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        _raise_on(_lib.fd_morton(model.ctrl.data_ptr(), codes.data_ptr(), n, stream),
                  "fd_morton")
        order = torch.argsort(codes, stable=True)
        _raise_on(_lib.fd_cull_pack(
            model.ctrl.data_ptr(), model.w_rbf.data_ptr(), model.eps.data_ptr(),
            model.w_poly.data_ptr(), order.data_ptr(), rec.data_ptr(), bbox.data_ptr(),
            sub.data_ptr(), wp.data_ptr(), model.w_poly.shape[0], n, n_layers, nb,
            _CULL_S_CUTOFF[RBFKernel(kernel)], stream), "fd_cull_pack")
    profiling.count("launches.culled_tables")
    return rec, bbox, sub, wp


def evaluate_cuda_culled(
    model, points, dist2, gate, radius, falloffrate,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False, frame=None,
    pairs=None,
):
    """Culled fused eval for decaying kernels (gaussian, Wendland).

    Matches evaluate_cuda to within the phi <= 1e-12 truncation.  A block
    of consecutive vertices stages only the 128-control slabs its bbox
    reaches within the cutoff, and each warp of it skips the 32-control
    sub-slabs its own active vertices' bbox does not reach (the sizes:
    cull_geometry), so points in a spatially coherent order (mesh order,
    or ops.morton.spatial_order) cull best; any order stays correct.
    pairs: None, or a (1,) int64 tensor on the points' device to which the
    kernel adds the (vertex slot, control) pairs it computes (a
    measurement; the CPU twin leaves it as it is)."""
    if not kernel_is_cullable(kernel):
        raise ValueError(
            f"culled eval needs a decaying kernel, got {RBFKernel(kernel).name}"
        )
    if points.device.type == "cpu":
        return evaluate_reference(model, points, dist2, gate, radius, falloffrate,
                                  kernel, term, strict_parity, frame)
    if points.device.type != "cuda":
        raise ValueError(
            f"evaluate_cuda_culled takes CPU or CUDA tensors, got {points.device}"
        )
    _check_inputs(model, points, dist2, gate, frame)
    v = points.shape[0]
    out = torch.empty_like(points)
    falloff = torch.empty_like(dist2)
    if v == 0:
        return out, falloff
    rec, bbox, sub, w_poly = culled_tables(model, kernel)
    with torch.cuda.device(points.device):
        _raise_on(_lib.fd_eval_culled(
            points.data_ptr(), dist2.data_ptr(), gate.data_ptr(), rec.data_ptr(),
            w_poly.data_ptr(), *_frame_ptrs(frame), bbox.data_ptr(), sub.data_ptr(),
            out.data_ptr(), falloff.data_ptr(), _pairs_ptr(pairs, points.device), v,
            bbox.shape[0],
            model.w_rbf.shape[0], int(RBFKernel(kernel)), int(strict_parity),
            _r2(radius), float(falloffrate), _stream(points.device)), "fd_eval_culled")
    profiling.count("launches.evaluate_cuda_culled")
    if frame is not None:
        profiling.count("eval.frame_launches")
    return out, falloff


def _pairs_ptr(pairs, dev):
    if pairs is None:
        return None
    if pairs.dtype != torch.int64 or tuple(pairs.shape) != (1,) or pairs.device != dev:
        raise ValueError(f"pairs must be a (1,) int64 tensor on {dev}")
    return pairs.data_ptr()


# Frames a launch of the frames kernel (kMaxFrames in csrc/frames.cu; build()
# checks this and FRAMES_TILES against the library's frames_geometry): 3
# weight columns a frame in at most 12 n8 tiles of the mma, whose
# accumulators live in registers (48 a lane).  A longer shot takes the
# fewest launches of balanced size (frames_launch_plan), so no launch
# recomputes every distance and phi for a frame or two.
FRAMES_PER_LAUNCH = 32
# n8 tiles of weight columns the frames kernel is instantiated for (NT,
# FramesTiles in csrc/frames.cu); a launch takes the fewest that hold its
# 3 nf columns.  7 keeps 17 frames (51 columns) at two blocks an SM (8
# tiles: one).
FRAMES_TILES = (1, 2, 3, 4, 6, 7, 8, 12)


def frames_launch_tiles(nf: int) -> int:
    """NT of a launch of nf frames: the n8 tiles its 3 nf columns take."""
    if not 1 <= nf <= FRAMES_PER_LAUNCH:
        raise ValueError(f"a frames launch takes 1 to {FRAMES_PER_LAUNCH} frames, got {nf}")
    return tf32.n_tiles(3 * nf, FRAMES_TILES)


def frames_launch_plan(n_frames: int) -> list:
    """(f0, nf, NT) per launch: the fewest launches of at most
    FRAMES_PER_LAUNCH frames, their sizes differing by at most one, the
    larger first (33 frames: 17 + 16)."""
    k = -(-n_frames // FRAMES_PER_LAUNCH)
    size, extra = divmod(n_frames, k)
    plan, f0 = [], 0
    for i in range(k):
        nf = size + (i < extra)
        plan.append((f0, nf, frames_launch_tiles(nf)))
        f0 += nf
    return plan


def frames_step_floats(nt: int, n_layers: int) -> int:
    """Floats of a staged k-step (step_floats in csrc/frames.cu): 8 control
    records (x, y, z, 1/eps_0^2), 8 (L - 1) 1/eps^2, then per layer NT
    fragment blocks of 32 x 4 floats."""
    return 24 + 8 * n_layers + 128 * nt * n_layers


def frame_model(model, f) -> RBFModel:
    """Frame f of a frames-stacked model, with that frame's lo words when
    the model carries them (ctrl and eps are shared); a slice f keeps the
    frame axis."""
    has_lo = model.w_rbf_lo is not None
    return RBFModel(ctrl=model.ctrl, w_rbf=model.w_rbf[f], w_poly=model.w_poly[f],
                    eps=model.eps, w_rbf_lo=model.w_rbf_lo[f] if has_lo else None,
                    w_poly_lo=model.w_poly_lo[f] if has_lo else None)


def evaluate_frames_reference(
    model, points, dist2, gate, radius, falloffrate, kernel, term,
    strict_parity=False, frame=None,
):
    """Plain PyTorch twin of the frames kernel: per-frame evaluate, tangent
    projection, then points + disp * w.  model.w_rbf (F, L, N, 3),
    model.w_poly (F, m, 3); returns ((F, V, 3) positions, (V,) falloff)."""
    w, _ = falloff_weight(dist2, radius, falloffrate, strict_parity=strict_parity)
    w = w * gate
    outs = []
    for f in range(model.w_rbf.shape[0]):
        disp = evaluate(frame_model(model, f), points, kernel, term)
        if frame is not None:
            disp = project_to_tangents(*frame, disp)
        outs.append(points + disp * w[:, None])
    return torch.stack(outs), w


def pack_frames(w: torch.Tensor) -> torch.Tensor:
    """(F, L, N, 3) weights -> (L, N, 3F), column 3f + k = frame f's
    component k: the frames kernels' column order."""
    f, n_layers, n, _ = w.shape
    return w.permute(1, 2, 0, 3).reshape(n_layers, n, 3 * f).contiguous()


def _frame_columns(model, f0: int, nf: int, rows: int, cols: int) -> torch.Tensor:
    """Frames [f0, f0 + nf)'s weight columns, (L, rows, cols) zero-padded."""
    n_layers, n = model.eps.shape
    w = model.w_rbf.new_zeros((n_layers, rows, cols))
    w[:, :n, :3 * nf] = pack_frames(model.w_rbf[f0:f0 + nf])
    return w


def frames_stream_reference(model, f0: int, nf: int, nt: int):
    """Plain twin of frames_stream: the operands of the launch of frames
    [f0, f0 + nf) of a frames-stacked model in NT n8 tiles, (stream (T,
    frames_step_floats), tails (4, 8 NT)).  Per k-step of 8 controls (T =
    ceil(N / 8)): their records (x, y, z, 1/eps_0^2), the 1/eps^2 of layers
    1 .. L - 1 (padding controls (0, 0, 0) and 1: a finite phi), then per
    layer the weight columns 3 f0 .. 3 (f0 + nf) zero-padded to 8 NT, split
    into tf32 words in mma fragment order (tf32.mma_fragments).  The tails:
    w_poly rows [1, x, y, z] of those columns, zero-padded."""
    n_layers, n = model.eps.shape
    t = -(-n // 8)
    inv_eps2 = _inv_eps2(model.eps)
    rec = model.ctrl.new_zeros((8 * t, 4))
    rec[:n, :3] = model.ctrl
    rec[:, 3] = 1.0
    rec[:n, 3] = inv_eps2[0]
    ies = model.ctrl.new_ones((n_layers - 1, 8 * t))
    ies[:, :n] = inv_eps2[1:]
    frags = tf32.mma_fragments(_frame_columns(model, f0, nf, 8 * t, 8 * nt))
    stream = torch.cat([rec.reshape(t, 32),
                        ies.reshape(n_layers - 1, t, 8).transpose(0, 1).reshape(t, -1),
                        frags.transpose(0, 1).reshape(t, -1)], dim=1).contiguous()
    m = model.w_poly.shape[1]
    tails = model.w_poly.new_zeros((4, 8 * nt))
    tails[:m, :3 * nf] = model.w_poly[f0:f0 + nf].permute(1, 0, 2).reshape(m, 3 * nf)
    return stream, tails


def frames_stream(model, f0: int, nf: int, nt: int):
    """What the frames kernel reads for the launch of frames [f0, f0 + nf)
    in NT tiles, as frames_stream_reference lays it out: on CUDA one launch
    of csrc/frames.cu's frames_pack_kernel (equal bit for bit), on the CPU
    that twin.  The model's tensors must pass _check_inputs(frames=True)."""
    if model.ctrl.device.type == "cpu":
        return frames_stream_reference(model, f0, nf, nt)
    build()
    n_frames, n_layers, n, _ = model.w_rbf.shape
    t = -(-n // 8)
    n_stream = t * frames_step_floats(nt, n_layers)
    dev = model.ctrl.device
    buf = torch.empty(n_stream + 32 * nt, dtype=torch.float32, device=dev)
    stream, tails = buf[:n_stream].view(t, -1), buf[n_stream:].view(4, -1)
    with torch.cuda.device(dev):
        _raise_on(_lib.fd_frames_pack(
            model.ctrl.data_ptr(), model.w_rbf.data_ptr(), model.eps.data_ptr(),
            model.w_poly.data_ptr(), stream.data_ptr(), tails.data_ptr(),
            model.w_poly.shape[1], n, n_layers, n_frames, f0, nf, nt, _stream(dev)),
            "fd_frames_pack")
    profiling.count("launches.frames_stream")
    return stream, tails


def evaluate_cuda_frames(
    model, points, dist2, gate, radius, falloffrate,
    kernel: RBFKernel, term: PolyTerm, strict_parity: bool = False, frame=None,
):
    """All-frames fused deform step: ((F, V, 3) positions, (V,) falloff).

    Same arguments and returns as pallas_eval.evaluate_pallas_frames minus
    tile_v/interpret: model.w_rbf (F, L, N, 3) and model.w_poly (F, m, 3)
    carry a leading frame axis, ctrl and eps are shared.  Distances and phi
    are computed once per (vertex, control) for up to FRAMES_PER_LAUNCH
    frames; longer shots take the fewest launches of balanced size
    (frames_launch_plan), each after one packing launch (frames_stream).
    A frame comes out bit for bit the same whichever launch holds it."""
    if points.device.type == "cpu":
        return evaluate_frames_reference(model, points, dist2, gate, radius, falloffrate,
                                         kernel, term, strict_parity, frame)
    if points.device.type != "cuda":
        raise ValueError(f"evaluate_cuda_frames takes CPU or CUDA tensors, got {points.device}")
    _check_inputs(model, points, dist2, gate, frame, frames=True)
    kernel = RBFKernel(kernel)
    n_frames, n_layers, n, _ = model.w_rbf.shape
    v = points.shape[0]
    out = torch.empty((n_frames, v, 3), dtype=torch.float32, device=points.device)
    falloff = torch.empty_like(dist2)
    if v == 0:
        return out, falloff
    build()
    with torch.cuda.device(points.device):
        stream = _stream(points.device)
        for f0, nf, nt in frames_launch_plan(n_frames):
            operands, tails = frames_stream(model, f0, nf, nt)
            _raise_on(_lib.fd_eval_frames(
                points.data_ptr(), dist2.data_ptr(), gate.data_ptr(), operands.data_ptr(),
                tails.data_ptr(), *_frame_ptrs(frame), out.data_ptr(), falloff.data_ptr(),
                v, n, n_layers, operands.shape[0], n_frames, f0, nf, nt, int(kernel),
                int(strict_parity), int(_center_phi(kernel, term)),
                _r2(radius), float(falloffrate), stream), "fd_eval_frames")
            profiling.count("launches.evaluate_cuda_frames")
    return out, falloff
