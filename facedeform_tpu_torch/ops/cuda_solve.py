"""LU solve against one f32 factorization on the GPU: the wrapper of the
hand-written CUDA kernel in csrc/lu_solve.cu, its plain PyTorch twin, and
the row permutation and diagonal-block inverses the kernel reads.

Replaces no TPU kernel: the JAX package leaves lu_solve to XLA.  The
kernel serves ops/solve.lu_solve for a 2-D f32 factor on the card and at
most K_MAX right-hand-side columns (takes()): the drag refit's GMRES-IR
solves, 3 columns each.  torch.linalg.lu_solve took ~2.0 ms of device time
a solve at n = 4100 there (cuBLAS's two trsm kernels and a per-call pivot
unpack), against ~20 us to read the factor once.  The kernel gathers b by
the permutation lu_perm() computes, applies the diagonal blocks' inverses
block_inverses() computes (both once per factorization, stored beside the
factors by ops/solve.lu_factor_hp), and runs both substitutions in one
launch; csrc/lu_solve.cu says how.

lu_solve_cuda runs the plain twin (lu_solve_reference) only for tensors on
the CPU.  For CUDA tensors it launches the kernel or raises; it never falls
back.  It counts its launches in launches.lu_solve_cuda
(utils/profiling.py).  The kernel is built with the others by
ops.cuda_eval.build() at first use.
"""

from __future__ import annotations

import torch

from facedeform_tpu_torch.utils import profiling

profiling.count("launches.lu_solve_cuda", 0)

# Right-hand-side columns the kernel takes (kLuMaxRhs in csrc/lu_solve.cu).
K_MAX = 4
# Rows of a block of the kernel's chain, the size of block_inverses' blocks
# (kLuBlock in csrc/lu_solve.cu).
LU_SOLVE_BLOCK = 128


def lu_perm(piv: torch.Tensor) -> torch.Tensor:
    """The row permutation of a 2-D factor's LAPACK pivots as int64
    indices on piv's device: (P^T b)[i] = b[perm[i]], where A = P L U
    (torch.lu_unpack's P).  The pivots' swaps applied to an arange on the
    host, O(n): the pivots' read and the result's copy are counted
    crossings (profiling.to_host, to_device)."""
    p = list(range(piv.shape[-1]))
    for i, j in enumerate(profiling.to_host(piv).tolist()):
        p[i], p[j - 1] = p[j - 1], p[i]
    return profiling.to_device(p, piv.device, torch.int64)


def block_inverses(lu: torch.Tensor) -> torch.Tensor:
    """(2, nb, B, B) f32, B = LU_SOLVE_BLOCK, nb = ceil(n / B): the inverses of the
    diagonal blocks of the unit-lower L and of the upper U of a 2-D factor,
    computed in float64 and rounded once, each block stored column-major
    (dinv[s, i, c, r] is entry (r, c) of block i's inverse) and the
    identity past n.  The kernel applies them in place of substitution
    inside a block."""
    n, block = lu.shape[-1], LU_SOLVE_BLOCK
    nb = -(-n // block)
    eye = torch.eye(block, dtype=torch.float64, device=lu.device)
    diag = eye.repeat(nb, 1, 1)
    for i in range(nb):
        r0 = i * block
        m = min(block, n - r0)
        diag[i, :m, :m] = lu[r0:r0 + m, r0:r0 + m]
    eye = eye.expand(nb, block, block)
    low = torch.linalg.solve_triangular(diag, eye, upper=False, unitriangular=True)
    up = torch.linalg.solve_triangular(diag, eye, upper=True)
    return torch.stack([low, up]).mT.contiguous().float()


def _no_grad(t: torch.Tensor) -> bool:
    return not (torch.is_grad_enabled() and t.requires_grad)


def takes_factor(lu: torch.Tensor) -> bool:
    """Whether the kernel can solve against lu, so that ops/solve.lu_factor_hp
    stores perm and dinv beside it: a 2-D f32 factor on the card that
    autograd need not differentiate (the kernel has no backward)."""
    return lu.is_cuda and lu.ndim == 2 and lu.dtype == torch.float32 and _no_grad(lu)


def _narrow(b: torch.Tensor) -> bool:
    return (b.ndim == 2 and b.dtype == torch.float32 and 1 <= b.shape[1] <= K_MAX
            and _no_grad(b))


def takes(f, b: torch.Tensor) -> bool:
    """Whether ops/solve.lu_solve sends a solve against the factors f
    (solve.LUFactors) to the kernel: f carries the diagonal-block inverses
    (lu_factor_hp stores them for the factors takes_factor admits) and b
    is a 2-D f32 right-hand side of 1 to K_MAX columns that autograd need
    not differentiate.  Batched factors (the shot's per-pose systems, the
    partition-of-unity patches), wider right-hand sides, CPU tensors and
    inverse.fit_rig's gradient path go to torch.linalg.lu_solve."""
    return f.dinv is not None and takes_factor(f.lu) and _narrow(b)


def lu_solve_reference(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin: b gathered by perm, then the unit-lower and the upper
    triangular solves."""
    y = torch.linalg.solve_triangular(lu, b[perm], upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(lu, y, upper=True)


def lu_solve_cuda(lu: torch.Tensor, perm: torch.Tensor, dinv: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """x = U^-1 L^-1 P^T b for lu (n, n) column-major (LAPACK's layout,
    which lu_factor gives), perm (n,) int64 (lu_perm), dinv
    (block_inverses) and b (n, k), k <= K_MAX, any strides; returns x (n, k)
    column-major, as torch.linalg.lu_solve does."""
    if lu.device.type == "cpu":
        return lu_solve_reference(lu, perm, b)
    if lu.device.type != "cuda":
        raise ValueError(f"lu_solve_cuda takes CPU or CUDA tensors, got {lu.device}")
    if not (takes_factor(lu) and _narrow(b)):
        raise ValueError(f"lu_solve_cuda takes a 2-D f32 factor and a 2-D f32 b of 1 to "
                         f"{K_MAX} columns that autograd need not differentiate, got "
                         f"{tuple(lu.shape)} {lu.dtype}, {tuple(b.shape)} {b.dtype}")
    n, k = b.shape
    block = LU_SOLVE_BLOCK
    nb = -(-n // block)
    if lu.shape != (n, n):
        raise ValueError(f"lu has shape {tuple(lu.shape)}, b {tuple(b.shape)}")
    if not all(t.device == lu.device for t in (perm, dinv, b)):
        raise ValueError(f"lu on {lu.device}, perm on {perm.device}, dinv on {dinv.device}, "
                         f"b on {b.device}")
    if perm.dtype != torch.int64 or perm.shape != (n,) or not perm.is_contiguous():
        raise ValueError(f"perm must be a contiguous ({n},) int64 tensor")
    if (dinv.dtype != torch.float32 or dinv.shape != (2, nb, block, block)
            or not dinv.is_contiguous()):
        raise ValueError(f"dinv must be a contiguous f32 (2, {nb}, {block}, {block}) tensor, "
                         f"got {tuple(dinv.shape)} {dinv.dtype}")
    if lu.stride() != (1, n):
        raise ValueError(f"lu must be column-major (LAPACK's layout, strides (1, {n})), got "
                         f"strides {lu.stride()}")
    from facedeform_tpu_torch.ops import cuda_eval

    cuda_eval.build()
    scratch = torch.empty(nb * block * k + 2 * nb, dtype=torch.float32, device=lu.device)
    x = torch.empty((k, n), dtype=torch.float32, device=lu.device)
    with torch.cuda.device(lu.device):
        err = cuda_eval._lib.fd_lu_solve(
            lu.data_ptr(), perm.data_ptr(), dinv.data_ptr(), b.data_ptr(), scratch.data_ptr(),
            x.data_ptr(), n, k, b.stride(0), b.stride(1),
            torch.cuda.current_stream(lu.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fd_lu_solve launch failed: CUDA error {err}")
    profiling.count("launches.lu_solve_cuda")
    return x.mT
