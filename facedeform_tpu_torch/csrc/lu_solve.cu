// LU solve against one f32 factorization for Hopper (sm_90a): the kernel of
// facedeform_tpu_torch/ops/cuda_solve.py (lu_solve_cuda), the solve behind
// ops/solve.lu_solve for a 2-D f32 factor and a right-hand side of at most
// kLuMaxRhs columns.
//
// Replaces no TPU kernel: the JAX package leaves lu_solve to XLA.  Added
// because the drag refit of a 4096-marker thin-plate rig (GMRES-IR against
// stored factors: 103 solves of 3 columns a cook against the 4100 x 4100
// factor) spent ~70% of its device time in cuBLAS's two trsm kernels and
// ATen's per-call pivot unpack, ~2.0 ms a solve, where reading the factor
// once takes ~20 us at 3.35 TB/s.
//
// Computes x = U^-1 L^-1 P^T b.  lu holds LAPACK's layout, column-major
// ((r, c) at r + c n), L unit lower and U upper.  Two things come with the
// factors, computed once per factorization by the wrapper: the row
// permutation perm ((P^T b)[r] = b[perm[r]]), which the forward
// substitution gathers b by, and dinv, the inverses of the B x B diagonal
// blocks of L and of U.
//
// What bounds it: bytes, the factor read once (4 n^2 B); at n ~ 4k the
// dependency chain binds before them, since row block i needs the solution
// of every earlier block.  The design shortens the chain's step: rows are
// cut into blocks of B = 128 (64 took 0.28 ms a solve at n = 4100 against
// 0.21, PERF.md), one block of 256 threads each, assigned cyclically so
// that any n fits the co-resident grid of a cooperative launch.  A block
// streams its off-diagonal panel of L (then U) one column block at a time,
// 16 B a thread, the next column block's loads in flight while it waits,
// and folds in each earlier block's solution as soon as that block
// publishes it (a per-block ready flag, release/acquire; the flags are
// zeroed on the stream before each launch).
// The diagonal block is applied as its stored inverse, staged in shared
// memory before the wait: a product of depth B / 2 on the chain, where a
// substitution would take B dependent steps (one warp's shuffle-and-FMA
// substitution made a solve 0.78 ms at n = 4100).  Every sum runs in a
// fixed order (each thread over its columns, then the groups' sums, then
// the product's parts) and no atomic touches the arithmetic: two launches
// on the same inputs give the same bits.  f32 throughout, no tensor cores.
// A wait that lasts seconds traps instead of hanging the card.
//
// x is written column-major ((r, c) at r + c n), LAPACK's layout for a
// solution, which the callers' products read.
//
// C ABI, loaded with ctypes; the entry point returns a cudaError_t as int.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLuThreads = 256;
constexpr int kLuBlock = 128;                 // LU_SOLVE_BLOCK in ops/cuda_solve.py
constexpr int kLuMaxRhs = 4;                  // K_MAX in ops/cuda_solve.py
constexpr int kLuMaxDevices = 64;
constexpr long long kLuMaxSpins = 1ll << 26;  // ~25 s of polling

struct LuArgs {
  const float* lu;        // (n, n) column-major
  const long long* perm;  // (n,) forward gather: row r reads b[perm[r]]
  const float* dinv;      // (2, nb, B, B): L's, then U's diagonal-block inverses,
                          // each column-major ([c][r] = inv(r, c)), identity past n
  const float* b;         // (n, K), element strides sbr, sbc
  float* y;               // (nb B, K) row-major: the forward solution
  float* x;               // (n, K) column-major: the solution
  int* flags;             // (2 nb): forward, then backward ready flags
  int n, sbr, sbc, nb;
};

struct LuGeo {
  static constexpr int B = kLuBlock;
  static constexpr int kQuads = B / 4;                 // 4-row quads of a block
  static constexpr int kGroups = kLuThreads / kQuads;  // panel column groups
  static constexpr int kCols = B / kGroups;            // a group's columns a column block
  static constexpr int kSplit = kLuThreads / B;        // threads a row of the inverse product
  static constexpr int kSplitCols = B / kSplit;        // columns each of them sums
  static_assert(kLuThreads % kQuads == 0 && B % kGroups == 0 && B % kSplit == 0,
                "block geometry");
};

template <int K>
constexpr size_t lu_smem_floats() {
  return kLuBlock * kLuBlock + LuGeo::kGroups * kLuBlock * K + kLuBlock * K;
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Spin until a block has published.  Its inputs are all published or being
// computed by a resident block, so the wait ends; a wait of many seconds
// means a fault, and traps rather than hanging the card.
__device__ __forceinline__ void wait_flag(const int* flag) {
  for (long long spins = 0; ld_acquire(flag) == 0; ++spins) {
    if (spins > kLuMaxSpins) __trap();
  }
}

// Rows row .. row + 3 of column col of the factor, zero past n.
template <bool VEC>
__device__ __forceinline__ float4 load_quad(const LuArgs& a, int row, int col) {
  if (col >= a.n || row >= a.n) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = a.lu + static_cast<size_t>(col) * a.n + row;
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v;
  v.x = __ldg(p);
  v.y = row + 1 < a.n ? __ldg(p + 1) : 0.f;
  v.z = row + 2 < a.n ? __ldg(p + 2) : 0.f;
  v.w = row + 3 < a.n ? __ldg(p + 3) : 0.f;
  return v;
}

// One row block: rows r0 .. r0 + B of the forward (L) or backward (U)
// substitution.
template <int K, bool VEC, bool UPPER>
__device__ void solve_block(const LuArgs& a, int i, float* smem) {
  using G = LuGeo;
  constexpr int B = kLuBlock;
  float* inv = smem;                      // the diagonal block's inverse, [c][r]
  float* red = inv + B * B;               // (kGroups, B, K) partial sums
  float* acc = red + G::kGroups * B * K;  // (B, K) right-hand side less the panel
  const int t = threadIdx.x;
  const int r0 = i * B;

  // what waits on nothing, first: the block's own right-hand side (b
  // gathered by perm, or its forward solution) and its inverse block
  float base[K];
  if (t < B) {
    const int r = r0 + t;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      if (UPPER) {
        base[kk] = __ldcg(a.y + static_cast<size_t>(r) * K + kk);
      } else {
        base[kk] = r < a.n ? __ldg(a.b + a.perm[r] * a.sbr + static_cast<long long>(kk) * a.sbc)
                           : 0.f;
      }
    }
  }
  {
    const float4* src = reinterpret_cast<const float4*>(
        a.dinv + (static_cast<size_t>(UPPER ? a.nb : 0) + i) * B * B);
    float4* dst = reinterpret_cast<float4*>(inv);
    for (int e = t; e < B * B / 4; e += kLuThreads) dst[e] = __ldg(src + e);
  }

  // the off-diagonal panel, column block by column block in the order the
  // chain publishes them: thread (rq, cg) owns rows 4 rq .. 4 rq + 3 and
  // columns cg kCols .. (cg + 1) kCols of each column block
  const int rq = t % G::kQuads, cg = t / G::kQuads;
  const int row = r0 + 4 * rq;
  const int steps = UPPER ? a.nb - 1 - i : i;
  const int* flags = a.flags + (UPPER ? a.nb : 0);
  float p[4][K];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int kk = 0; kk < K; ++kk) p[q][kk] = 0.f;
  float4 cur[G::kCols];
  if (steps > 0) {
    const int c0 = (UPPER ? a.nb - 1 : 0) * B + cg * G::kCols;
#pragma unroll
    for (int m = 0; m < G::kCols; ++m) cur[m] = load_quad<VEC>(a, row, c0 + m);
  }
  for (int s = 0; s < steps; ++s) {
    const int j = UPPER ? a.nb - 1 - s : s;
    float4 nxt[G::kCols];
    if (s + 1 < steps) {
      const int c1 = (UPPER ? j - 1 : j + 1) * B + cg * G::kCols;
#pragma unroll
      for (int m = 0; m < G::kCols; ++m) nxt[m] = load_quad<VEC>(a, row, c1 + m);
    }
    wait_flag(flags + j);
    const int c0 = j * B + cg * G::kCols;
#pragma unroll
    for (int m = 0; m < G::kCols; ++m) {
      const int c = c0 + m;
      float sv[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        if (c >= a.n) {
          sv[kk] = 0.f;
        } else if (UPPER) {
          sv[kk] = __ldcg(a.x + static_cast<size_t>(kk) * a.n + c);
        } else {
          sv[kk] = __ldcg(a.y + static_cast<size_t>(c) * K + kk);
        }
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        p[0][kk] = fmaf(cur[m].x, sv[kk], p[0][kk]);
        p[1][kk] = fmaf(cur[m].y, sv[kk], p[1][kk]);
        p[2][kk] = fmaf(cur[m].z, sv[kk], p[2][kk]);
        p[3][kk] = fmaf(cur[m].w, sv[kk], p[3][kk]);
      }
    }
    if (s + 1 < steps) {
#pragma unroll
      for (int m = 0; m < G::kCols; ++m) cur[m] = nxt[m];
    }
  }

  // the groups' sums in a fixed order
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int kk = 0; kk < K; ++kk) red[(cg * B + 4 * rq + q) * K + kk] = p[q][kk];
  __syncthreads();
  if (t < B) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < G::kGroups; ++g) sum += red[(g * B + t) * K + kk];
      acc[t * K + kk] = base[kk] - sum;
    }
  }
  __syncthreads();

  // the diagonal block: the solution is inverse x acc, row r summed by
  // kSplit threads over kSplitCols columns each, then their sums in order
  {
    const int r = t % B, h = t / B;
    float q[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) q[kk] = 0.f;
#pragma unroll 16
    for (int m = 0; m < G::kSplitCols; ++m) {
      const int c = h * G::kSplitCols + m;
      const float w = inv[c * B + r];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) q[kk] = fmaf(w, acc[c * K + kk], q[kk]);
    }
#pragma unroll
    for (int kk = 0; kk < K; ++kk) red[(h * B + r) * K + kk] = q[kk];
  }
  __syncthreads();
  if (t < B) {
    const int r = r0 + t;
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float v = red[t * K + kk];
#pragma unroll
      for (int h = 1; h < G::kSplit; ++h) v += red[(h * B + t) * K + kk];
      if (UPPER) {
        if (r < a.n) a.x[static_cast<size_t>(kk) * a.n + r] = v;
      } else {
        a.y[static_cast<size_t>(r) * K + kk] = v;
      }
    }
    __threadfence();
  }
  __syncthreads();
  if (t == 0) st_release(a.flags + (UPPER ? a.nb : 0) + i, 1);
}

// Forward over the block's row blocks in ascending order, then backward in
// descending order.  The lowest unfinished forward block (the highest
// unfinished backward one) always has its inputs, and a cooperative launch
// keeps every block resident, so the spinning never deadlocks.
template <int K, bool VEC>
__global__ void __launch_bounds__(kLuThreads, 1) lu_solve_kernel(LuArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  for (int i = blockIdx.x; i < a.nb; i += gridDim.x) solve_block<K, VEC, false>(a, i, smem);
  const int last = blockIdx.x + (a.nb - 1 - blockIdx.x) / gridDim.x * gridDim.x;
  for (int i = last; i >= 0; i -= gridDim.x) solve_block<K, VEC, true>(a, i, smem);
}

template <int K, bool VEC>
cudaError_t launch_lu(LuArgs a, cudaStream_t stream) {
  static int max_grid[kLuMaxDevices] = {};
  const size_t smem = sizeof(float) * lu_smem_floats<K>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kLuMaxDevices) return cudaErrorInvalidDevice;
  if (max_grid[dev] == 0) {
    err = cudaFuncSetAttribute(lu_solve_kernel<K, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lu_solve_kernel<K, VEC>,
                                                        kLuThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    max_grid[dev] = per_sm * sms;
  }
  err = cudaMemsetAsync(a.flags, 0, sizeof(int) * 2 * a.nb, stream);
  if (err != cudaSuccess) return err;
  const int grid = a.nb < max_grid[dev] ? a.nb : max_grid[dev];
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(lu_solve_kernel<K, VEC>),
                                    dim3(grid), dim3(kLuThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_lu_vec(const LuArgs& a, bool vec, cudaStream_t stream) {
  return vec ? launch_lu<K, true>(a, stream) : launch_lu<K, false>(a, stream);
}

}  // namespace

// dinv: (2, nb, kLuBlock, kLuBlock) for nb = ceil(n / kLuBlock)
// (ops/cuda_solve.py, block_inverses), 16-byte aligned.  scratch: (nb
// kLuBlock k) floats for the forward solution, then 2 nb ints of ready
// flags.  b is read through element strides (sbr, sbc); x is written (n, k)
// column-major.
extern "C" int fd_lu_solve(const float* lu, const long long* perm, const float* dinv,
                           const float* b, float* scratch, float* x, int n, int k, int sbr,
                           int sbc, void* stream) {
  if (n < 1 || reinterpret_cast<uintptr_t>(dinv) % 16 != 0) return cudaErrorInvalidValue;
  LuArgs a;
  a.lu = lu; a.perm = perm; a.dinv = dinv; a.b = b; a.x = x;
  a.n = n; a.sbr = sbr; a.sbc = sbc;
  a.nb = (n + kLuBlock - 1) / kLuBlock;
  a.y = scratch;
  a.flags = reinterpret_cast<int*>(scratch + static_cast<size_t>(a.nb) * kLuBlock * k);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(lu) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: return launch_lu_vec<1>(a, vec, s);
    case 2: return launch_lu_vec<2>(a, vec, s);
    case 3: return launch_lu_vec<3>(a, vec, s);
    case 4: return launch_lu_vec<4>(a, vec, s);
    default: return cudaErrorInvalidValue;
  }
}
