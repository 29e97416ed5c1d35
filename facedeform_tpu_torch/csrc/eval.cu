// Fused RBF deform step for Hopper (sm_90a): the dense and the culled
// per-vertex eval kernels of facedeform_tpu_torch/ops/cuda_eval.py.
//
// Replaces (TPU):
//   dense  - facedeform_tpu/ops/pallas_eval.py, _eval_kernel (evaluate_pallas)
//   culled - facedeform_tpu/ops/pallas_eval.py, _eval_kernel_culled
//            (evaluate_pallas_culled)
//
// Per vertex: squared distance to every control, phi per layer (7 bases),
// optional layer-0 centering for growing kernels, contraction against the
// (L, N, 3) weights, linear tail, optional oblique tangent projection,
// capture falloff (1 - min(d2/r^2, 1))^rate * active * gate, and the
// writes P + w * disp and w.
//
// What bounds it on this card: compute.  Each (vertex, control) pair costs
// about 15 FLOP and one exp (gaussian) while a vertex moves about 28 B of
// device memory (12 B in, 12 B + 4 B out, 8 B of capture inputs), so at
// 1k controls the kernel does ~500 FLOP per byte, far above the card's
// ~20 FLOP/B float32 balance point.  The design therefore keeps every
// control read on chip: one thread per vertex, three f32 accumulators in
// registers, and the control data (x, y, z, 1/eps^2 per layer, w per layer)
// staged through shared memory in structure-of-arrays chunks.  All threads
// of a block read the same control at once, so each shared read is a
// broadcast.  The math is accurate expf/logf/sqrtf/rsqrtf (no fast-math):
// the 5e-5 displacement budget is the contract.
//
// TPU idioms translated:
//   * the sequential-grid "whole tile inactive" early exit becomes a
//     block-uniform __syncthreads_or(active): a block with no active vertex
//     writes P and a zero falloff, and no thread skips a barrier;
//   * the TPU's padding of V and N to tile multiples becomes bounds checks;
//     the growing-kernel centering divides by the real N (any per-vertex
//     constant is exact under sum(w) = 0);
//   * the culled kernel's tile bbox is a block min/max reduction over the
//     block's valid vertices only (padding lanes would drag it to 0).
//
// C ABI, loaded with ctypes; each entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kDenseThreads = 256;
constexpr int kDenseChunk = 256;   // controls staged per shared-memory chunk
constexpr int kCullBlock = 128;    // control slab = culled block size
constexpr int kCullThreads = kCullBlock;

// Stage controls [base, base + cnt) into shared memory, SoA with stride c:
// x[c], y[c], z[c], inv_eps2[L][c], w[L][3][c].
__device__ __forceinline__ void stage(const EvalArgs& a, float* s, int c,
                                      int base, int cnt) {
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const int j = base + t;
    s[t] = a.ctrl[3 * j];
    s[c + t] = a.ctrl[3 * j + 1];
    s[2 * c + t] = a.ctrl[3 * j + 2];
    for (int l = 0; l < a.L; ++l) {
      const int lj = l * a.N + j;
      s[(3 + l) * c + t] = a.inv_eps2[lj];
      float* w = s + (3 + a.L + 3 * l) * c + t;
      w[0] = a.w_rbf[3 * lj];
      w[c] = a.w_rbf[3 * lj + 1];
      w[2 * c] = a.w_rbf[3 * lj + 2];
    }
  }
}

// Accumulate cnt staged controls into acc; layer-0 phi minus center.
template <int B, bool CENTER>
__device__ __forceinline__ void accumulate(const float* s, int c, int cnt,
                                           int L, float px, float py,
                                           float pz, float center,
                                           float acc[3]) {
  for (int j = 0; j < cnt; ++j) {
    const float dx = s[j] - px;
    const float dy = s[c + j] - py;
    const float dz = s[2 * c + j] - pz;
    const float d2 = dx * dx + dy * dy + dz * dz;
    for (int l = 0; l < L; ++l) {
      float ph = phi_of<B>(d2 * s[(3 + l) * c + j]);
      if (CENTER && l == 0) ph -= center;
      const float* w = s + (3 + L + 3 * l) * c + j;
      acc[0] += ph * w[0];
      acc[1] += ph * w[c];
      acc[2] += ph * w[2 * c];
    }
  }
}

__device__ __forceinline__ void write_vertex(const EvalArgs& a, int i,
                                             const float p[3], const float d[3],
                                             float cap, float active) {
  const float w = falloff_of(a, cap, active);
  a.falloff[i] = w;
  for (int k = 0; k < 3; ++k) a.out[3 * i + k] = p[k] + d[k] * w;
}

template <int B, bool CENTER>
__global__ void __launch_bounds__(kDenseThreads)
dense_kernel(EvalArgs a, int chunk) {
  extern __shared__ float smem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < a.V;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) { p[0] = a.pts[3 * i]; p[1] = a.pts[3 * i + 1]; p[2] = a.pts[3 * i + 2]; }
  float cap, active;
  capture_of(a, i, valid, cap, active);
  float d[3] = {0.0f, 0.0f, 0.0f};
  // block-uniform: every thread takes the same branch, barriers stay safe
  if (__syncthreads_or(active > 0.0f)) {
    float center = 0.0f;
    if (CENTER) {
      // pass 1: per-vertex mean of layer-0 phi over all N controls
      float sum = 0.0f;
      for (int base = 0; base < a.N; base += chunk) {
        const int cnt = min(chunk, a.N - base);
        __syncthreads();
        stage(a, smem, chunk, base, cnt);
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const float dx = smem[j] - p[0];
          const float dy = smem[chunk + j] - p[1];
          const float dz = smem[2 * chunk + j] - p[2];
          sum += phi_of<B>((dx * dx + dy * dy + dz * dz) * smem[3 * chunk + j]);
        }
      }
      center = sum / (float)a.N;
    }
    for (int base = 0; base < a.N; base += chunk) {
      const int cnt = min(chunk, a.N - base);
      __syncthreads();
      stage(a, smem, chunk, base, cnt);
      __syncthreads();
      accumulate<B, CENTER>(smem, chunk, cnt, a.L, p[0], p[1], p[2], center, d);
    }
    // linear tail, w_poly rows [1, x, y, z]
    for (int k = 0; k < 3; ++k) {
      d[k] = d[k] + a.w_poly[k] + a.w_poly[3 + k] * p[0]
             + a.w_poly[6 + k] * p[1] + a.w_poly[9 + k] * p[2];
    }
    if (a.fu != nullptr && valid) project_tangent(a, i, d);
  }
  if (valid) write_vertex(a, i, p, d, cap, active);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// bbox: (nb, 8) per slab lo.xyz, hi.xyz, cutoff^2, pad; controls arrive
// Morton-sorted and padded to whole kCullBlock slabs.
template <int B>
__global__ void __launch_bounds__(kCullThreads)
culled_kernel(EvalArgs a, const float* bbox, int nb) {
  extern __shared__ float smem[];
  __shared__ float red[6][kCullThreads / 32];
  __shared__ float tile[6];  // block bbox lo.xyz, hi.xyz
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < a.V;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) { p[0] = a.pts[3 * i]; p[1] = a.pts[3 * i + 1]; p[2] = a.pts[3 * i + 2]; }
  float cap, active;
  capture_of(a, i, valid, cap, active);
  float d[3] = {0.0f, 0.0f, 0.0f};
  if (__syncthreads_or(active > 0.0f)) {
    // bbox of the block's valid vertices (every block has at least one)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = 0; k < 3; ++k) {
      const float lo = warp_min(valid ? p[k] : INFINITY);
      const float hi = warp_max(valid ? p[k] : -INFINITY);
      if (lane == 0) { red[k][warp] = lo; red[3 + k][warp] = hi; }
    }
    __syncthreads();
    if (threadIdx.x < 6) {
      const int k = threadIdx.x;
      float v = red[k][0];
      for (int w = 1; w < kCullThreads / 32; ++w)
        v = k < 3 ? fminf(v, red[k][w]) : fmaxf(v, red[k][w]);
      tile[k] = v;
    }
    __syncthreads();
    // start from the linear tail
    for (int k = 0; k < 3; ++k) {
      d[k] = a.w_poly[k] + a.w_poly[3 + k] * p[0] + a.w_poly[6 + k] * p[1]
             + a.w_poly[9 + k] * p[2];
    }
    for (int b = 0; b < nb; ++b) {
      const float* bb = bbox + 8 * b;
      const float gx = fmaxf(fmaxf(bb[0] - tile[3], tile[0] - bb[3]), 0.0f);
      const float gy = fmaxf(fmaxf(bb[1] - tile[4], tile[1] - bb[4]), 0.0f);
      const float gz = fmaxf(fmaxf(bb[2] - tile[5], tile[2] - bb[5]), 0.0f);
      // same inputs in every thread: the skip is block-uniform
      if (gx * gx + gy * gy + gz * gz <= bb[6]) {
        __syncthreads();
        stage(a, smem, kCullBlock, b * kCullBlock, kCullBlock);
        __syncthreads();
        accumulate<B, false>(smem, kCullBlock, kCullBlock, a.L, p[0], p[1],
                             p[2], 0.0f, d);
      }
    }
    if (a.fu != nullptr && valid) project_tangent(a, i, d);
  }
  if (valid) write_vertex(a, i, p, d, cap, active);
}

template <int B>
cudaError_t launch_dense(const EvalArgs& a, int center, cudaStream_t stream) {
  const int per = 3 + 4 * a.L;
  int chunk = kStaticSmemFloats / per;
  if (chunk > kDenseChunk) chunk = kDenseChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * per * chunk;
  const int grid = (a.V + kDenseThreads - 1) / kDenseThreads;
  if (center) {
    dense_kernel<B, true><<<grid, kDenseThreads, smem, stream>>>(a, chunk);
  } else {
    dense_kernel<B, false><<<grid, kDenseThreads, smem, stream>>>(a, chunk);
  }
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_culled(const EvalArgs& a, const float* bbox, int nb,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 + 4 * a.L) * kCullBlock;
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t e = cudaFuncSetAttribute(
        culled_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.V + kCullThreads - 1) / kCullThreads;
  culled_kernel<B><<<grid, kCullThreads, smem, stream>>>(a, bbox, nb);
  return cudaGetLastError();
}

EvalArgs make_args(const float* pts, const float* dist2, const float* gate,
                   const float* ctrl, const float* w_rbf, const float* inv_eps2,
                   const float* w_poly, const float* fu, const float* fv,
                   const float* fn, float* out, float* falloff, int V, int N,
                   int L, int strict_parity, float r2, float rate) {
  EvalArgs a;
  a.pts = pts; a.dist2 = dist2; a.gate = gate; a.ctrl = ctrl;
  a.w_rbf = w_rbf; a.inv_eps2 = inv_eps2; a.w_poly = w_poly;
  a.fu = fu; a.fv = fv; a.fn = fn; a.out = out; a.falloff = falloff;
  a.V = V; a.N = N; a.L = L; a.strict_parity = strict_parity;
  a.r2 = r2; a.rate = rate;
  return a;
}

}  // namespace

extern "C" int fd_eval_dense(
    const float* pts, const float* dist2, const float* gate, const float* ctrl,
    const float* w_rbf, const float* inv_eps2, const float* w_poly,
    const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, int V, int N, int L, int basis, int strict_parity,
    int center, float r2, float rate, void* stream) {
  const EvalArgs a = make_args(pts, dist2, gate, ctrl, w_rbf, inv_eps2, w_poly,
                               fu, fv, fn, out, falloff, V, N, L,
                               strict_parity, r2, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_dense<GAUSSIAN>(a, center, s);
    case THIN_PLATE: return launch_dense<THIN_PLATE>(a, center, s);
    case MULTIQUADRIC: return launch_dense<MULTIQUADRIC>(a, center, s);
    case INVERSE_MULTIQUADRIC: return launch_dense<INVERSE_MULTIQUADRIC>(a, center, s);
    case LINEAR: return launch_dense<LINEAR>(a, center, s);
    case CUBIC: return launch_dense<CUBIC>(a, center, s);
    case WENDLAND_C2: return launch_dense<WENDLAND_C2>(a, center, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int fd_eval_culled(
    const float* pts, const float* dist2, const float* gate, const float* ctrl,
    const float* w_rbf, const float* inv_eps2, const float* w_poly,
    const float* fu, const float* fv, const float* fn, const float* bbox,
    float* out, float* falloff, int V, int n_slabs, int L, int basis,
    int strict_parity, float r2, float rate, void* stream) {
  const EvalArgs a = make_args(pts, dist2, gate, ctrl, w_rbf, inv_eps2, w_poly,
                               fu, fv, fn, out, falloff, V,
                               n_slabs * kCullBlock, L, strict_parity, r2, rate);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_culled<GAUSSIAN>(a, bbox, n_slabs, s);
    case WENDLAND_C2: return launch_culled<WENDLAND_C2>(a, bbox, n_slabs, s);
    default: return cudaErrorInvalidValue;
  }
}
