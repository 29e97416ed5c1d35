// Float64 deform step for growing kernels on Hopper (sm_90a): the precise
// eval kernel of facedeform_tpu_torch/ops/cuda_precise.py.
//
// Replaces (TPU): facedeform_tpu/ops/pallas_precise.py, _precise_kernel
// (evaluate_pallas_precise).  The TPU has no float64, so that kernel
// carries every value as a double-float (hi, lo) pair of f32 words built
// from error-free transforms; the H100 has native fp64, so this kernel
// computes the same quantity in double and keeps none of the pair
// arithmetic.
//
// Per vertex: squared distance to every control from the exact f32
// coordinates, s = d2 / eps^2, phi(s) for the 7 bases with accurate
// exp/log/sqrt, the contraction against w_rbf + w_rbf_lo and the linear
// tail [1, x, y, z] . (w_poly + w_poly_lo), all in double; then the
// displacement is rounded to f32 once, projected to the tangent plane and
// weighted by the capture falloff in f32 exactly as the dense f32 kernel
// does (common.cuh), and P + w * disp and w are written.  No centering of
// phi: that is the f32 kernel's cancellation guard, not needed in double.
//
// What bounds it on this card: fp64 compute.  A (vertex, control) pair
// costs ~40 double operations (the software log of the thin-plate basis
// dominates; sqrt for MQ/linear/cubic) against the card's 34 TFLOP/s of
// non-tensor fp64, while a vertex moves ~28 B of device memory, so the
// kernel is compute-bound at any useful control count.  The design is the
// dense f32 kernel's: one thread per vertex, three double accumulators in
// registers, controls staged through shared memory in structure-of-arrays
// chunks (x, y, z, 1/eps^2 per layer and w per layer, all as double) and
// read as broadcasts; the staged doubles take 2x the f32 kernel's shared
// memory, opted in above 48 KB.  The capture early exit is the block-
// uniform __syncthreads_or(active) of eval.cu; the TPU's padding of V and
// N to tile multiples becomes bounds checks.
//
// No fast-math: FMA contraction is harmless here, as no error-free
// transform is computed in this file (a double-float rewrite in f32 would
// need --fmad=false).
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kPreciseThreads = 256;
constexpr int kPreciseChunk = 256;             // controls staged per chunk
constexpr size_t kMaxSmemBytes = 232448;       // 227 KB opt-in limit

struct PreciseArgs {
  EvalArgs e;               // f32 vertex inputs/outputs, f32 ctrl, sizes, capture
  const double* inv_eps2;   // (L, N)
  const double* w;          // (L, N, 3): w_rbf + w_rbf_lo
  const double* w_poly;     // (4, 3): w_poly + w_poly_lo, absent rows zero
};

template <int B>
__device__ __forceinline__ double phi64(double s) {
  if constexpr (B == GAUSSIAN) {
    return exp(-s);
  } else if constexpr (B == THIN_PLATE) {
    return s > 1e-30 ? 0.5 * s * log(s) : 0.0;
  } else if constexpr (B == MULTIQUADRIC) {
    return sqrt(1.0 + s);
  } else if constexpr (B == INVERSE_MULTIQUADRIC) {
    return rsqrt(1.0 + s);
  } else if constexpr (B == LINEAR) {
    return sqrt(s);
  } else if constexpr (B == CUBIC) {
    return s * sqrt(s);
  } else {
    const double t = sqrt(s);
    const double b = fmax(1.0 - t, 0.0);
    const double b2 = b * b;
    return b2 * b2 * (4.0 * t + 1.0);
  }
}

// Stage controls [base, base + cnt) into shared memory, SoA with stride c:
// x[c], y[c], z[c], inv_eps2[L][c], w[L][3][c], all double.
__device__ __forceinline__ void stage64(const PreciseArgs& a, double* s, int c,
                                        int base, int cnt) {
  const int L = a.e.L, N = a.e.N;
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const int j = base + t;
    s[t] = a.e.ctrl[3 * j];
    s[c + t] = a.e.ctrl[3 * j + 1];
    s[2 * c + t] = a.e.ctrl[3 * j + 2];
    for (int l = 0; l < L; ++l) {
      const int lj = l * N + j;
      s[(3 + l) * c + t] = a.inv_eps2[lj];
      double* w = s + (3 + L + 3 * l) * c + t;
      w[0] = a.w[3 * lj];
      w[c] = a.w[3 * lj + 1];
      w[2 * c] = a.w[3 * lj + 2];
    }
  }
}

template <int B>
__global__ void __launch_bounds__(kPreciseThreads)
precise_kernel(PreciseArgs a, int chunk) {
  extern __shared__ double smem64[];
  const EvalArgs& e = a.e;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < e.V;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) { p[0] = e.pts[3 * i]; p[1] = e.pts[3 * i + 1]; p[2] = e.pts[3 * i + 2]; }
  float cap, active;
  capture_of(e, i, valid, cap, active);
  float d[3] = {0.0f, 0.0f, 0.0f};
  // block-uniform: every thread takes the same branch, barriers stay safe
  if (__syncthreads_or(active > 0.0f)) {
    const double px = p[0], py = p[1], pz = p[2];
    double acc[3] = {0.0, 0.0, 0.0};
    for (int base = 0; base < e.N; base += chunk) {
      const int cnt = min(chunk, e.N - base);
      __syncthreads();
      stage64(a, smem64, chunk, base, cnt);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const double dx = smem64[j] - px;
        const double dy = smem64[chunk + j] - py;
        const double dz = smem64[2 * chunk + j] - pz;
        const double d2 = dx * dx + dy * dy + dz * dz;
        for (int l = 0; l < e.L; ++l) {
          const double ph = phi64<B>(d2 * smem64[(3 + l) * chunk + j]);
          const double* w = smem64 + (3 + e.L + 3 * l) * chunk + j;
          acc[0] += ph * w[0];
          acc[1] += ph * w[chunk];
          acc[2] += ph * w[2 * chunk];
        }
      }
    }
    for (int k = 0; k < 3; ++k) {
      acc[k] += a.w_poly[k] + a.w_poly[3 + k] * px + a.w_poly[6 + k] * py
                + a.w_poly[9 + k] * pz;
      d[k] = static_cast<float>(acc[k]);
    }
    if (e.fu != nullptr && valid) project_tangent(e, i, d);
  }
  if (valid) {
    const float w = falloff_of(e, cap, active);
    e.falloff[i] = w;
    for (int k = 0; k < 3; ++k) e.out[3 * i + k] = p[k] + d[k] * w;
  }
}

template <int B>
cudaError_t launch_precise(const PreciseArgs& a, cudaStream_t stream) {
  const size_t per = sizeof(double) * (3 + 4 * a.e.L);   // bytes per control
  int chunk = kPreciseChunk;
  if (per * chunk > kMaxSmemBytes) chunk = static_cast<int>(kMaxSmemBytes / per);
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = per * chunk;
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t err = cudaFuncSetAttribute(
        precise_kernel<B>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (a.e.V + kPreciseThreads - 1) / kPreciseThreads;
  precise_kernel<B><<<grid, kPreciseThreads, smem, stream>>>(a, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fd_eval_precise(
    const float* pts, const float* dist2, const float* gate, const float* ctrl,
    const double* w, const double* inv_eps2, const double* w_poly,
    const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, int V, int N, int L, int basis, int strict_parity,
    float r2, float rate, void* stream) {
  PreciseArgs a;
  a.e.pts = pts; a.e.dist2 = dist2; a.e.gate = gate; a.e.ctrl = ctrl;
  a.e.w_rbf = nullptr; a.e.inv_eps2 = nullptr; a.e.w_poly = nullptr;
  a.e.fu = fu; a.e.fv = fv; a.e.fn = fn; a.e.out = out; a.e.falloff = falloff;
  a.e.V = V; a.e.N = N; a.e.L = L; a.e.strict_parity = strict_parity;
  a.e.r2 = r2; a.e.rate = rate;
  a.inv_eps2 = inv_eps2; a.w = w; a.w_poly = w_poly;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_precise<GAUSSIAN>(a, s);
    case THIN_PLATE: return launch_precise<THIN_PLATE>(a, s);
    case MULTIQUADRIC: return launch_precise<MULTIQUADRIC>(a, s);
    case INVERSE_MULTIQUADRIC: return launch_precise<INVERSE_MULTIQUADRIC>(a, s);
    case LINEAR: return launch_precise<LINEAR>(a, s);
    case CUBIC: return launch_precise<CUBIC>(a, s);
    case WENDLAND_C2: return launch_precise<WENDLAND_C2>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
