// Displacement-field Jacobian for Hopper (sm_90a): the kernel of
// facedeform_tpu_torch/ops/cuda_jacobian.py (jacobian_cuda and
// jacobian_cuda_frames).
//
// Replaces (TPU): facedeform_tpu/ops/pallas_jacobian.py, _jac_kernel
// (jacobian_pallas, jacobian_pallas_frames).
//
// Per vertex x and frame f it accumulates twelve moments over every
// (control j, layer l) pair, with g = 2 phi'(s) / eps^2 and s = |x - c|^2
// / eps^2:
//     A[a]  = sum g w_a          T[a][b] = sum g w_a c_b
// and writes J[a][b] = A[a] x_b - T[a][b] into (F, V, 3, 3).  The linear
// tail's constant is added by the wrapper, as pallas_jacobian.py does.
//
// What bounds it on this card: compute.  Per (vertex, control, layer) one
// phi' and 15 FLOP per frame, against 12 B in and 36 B per frame out.  One
// thread per vertex keeps the 12FB moments in registers; the TPU packed
// w_a c_b as extra weight columns to feed its matrix unit, here the
// products are formed in registers from the staged control and weights.
// FB (1, 2, 4 or 8 frames per launch; at 8, 128 registers and no spills on
// sm_90a) is a template parameter, so one
// template serves the single entry (FB = 1) and the frames entry; the
// wrapper loops over frame chunks of at most kMaxJacFrames.  Controls are
// staged through shared memory as in frames.cu.  IEEE f32 only: no TF32,
// no fast-math.
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kJacThreads = 256;
constexpr int kJacChunk = 256;  // most controls staged per chunk
constexpr int kMaxJacFrames = 8;  // largest FB instantiated

struct JacArgs {
  const float* pts;       // (V, 3)
  const float* ctrl;      // (N, 3)
  const float* w_rbf;     // (L, N, 3F) frames-packed
  const float* inv_eps2;  // (L, N)
  float* out;             // (F, V, 3, 3)
  int V, N, L;
  int F, f0, nf;          // this launch's frames [f0, f0 + nf), nf <= FB
};

template <int FB>
__host__ __device__ constexpr int jac_stride() { return (3 * FB + 3) / 4 * 4; }

// Stage controls [base, base + cnt) with stride c: w[L][c][S], x[c], y[c],
// z[c], inv_eps2[L][c].
template <int FB>
__device__ __forceinline__ void stage_jac(const JacArgs& a, float* s, int c,
                                          int base, int cnt) {
  constexpr int S = jac_stride<FB>();
  const int f3 = 3 * a.F, q0 = 3 * a.f0, qn = 3 * a.nf;
  for (int idx = threadIdx.x; idx < a.L * cnt * S; idx += blockDim.x) {
    const int q = idx % S;
    const int r = idx / S;
    const int t = r % cnt;
    const int l = r / cnt;
    s[(l * c + t) * S + q] =
        q < qn ? a.w_rbf[((size_t)l * a.N + base + t) * f3 + q0 + q] : 0.0f;
  }
  float* xyz = s + a.L * c * S;
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const int j = base + t;
    xyz[t] = a.ctrl[3 * j];
    xyz[c + t] = a.ctrl[3 * j + 1];
    xyz[2 * c + t] = a.ctrl[3 * j + 2];
    for (int l = 0; l < a.L; ++l) xyz[(3 + l) * c + t] = a.inv_eps2[l * a.N + j];
  }
}

template <int B, int FB>
__global__ void __launch_bounds__(kJacThreads)
jac_kernel(JacArgs a, int chunk) {
  constexpr int S = jac_stride<FB>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* xyz = smem + a.L * chunk * S;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < a.V;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) { p[0] = a.pts[3 * i]; p[1] = a.pts[3 * i + 1]; p[2] = a.pts[3 * i + 2]; }
  float am[3 * FB], tm[9 * FB];
#pragma unroll
  for (int q = 0; q < 3 * FB; ++q) am[q] = 0.0f;
#pragma unroll
  for (int q = 0; q < 9 * FB; ++q) tm[q] = 0.0f;
  for (int base = 0; base < a.N; base += chunk) {
    const int cnt = min(chunk, a.N - base);
    __syncthreads();
    stage_jac<FB>(a, smem, chunk, base, cnt);
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float c[3] = {xyz[j], xyz[chunk + j], xyz[2 * chunk + j]};
      const float dx = c[0] - p[0];
      const float dy = c[1] - p[1];
      const float dz = c[2] - p[2];
      const float d2 = dx * dx + dy * dy + dz * dz;
      for (int l = 0; l < a.L; ++l) {
        const float ie = xyz[(3 + l) * chunk + j];
        const float g = 2.0f * phi_prime_of<B>(d2 * ie) * ie;
        const float4* w4 = reinterpret_cast<const float4*>(smem + (l * chunk + j) * S);
        float w[S];
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 wq = w4[q];
          w[4 * q] = wq.x; w[4 * q + 1] = wq.y; w[4 * q + 2] = wq.z; w[4 * q + 3] = wq.w;
        }
#pragma unroll
        for (int f = 0; f < FB; ++f) {
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float gw = g * w[3 * f + r];
            am[3 * f + r] += gw;
#pragma unroll
            for (int b = 0; b < 3; ++b) tm[9 * f + 3 * r + b] += gw * c[b];
          }
        }
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      if (f < a.nf) {
        float* o = a.out + ((size_t)(a.f0 + f) * a.V + i) * 9;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            o[3 * r + b] = am[3 * f + r] * p[b] - tm[9 * f + 3 * r + b];
          }
        }
      }
    }
  }
}

template <int B, int FB>
cudaError_t launch_jac_fb(const JacArgs& a, cudaStream_t stream) {
  const int per = 3 + a.L + a.L * jac_stride<FB>();
  int chunk = kStaticSmemFloats / per;
  if (chunk > kJacChunk) chunk = kJacChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * per * chunk;
  const int grid = (a.V + kJacThreads - 1) / kJacThreads;
  jac_kernel<B, FB><<<grid, kJacThreads, smem, stream>>>(a, chunk);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_jac(const JacArgs& a, cudaStream_t stream) {
  if (a.nf <= 1) return launch_jac_fb<B, 1>(a, stream);
  if (a.nf <= 2) return launch_jac_fb<B, 2>(a, stream);
  if (a.nf <= 4) return launch_jac_fb<B, 4>(a, stream);
  return launch_jac_fb<B, 8>(a, stream);
}

}  // namespace

extern "C" int fd_jacobian(
    const float* pts, const float* ctrl, const float* w_rbf, const float* inv_eps2,
    float* out, int V, int N, int L, int F, int f0, int nf, int basis, void* stream) {
  if (nf < 1 || nf > kMaxJacFrames || f0 < 0 || f0 + nf > F) return cudaErrorInvalidValue;
  JacArgs a;
  a.pts = pts; a.ctrl = ctrl; a.w_rbf = w_rbf; a.inv_eps2 = inv_eps2; a.out = out;
  a.V = V; a.N = N; a.L = L; a.F = F; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_jac<GAUSSIAN>(a, s);
    case THIN_PLATE: return launch_jac<THIN_PLATE>(a, s);
    case MULTIQUADRIC: return launch_jac<MULTIQUADRIC>(a, s);
    case INVERSE_MULTIQUADRIC: return launch_jac<INVERSE_MULTIQUADRIC>(a, s);
    case LINEAR: return launch_jac<LINEAR>(a, s);
    case CUBIC: return launch_jac<CUBIC>(a, s);
    case WENDLAND_C2: return launch_jac<WENDLAND_C2>(a, s);
    default: return cudaErrorInvalidValue;
  }
}
