// All-frames fused RBF deform step for Hopper (sm_90a): the frames eval
// kernel of facedeform_tpu_torch/ops/cuda_eval.py (evaluate_cuda_frames).
//
// Replaces (TPU): facedeform_tpu/ops/pallas_eval.py, _eval_frames_kernel
// (evaluate_pallas_frames).
//
// An animated shot shares the controls and radii across its F poses (the
// rest rig is fixed), so per vertex the squared distance and phi of each
// (control, layer) pair are computed once and contracted against every
// frame's weights.  The weights arrive frames-packed, (L, N, 3F) with
// column 3f + k = frame f's component k; the per-frame linear tails
// (4, 3F) likewise.  Output is written straight into (F, V, 3).
//
// What bounds it on this card: compute.  Per (vertex, control, layer) one
// phi (an exp for the gaussian) and 3F FMAs, against 12 B in and 12F B out
// per vertex.  One thread per vertex holds 3F accumulators in registers,
// so the frames per launch, FB, is a template parameter (1, 2, 4, 8 or 16:
// the smallest that holds the launch's frames; at 16, 80 registers and no
// spills on sm_90a); the wrapper loops over frame chunks of at most
// kMaxFrames.  Controls are staged through shared memory
// in chunks sized to the 48 KB static limit: the weights first, each
// control's 3FB of a layer padded to a multiple of 4 floats so they load
// as 16-byte broadcasts, then x, y, z and 1/eps^2 per layer.  IEEE f32 FMAs
// only (the TPU contracted at Precision.HIGHEST): no TF32, no fast-math.
//
// TPU idioms translated as in eval.cu: the "whole tile inactive" exit is
// a block-uniform __syncthreads_or(active); padding of V and N becomes
// bounds checks; the growing-kernel centering divides by the real N.
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kFramesThreads = 256;
constexpr int kFramesChunk = 256;  // most controls staged per chunk
constexpr int kMaxFrames = 16;     // largest FB instantiated

struct FramesArgs {
  EvalArgs e;  // w_rbf (L, N, 3F), w_poly (4, 3F), out (F, V, 3)
  int F;       // frames in the packed arrays
  int f0, nf;  // this launch's frames [f0, f0 + nf), 1 <= nf <= FB
};

// Per-control weight stride in shared memory: 3FB rounded up to whole
// float4s, so every control's weights start on a 16-byte boundary.
template <int FB>
__host__ __device__ constexpr int stride_of() { return (3 * FB + 3) / 4 * 4; }

// Stage controls [base, base + cnt) with stride c:
// w[L][c][S] (frames f0 .. f0 + nf, zero beyond), x[c], y[c], z[c],
// inv_eps2[L][c].
template <int FB>
__device__ __forceinline__ void stage_frames(const FramesArgs& a, float* s, int c,
                                             int base, int cnt) {
  constexpr int S = stride_of<FB>();
  const EvalArgs& e = a.e;
  const int f3 = 3 * a.F, q0 = 3 * a.f0, qn = 3 * a.nf;
  for (int idx = threadIdx.x; idx < e.L * cnt * S; idx += blockDim.x) {
    const int q = idx % S;
    const int r = idx / S;
    const int t = r % cnt;
    const int l = r / cnt;
    s[(l * c + t) * S + q] =
        q < qn ? e.w_rbf[((size_t)l * e.N + base + t) * f3 + q0 + q] : 0.0f;
  }
  float* xyz = s + e.L * c * S;
  for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
    const int j = base + t;
    xyz[t] = e.ctrl[3 * j];
    xyz[c + t] = e.ctrl[3 * j + 1];
    xyz[2 * c + t] = e.ctrl[3 * j + 2];
    for (int l = 0; l < e.L; ++l) xyz[(3 + l) * c + t] = e.inv_eps2[l * e.N + j];
  }
}

template <int B, bool CENTER, int FB>
__global__ void __launch_bounds__(kFramesThreads)
frames_kernel(FramesArgs a, int chunk) {
  constexpr int S = stride_of<FB>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const float* xyz = smem + a.e.L * chunk * S;
  const EvalArgs& e = a.e;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < e.V;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (valid) { p[0] = e.pts[3 * i]; p[1] = e.pts[3 * i + 1]; p[2] = e.pts[3 * i + 2]; }
  float cap, active;
  capture_of(e, i, valid, cap, active);
  float acc[S];
#pragma unroll
  for (int q = 0; q < S; ++q) acc[q] = 0.0f;
  // block-uniform: every thread takes the same branch, barriers stay safe
  if (__syncthreads_or(active > 0.0f)) {
    float center = 0.0f;
    if (CENTER) {
      // pass 1: per-vertex mean of layer-0 phi over all N controls
      float sum = 0.0f;
      for (int base = 0; base < e.N; base += chunk) {
        const int cnt = min(chunk, e.N - base);
        __syncthreads();
        stage_frames<FB>(a, smem, chunk, base, cnt);
        __syncthreads();
        for (int j = 0; j < cnt; ++j) {
          const float dx = xyz[j] - p[0];
          const float dy = xyz[chunk + j] - p[1];
          const float dz = xyz[2 * chunk + j] - p[2];
          sum += phi_of<B>((dx * dx + dy * dy + dz * dz) * xyz[3 * chunk + j]);
        }
      }
      center = sum / (float)e.N;
    }
    for (int base = 0; base < e.N; base += chunk) {
      const int cnt = min(chunk, e.N - base);
      __syncthreads();
      stage_frames<FB>(a, smem, chunk, base, cnt);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const float dx = xyz[j] - p[0];
        const float dy = xyz[chunk + j] - p[1];
        const float dz = xyz[2 * chunk + j] - p[2];
        const float d2 = dx * dx + dy * dy + dz * dz;
        for (int l = 0; l < e.L; ++l) {
          float ph = phi_of<B>(d2 * xyz[(3 + l) * chunk + j]);
          if (CENTER && l == 0) ph -= center;
          const float4* w = reinterpret_cast<const float4*>(smem + (l * chunk + j) * S);
#pragma unroll
          for (int q = 0; q < S / 4; ++q) {
            const float4 wq = w[q];
            acc[4 * q] += ph * wq.x;
            acc[4 * q + 1] += ph * wq.y;
            acc[4 * q + 2] += ph * wq.z;
            acc[4 * q + 3] += ph * wq.w;
          }
        }
      }
    }
    // per-frame linear tails, w_poly rows [1, x, y, z] x (3F,)
    const int f3 = 3 * a.F;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      if (f < a.nf) {
        const float* wp = e.w_poly + 3 * (a.f0 + f);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc[3 * f + k] = acc[3 * f + k] + wp[k] + wp[f3 + k] * p[0]
                           + wp[2 * f3 + k] * p[1] + wp[3 * f3 + k] * p[2];
        }
      }
    }
    if (e.fu != nullptr && valid) {
      // the axes do not depend on the displacement: once per vertex
      float a1[3], a2[3];
      tangent_axes(e, i, a1, a2);
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        float d[3] = {acc[3 * f], acc[3 * f + 1], acc[3 * f + 2]};
        project3(d, a1, a2);
        acc[3 * f] = d[0]; acc[3 * f + 1] = d[1]; acc[3 * f + 2] = d[2];
      }
    }
  }
  if (valid) {
    const float w = falloff_of(e, cap, active);
    e.falloff[i] = w;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      if (f < a.nf) {
        float* o = e.out + ((size_t)(a.f0 + f) * e.V + i) * 3;
        for (int k = 0; k < 3; ++k) o[k] = p[k] + acc[3 * f + k] * w;
      }
    }
  }
}

template <int B, int FB>
cudaError_t launch_fb(const FramesArgs& a, int center, cudaStream_t stream) {
  const int per = 3 + a.e.L + a.e.L * stride_of<FB>();
  int chunk = kStaticSmemFloats / per;
  if (chunk > kFramesChunk) chunk = kFramesChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * per * chunk;
  const int grid = (a.e.V + kFramesThreads - 1) / kFramesThreads;
  if (center) {
    frames_kernel<B, true, FB><<<grid, kFramesThreads, smem, stream>>>(a, chunk);
  } else {
    frames_kernel<B, false, FB><<<grid, kFramesThreads, smem, stream>>>(a, chunk);
  }
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_frames(const FramesArgs& a, int center, cudaStream_t stream) {
  if (a.nf <= 1) return launch_fb<B, 1>(a, center, stream);
  if (a.nf <= 2) return launch_fb<B, 2>(a, center, stream);
  if (a.nf <= 4) return launch_fb<B, 4>(a, center, stream);
  if (a.nf <= 8) return launch_fb<B, 8>(a, center, stream);
  return launch_fb<B, 16>(a, center, stream);
}

}  // namespace

extern "C" int fd_eval_frames(
    const float* pts, const float* dist2, const float* gate, const float* ctrl,
    const float* w_rbf, const float* inv_eps2, const float* w_poly,
    const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, int V, int N, int L, int F, int f0, int nf, int basis,
    int strict_parity, int center, float r2, float rate, void* stream) {
  if (nf < 1 || nf > kMaxFrames || f0 < 0 || f0 + nf > F) return cudaErrorInvalidValue;
  FramesArgs a;
  a.e.pts = pts; a.e.dist2 = dist2; a.e.gate = gate; a.e.ctrl = ctrl;
  a.e.w_rbf = w_rbf; a.e.inv_eps2 = inv_eps2; a.e.w_poly = w_poly;
  a.e.fu = fu; a.e.fv = fv; a.e.fn = fn; a.e.out = out; a.e.falloff = falloff;
  a.e.V = V; a.e.N = N; a.e.L = L; a.e.strict_parity = strict_parity;
  a.e.r2 = r2; a.e.rate = rate;
  a.F = F; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_frames<GAUSSIAN>(a, center, s);
    case THIN_PLATE: return launch_frames<THIN_PLATE>(a, center, s);
    case MULTIQUADRIC: return launch_frames<MULTIQUADRIC>(a, center, s);
    case INVERSE_MULTIQUADRIC: return launch_frames<INVERSE_MULTIQUADRIC>(a, center, s);
    case LINEAR: return launch_frames<LINEAR>(a, center, s);
    case CUBIC: return launch_frames<CUBIC>(a, center, s);
    case WENDLAND_C2: return launch_frames<WENDLAND_C2>(a, center, s);
    default: return cudaErrorInvalidValue;
  }
}
