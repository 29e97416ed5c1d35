// Partition-of-unity tile accumulation for Hopper (sm_90a): the kernel of
// facedeform_tpu_torch/ops/cuda_pu.py (evaluate_pu_tiles_frames).
//
// Replaces (TPU): facedeform_tpu/ops/pallas_pu.py, _pu_accum_kernel
// (evaluate_pu_tiles / evaluate_pu_tiles_frames).
//
// The field is s(x) = sum_k W_k(x) s_k(x) / sum_k W_k(x) over the K
// patches whose support covers x; s_k is patch k's local RBF interpolant
// on patch-centered coordinates, W_k the Wendland C2 weight of
// |x - c_k| / R_k, or 1 where k is the point's forced (nearest-patch)
// fallback.  The host plan (PUTilePlan) Z-orders the points into tiles of
// 256 and lists each tile's patches (items), CSR by tile.
//
// The TPU kernel walks the items as one sequential grid and keeps each
// tile's accumulator resident in VMEM while the output block index repeats
// (zeroed at a tile's first item).  Here one block of 256 threads owns one
// vertex tile, one thread per point, and loops over its own items: the
// accumulators sum_k W_k s_k (3F columns) and sum_k W_k stay in registers,
// with no atomics and a fixed summation order, so the result is
// deterministic.  Per item the patch's live controls (its valid prefix,
// n_live[k]) are staged through shared memory in slabs of 128: the
// centered coordinates (ctrl - c_k) * valid, the valid flag and the item's
// 3F weight columns, each control's padded to whole float4s.  A tile that
// the patch only grazes (W_k = 0 at every point) skips the item with a
// block-uniform __syncthreads_or.  The epilogue normalizes
// (acc / max(sum W, 1e-30) where sum W > 1e-30, else 0) and writes each
// point straight to the caller's order through perm, which fuses the
// TPU path's un-permute.
//
// What bounds it on this card: compute.  Per live (point, control) pair:
// 3 differences, d2, s, one phi (a log for TPS) and 3F FMAs, against ~12 B
// in and 12F B out per point.  The frames per launch, FB, is a template
// parameter (1, 2, 4, 8 or 16, the smallest that holds the launch's
// frames) because a thread holds 2 x 3FB accumulators (the patch's
// interpolant, then the blended sum); the wrapper loops over chunks of at
// most kMaxFrames.  Squared distances use non-contracted f32 operations
// (the plain twin's rounding); accurate logf/expf/sqrtf, no fast-math.
//
// The forced patch id is compared as an integer (the TPU compares it as
// f32).  Dead items (patch < 0) contribute nothing; an empty tile's no-op
// item has only padded or uncovered-by-it points, whose weight is 0.
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kPuThreads = 256;  // = tile_v: one thread per point of a tile
constexpr int kPuSlab = 128;     // controls staged per slab
constexpr int kMaxFrames = 16;   // largest FB instantiated

struct PuArgs {
  const float* pts;        // (V, 3) caller's order
  const int* perm;         // (V,) Z-order -> caller's index
  const int* forced;       // (n_vt * 256,) forced patch per Z-ordered point, -1 none
  const int* item_patch;   // (T',) patch of each item, sorted by tile
  const int* item_offsets; // (n_vt + 1,) CSR of items by tile
  const float* ctrl;       // (K, P, 3)
  const float* cvalid;     // (K, P)
  const int* n_live;       // (K,) controls past the last valid one are skipped
  const float* w;          // (K, P, 3F) frame f in columns 3f..3f+2
  const float* poly;       // (K, 4, 3F) centered linear tails, absent rows zero
  const float* geom;       // (K, 8) cx, cy, cz, 1/eps^2, 1/R^2, 0, 0, 0
  float* out;              // (F, V, 3) caller's order
  int V, P, F;
  int f0, nf;              // this launch's frames [f0, f0 + nf), 1 <= nf <= FB
};

// Per-control weight stride in shared memory: 3FB rounded up to float4s.
template <int FB>
__host__ __device__ constexpr int stride_of() { return (3 * FB + 3) / 4 * 4; }

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

template <int B, int FB>
__global__ void __launch_bounds__(kPuThreads) pu_kernel(PuArgs a) {
  constexpr int S = stride_of<FB>();
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // [kPuSlab][S] weights
  float* sl = sw + kPuSlab * S;                 // lc.x, lc.y, lc.z, valid: [4][kPuSlab]
  const int vt = blockIdx.x;
  const int i = vt * kPuThreads + threadIdx.x;  // Z-ordered point
  const bool valid = i < a.V;
  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  if (valid) {
    const int src = a.perm[i];
    x0 = a.pts[3 * src]; x1 = a.pts[3 * src + 1]; x2 = a.pts[3 * src + 2];
  }
  const int forced = a.forced[i];
  const int f3 = 3 * a.F, q0 = 3 * a.f0, qn = 3 * a.nf;
  float acc[S];
#pragma unroll
  for (int q = 0; q < S; ++q) acc[q] = 0.0f;
  float wsum = 0.0f;
  const int it_end = a.item_offsets[vt + 1];
  for (int it = a.item_offsets[vt]; it < it_end; ++it) {
    const int k = a.item_patch[it];
    if (k < 0) continue;  // dead item (block-uniform)
    const float* g = a.geom + 8 * (size_t)k;
    const float cx = g[0], cy = g[1], cz = g[2], inv_eps2 = g[3], inv_r2 = g[4];
    const float xl0 = x0 - cx, xl1 = x1 - cy, xl2 = x2 - cz;
    float w = forced == k ? 1.0f : phi_of<WENDLAND_C2>(sq3(xl0, xl1, xl2) * inv_r2);
    w = valid ? w : 0.0f;
    // block-uniform: every thread takes the same branch, barriers stay safe
    if (!__syncthreads_or(w > 0.0f)) continue;
    float d[S];
#pragma unroll
    for (int q = 0; q < S; ++q) d[q] = 0.0f;
    const int n = a.n_live[k];
    for (int base = 0; base < n; base += kPuSlab) {
      const int cnt = min(kPuSlab, n - base);
      __syncthreads();
      for (int idx = threadIdx.x; idx < cnt * S; idx += kPuThreads) {
        const int q = idx % S;
        const int t = idx / S;
        sw[t * S + q] =
            q < qn ? a.w[((size_t)k * a.P + base + t) * f3 + q0 + q] : 0.0f;
      }
      for (int t = threadIdx.x; t < cnt; t += kPuThreads) {
        const size_t j = (size_t)k * a.P + base + t;
        const float cv = a.cvalid[j];
        sl[t] = (a.ctrl[3 * j] - cx) * cv;
        sl[kPuSlab + t] = (a.ctrl[3 * j + 1] - cy) * cv;
        sl[2 * kPuSlab + t] = (a.ctrl[3 * j + 2] - cz) * cv;
        sl[3 * kPuSlab + t] = cv;
      }
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const float dx = sl[j] - xl0;
        const float dy = sl[kPuSlab + j] - xl1;
        const float dz = sl[2 * kPuSlab + j] - xl2;
        const float ph = phi_of<B>(sq3(dx, dy, dz) * inv_eps2) * sl[3 * kPuSlab + j];
        const float4* wq = reinterpret_cast<const float4*>(sw + j * S);
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const float4 v = wq[q];
          d[4 * q] += ph * v.x;
          d[4 * q + 1] += ph * v.y;
          d[4 * q + 2] += ph * v.z;
          d[4 * q + 3] += ph * v.w;
        }
      }
    }
    // centered linear tail [1, xl] per column, then the blend (rounded as
    // the twin rounds them: once per item, not per pair)
    const float* wp = a.poly + (size_t)k * 4 * f3 + q0;
#pragma unroll
    for (int c = 0; c < 3 * FB; ++c) {
      if (c < qn) {
        float s = __fadd_rn(d[c], wp[c]);
        s = __fadd_rn(s, __fmul_rn(wp[f3 + c], xl0));
        s = __fadd_rn(s, __fmul_rn(wp[2 * f3 + c], xl1));
        s = __fadd_rn(s, __fmul_rn(wp[3 * f3 + c], xl2));
        acc[c] = __fadd_rn(acc[c], __fmul_rn(s, w));
      }
    }
    wsum += w;
  }
  if (valid) {
    const int dst = a.perm[i];
    const bool live = wsum > 1e-30f;
    const float den = fmaxf(wsum, 1e-30f);
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      if (f < a.nf) {
        float* o = a.out + ((size_t)(a.f0 + f) * a.V + dst) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) o[c] = live ? acc[3 * f + c] / den : 0.0f;
      }
    }
  }
}

template <int B, int FB>
cudaError_t launch_fb(const PuArgs& a, int n_vt, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kPuSlab * (stride_of<FB>() + 4);
  pu_kernel<B, FB><<<n_vt, kPuThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_pu(const PuArgs& a, int n_vt, cudaStream_t stream) {
  if (a.nf <= 1) return launch_fb<B, 1>(a, n_vt, stream);
  if (a.nf <= 2) return launch_fb<B, 2>(a, n_vt, stream);
  if (a.nf <= 4) return launch_fb<B, 4>(a, n_vt, stream);
  if (a.nf <= 8) return launch_fb<B, 8>(a, n_vt, stream);
  return launch_fb<B, 16>(a, n_vt, stream);
}

}  // namespace

extern "C" int fd_pu_tiles(
    const float* pts, const int* perm, const int* forced, const int* item_patch,
    const int* item_offsets, const float* ctrl, const float* cvalid, const int* n_live,
    const float* w, const float* poly, const float* geom, float* out, int V, int n_vt,
    int K, int P, int F, int f0, int nf, int basis, void* stream) {
  if (nf < 1 || nf > kMaxFrames || f0 < 0 || f0 + nf > F || K < 1 || P < 1 || V < 1 ||
      (long long)n_vt * kPuThreads < V) {
    return cudaErrorInvalidValue;
  }
  PuArgs a;
  a.pts = pts; a.perm = perm; a.forced = forced; a.item_patch = item_patch;
  a.item_offsets = item_offsets; a.ctrl = ctrl; a.cvalid = cvalid; a.n_live = n_live;
  a.w = w; a.poly = poly; a.geom = geom; a.out = out;
  a.V = V; a.P = P; a.F = F; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_pu<GAUSSIAN>(a, n_vt, s);
    case THIN_PLATE: return launch_pu<THIN_PLATE>(a, n_vt, s);
    case MULTIQUADRIC: return launch_pu<MULTIQUADRIC>(a, n_vt, s);
    case INVERSE_MULTIQUADRIC: return launch_pu<INVERSE_MULTIQUADRIC>(a, n_vt, s);
    case LINEAR: return launch_pu<LINEAR>(a, n_vt, s);
    case CUBIC: return launch_pu<CUBIC>(a, n_vt, s);
    case WENDLAND_C2: return launch_pu<WENDLAND_C2>(a, n_vt, s);
    default: return cudaErrorInvalidValue;
  }
}
