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
// What bounds it on this card: issue slots.  Each (vertex, control, layer)
// pair costs about 17 operations (3 differences, d2, s, an exp for the
// gaussian, 3 FMAs) while a vertex moves 36 B of device memory, so at 1k
// controls the kernel is far above the card's f32 balance point; its time
// follows the instructions it issues a pair.  The design therefore spends
// as few as it can besides the arithmetic:
//   * packed control records: each control is laid out once per call as
//     1 + L float4s, (x, y, z, 1/eps_0^2) and per layer l (w_l.xyz,
//     1/eps_{l+1}^2), so a pair reads two 16-byte shared broadcasts a
//     layer (LDS.128), not seven 32-bit ones.  The packing runs on the
//     card too (pack_kernel; for the culled kernel morton_kernel, a sort
//     in the wrapper, then cull_pack_kernel, which also builds the slab
//     and sub-slab tables): one launch in place of a dozen tensor
//     operations, whose host cost would otherwise exceed the eval's;
//   * VT vertices a thread (template parameter; 2, by measurement):
//     each staged record serves VT pairs, and the VT
//     independent chains interleave.  A warp owns 32 VT consecutive
//     vertices, lane + 32 v, so loads and stores coalesce;
//   * the layer count L is a template parameter for L <= 4, so the layer
//     loop and the record stride are compile-time and the control loop is
//     straight-line code unrolled by U controls; a larger L runs the L = 0
//     instantiation, which reads L at run time;
//   * records are staged by cp.async into two shared buffers, one barrier
//     a chunk: the next chunk lands while the block computes this one.
// Each vertex sums its controls in order, layer by layer within a
// control.  The math is accurate
// expf/logf/sqrtf/rsqrtf (no fast-math): the 5e-5 displacement budget is
// the contract.
//
// TPU idioms translated:
//   * the sequential-grid "whole tile inactive" early exit becomes a
//     block-uniform __syncthreads_or(active) (a block with no active vertex
//     writes P and a zero falloff), and inside a live block a warp with no
//     active vertex skips the pair loop (warp-uniform) while still taking
//     part in the staging and the barriers;
//   * the TPU's padding of V and N to tile multiples becomes bounds checks;
//     the growing-kernel centering divides by the real N (any per-vertex
//     constant is exact under sum(w) = 0);
//   * the culled kernel's tile bbox becomes two levels: the block tests
//     the union of its warps' bboxes against each 128-control slab and
//     stages only the slabs that pass, and each warp tests the bbox of its
//     own active vertices (shuffles) against each 32-control sub-slab of a
//     staged slab and skips those past the cutoff.  Slabs stay Morton-
//     sorted 128-control blocks, as in the JAX package.
//
// C ABI, loaded with ctypes; each entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

// Vertices a thread (VT) and controls a step of the pair loop (unroll) of
// the dense and the culled kernel, and the dense kernel's resident blocks
// an SM, chosen by measurement (PERF.md): VT = 2 gives a capture-gated
// frame, whose active third is one wave of blocks, twice the warps of
// VT = 4 at 3% more time all active; a 4-control step is faster in both
// kernels, but the dense one then needs 10 blocks an SM (at most 48
// registers; decaying bases) so that a gated frame's active blocks still
// fit one wave; the culled kernel's 64-vertex warps skip more than
// 128-vertex ones.
constexpr int kDenseVT = 2, kDenseUnroll = 4, kDenseMinBlocks = 10;
constexpr int kCullVT = 2, kCullUnroll = 4;
constexpr int kMaxStaticL = 4;    // L <= 4 compile-time; larger L runs L = 0
// Threads a block, every kernel here: 4 warps, 128 VT vertices (the dense
// kernel timed the same at 8 warps; the culled kernel's work clusters
// where the rig is, and smaller blocks spread it over more SMs).
constexpr int kThreads = 128;
constexpr int kDenseChunk = 256;  // most controls a staged chunk
constexpr int kCullSlab = 128;    // controls a slab (the JAX package's _CULL_BLOCK)
constexpr int kCullSub = 32;      // controls a sub-slab (the warp-level skip)
constexpr unsigned kFull = 0xffffffffu;

// One thread's VT vertices: vertex v is i0 + 32 v.
template <int VT>
struct Verts {
  int i0;
  bool valid[VT];
  float p[VT][3];
  float cap[VT], active[VT];
  float d[VT][3];
};

// Load the thread's vertices of a warp whose first vertex is warp0; true
// when any of them is active.
template <int VT>
__device__ __forceinline__ bool load_verts(const EvalArgs& a, int warp0, Verts<VT>& t) {
  t.i0 = warp0 + (threadIdx.x & 31);
  bool any = false;
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int i = t.i0 + 32 * v;
    t.valid[v] = i < a.V;
    t.p[v][0] = t.p[v][1] = t.p[v][2] = 0.0f;
    if (t.valid[v]) {
      t.p[v][0] = a.pts[3 * i]; t.p[v][1] = a.pts[3 * i + 1]; t.p[v][2] = a.pts[3 * i + 2];
    }
    capture_of(a, i, t.valid[v], t.cap[v], t.active[v]);
    any = any || t.active[v] > 0.0f;
    t.d[v][0] = t.d[v][1] = t.d[v][2] = 0.0f;
  }
  return any;
}

// d += the linear tail, w_poly rows [1, x, y, z].
template <int VT>
__device__ __forceinline__ void add_tail(const EvalArgs& a, Verts<VT>& t) {
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const float* p = t.p[v];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      t.d[v][k] = t.d[v][k] + a.w_poly[k] + a.w_poly[3 + k] * p[0]
                  + a.w_poly[6 + k] * p[1] + a.w_poly[9 + k] * p[2];
    }
  }
}

template <int VT>
__device__ __forceinline__ void finish(const EvalArgs& a, Verts<VT>& t, bool computed) {
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    const int i = t.i0 + 32 * v;
    if (!t.valid[v]) continue;
    if (computed && a.fu != nullptr) project_tangent(a, i, t.d[v]);
    const float w = falloff_of(a, t.cap[v], t.active[v]);
    a.falloff[i] = w;
    for (int k = 0; k < 3; ++k) a.out[3 * i + k] = t.p[v][k] + t.d[v][k] * w;
  }
}

// One layer of one control against the thread's vertices: phi of d2 * ie
// (minus the layer-0 center), times the record's weights w.xyz; returns
// the next layer's 1/eps^2, which rides in w.w.
template <int B, bool CENTER, int VT>
__device__ __forceinline__ float layer_pairs(const float4 w, float ie, bool first,
                                             const float d2[VT], const float center[VT],
                                             Verts<VT>& t) {
#pragma unroll
  for (int v = 0; v < VT; ++v) {
    float ph = phi_of<B>(d2[v] * ie);
    if (CENTER && first) ph -= center[v];
    t.d[v][0] += ph * w.x;
    t.d[v][1] += ph * w.y;
    t.d[v][2] += ph * w.z;
  }
  return w.w;
}

// The pair loop both kernels share: cnt staged controls (1 + L float4
// records each) into t.d, in control order, U controls a step.  CENTER subtracts the
// per-vertex layer-0 mean; n_layers is read only when L = 0.
template <int B, int L, bool CENTER, int VT, int U>
__device__ __forceinline__ void accumulate(const float4* __restrict__ rec, int cnt,
                                           int n_layers, const float center[VT],
                                           Verts<VT>& t) {
  const int R = 1 + (L > 0 ? L : n_layers);
#pragma unroll U
  for (int j = 0; j < cnt; ++j) {
    const float4* r = rec + j * R;
    const float4 c = r[0];
    float d2[VT];
#pragma unroll
    for (int v = 0; v < VT; ++v) {
      const float dx = c.x - t.p[v][0];
      const float dy = c.y - t.p[v][1];
      const float dz = c.z - t.p[v][2];
      d2[v] = dx * dx + dy * dy + dz * dz;
    }
    float ie = c.w;
    if constexpr (L > 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) ie = layer_pairs<B, CENTER, VT>(r[1 + l], ie, l == 0, d2, center, t);
    } else {
      for (int l = 0; l < n_layers; ++l)
        ie = layer_pairs<B, CENTER, VT>(r[1 + l], ie, l == 0, d2, center, t);
    }
  }
}

// Growing kernels' first pass: sum[v] += layer-0 phi over cnt controls.
template <int B, int VT, int U>
__device__ __forceinline__ void center_sum(const float4* __restrict__ rec, int cnt, int R,
                                           const Verts<VT>& t, float sum[VT]) {
#pragma unroll U
  for (int j = 0; j < cnt; ++j) {
    const float4 c = rec[j * R];
#pragma unroll
    for (int v = 0; v < VT; ++v) {
      const float dx = c.x - t.p[v][0];
      const float dy = c.y - t.p[v][1];
      const float dz = c.z - t.p[v][2];
      sum[v] += phi_of<B>((dx * dx + dy * dy + dz * dz) * c.w);
    }
  }
}

__host__ __device__ constexpr bool is_growing(int b) {
  return b == THIN_PLATE || b == MULTIQUADRIC || b == LINEAR || b == CUBIC;
}

// rec: (N, 1 + L) float4 records; chunk controls a staged chunk.  The
// decaying bases are held to kDenseMinBlocks blocks an SM; the growing
// ones, which take the float64 kernel by default, would spill under it.
template <int B, int L, bool CENTER>
__global__ void __launch_bounds__(kThreads, is_growing(B) ? 1 : kDenseMinBlocks)
dense_kernel(EvalArgs a, const float4* __restrict__ rec, int chunk) {
  extern __shared__ float4 srec[];  // [2][chunk * R]
  constexpr int VT = kDenseVT;
  const int R = 1 + (L > 0 ? L : a.L);
  Verts<VT> t;
  const bool any = load_verts(a, (blockIdx.x * kThreads + (threadIdx.x & ~31)) * VT, t);
  // block-uniform: every thread takes the same branch, barriers stay safe
  if (!__syncthreads_or(any)) {
    finish(a, t, false);
    return;
  }
  const bool live = __any_sync(kFull, any);  // warp-uniform
  float center[VT];
#pragma unroll
  for (int v = 0; v < VT; ++v) center[v] = 0.0f;
  const int nchunks = (a.N + chunk - 1) / chunk;
  const int total = (CENTER ? 2 : 1) * nchunks;  // pass 1 (mean), pass 2
  const int buf = chunk * R;
  stage_async(reinterpret_cast<float*>(srec), reinterpret_cast<const float*>(rec),
              4 * min(chunk, a.N) * R);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int ch = it < nchunks ? it : it - nchunks;
    cp_async_wait<0>();
    // chunk it has landed for every thread, and every warp is done with
    // chunk it - 1, whose buffer the next prefetch overwrites
    __syncthreads();
    if (it + 1 < total) {
      const int nx = it + 1 < nchunks ? it + 1 : it + 1 - nchunks;
      stage_async(reinterpret_cast<float*>(srec + ((it + 1) & 1) * buf),
                  reinterpret_cast<const float*>(rec + (size_t)nx * chunk * R),
                  4 * min(chunk, a.N - nx * chunk) * R);
      cp_async_commit();
    }
    if (live) {
      const float4* s = srec + (it & 1) * buf;
      const int cnt = min(chunk, a.N - ch * chunk);
      if (CENTER && it < nchunks) {
        center_sum<B, VT, kDenseUnroll>(s, cnt, R, t, center);
        if (it == nchunks - 1) {
#pragma unroll
          for (int v = 0; v < VT; ++v) center[v] = center[v] / (float)a.N;
        }
      } else {
        accumulate<B, L, CENTER, VT, kDenseUnroll>(s, cnt, a.L, center, t);
      }
    }
  }
  if (live) add_tail(a, t);
  finish(a, t, live);
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Squared gap between the box lo.xyz, hi.xyz and the table row bb (lo.xyz,
// hi.xyz, cutoff^2, 0), within that row's cutoff.
__device__ __forceinline__ bool within(const float lo[3], const float hi[3], const float* bb) {
  const float gx = fmaxf(fmaxf(bb[0] - hi[0], lo[0] - bb[3]), 0.0f);
  const float gy = fmaxf(fmaxf(bb[1] - hi[1], lo[1] - bb[4]), 0.0f);
  const float gz = fmaxf(fmaxf(bb[2] - hi[2], lo[2] - bb[5]), 0.0f);
  return gx * gx + gy * gy + gz * gz <= bb[6];
}

// The first slab at or after b whose bbox the block box reaches, or nb.
__device__ __forceinline__ int next_slab(const float lo[3], const float hi[3],
                                         const float* bbox, int nb, int b) {
  while (b < nb && !within(lo, hi, bbox + 8 * b)) ++b;
  return b;
}

// rec: (NB * 128, 1 + L) float4 records, Morton-sorted and slab-padded;
// bbox: (NB, 8) per 128-control slab, sub: (4 NB, 8) per 32-control
// sub-slab, each lo.xyz, hi.xyz, cutoff^2, 0.  pairs, when not null,
// gains the (vertex slot, control) pairs each warp computes: 32 VT x 32
// for each sub-slab it does not skip.
template <int B, int L>
__global__ void __launch_bounds__(kThreads)
culled_kernel(EvalArgs a, const float4* __restrict__ rec, const float* __restrict__ bbox,
              const float* __restrict__ sub, int nb, unsigned long long* pairs) {
  extern __shared__ float4 srec[];  // [2][kCullSlab * R]
  __shared__ float wbox[kThreads / 32][6];
  __shared__ float tile[6];  // block box: the union of its warps' boxes
  const int R = 1 + (L > 0 ? L : a.L);
  constexpr int VT = kCullVT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Verts<VT> t;
  const bool any = load_verts(a, (blockIdx.x * kThreads + (threadIdx.x & ~31)) * VT, t);
  if (__syncthreads_or(any)) {
    const bool live = __any_sync(kFull, any);  // warp-uniform
    // the box of the warp's active vertices (an inactive vertex's
    // displacement is multiplied by a zero falloff); a warp with none has
    // an empty box, which reaches nothing
    float lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float l = INFINITY, h = -INFINITY;
#pragma unroll
      for (int v = 0; v < VT; ++v) {
        const bool on = t.active[v] > 0.0f;
        l = fminf(l, on ? t.p[v][k] : INFINITY);
        h = fmaxf(h, on ? t.p[v][k] : -INFINITY);
      }
      lo[k] = warp_min(l);
      hi[k] = warp_max(h);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) { wbox[warp][k] = lo[k]; wbox[warp][3 + k] = hi[k]; }
    }
    __syncthreads();
    if (threadIdx.x < 6) {
      const int k = threadIdx.x;
      float v = wbox[0][k];
      for (int w = 1; w < kThreads / 32; ++w)
        v = k < 3 ? fminf(v, wbox[w][k]) : fmaxf(v, wbox[w][k]);
      tile[k] = v;
    }
    __syncthreads();
    const float blo[3] = {tile[0], tile[1], tile[2]};
    const float bhi[3] = {tile[3], tile[4], tile[5]};
    add_tail(a, t);  // start from the linear tail, as the JAX kernel does
    const int buf = kCullSlab * R;
    // the same slabs in every thread: the staging is block-uniform
    int b = next_slab(blo, bhi, bbox, nb, 0);
    if (b < nb) {
      stage_async(reinterpret_cast<float*>(srec),
                  reinterpret_cast<const float*>(rec + (size_t)b * buf), 4 * buf);
      cp_async_commit();
    }
    for (int slot = 0; b < nb; slot ^= 1) {
      const int nx = next_slab(blo, bhi, bbox, nb, b + 1);
      cp_async_wait<0>();
      __syncthreads();  // slab b landed; every warp is done with the other buffer
      if (nx < nb) {
        stage_async(reinterpret_cast<float*>(srec + (slot ^ 1) * buf),
                    reinterpret_cast<const float*>(rec + (size_t)nx * buf), 4 * buf);
        cp_async_commit();
      }
      if (live) {
        const float4* s = srec + slot * buf;
#pragma unroll 1
        for (int q = 0; q < kCullSlab / kCullSub; ++q) {
          // same box and row in every lane: warp-uniform, no barrier inside
          if (within(lo, hi, sub + 8 * (b * (kCullSlab / kCullSub) + q))) {
            if (pairs != nullptr && lane == 0) atomicAdd(pairs, 32ull * VT * kCullSub);
            const float none[VT] = {};
            accumulate<B, L, false, VT, kCullUnroll>(s + q * kCullSub * R, kCullSub, a.L,
                                                     none, t);
          }
        }
      }
      b = nx;
    }
    finish(a, t, live);
  } else {
    finish(a, t, false);
  }
}

// ---- per-call packing: the control records and the culled tables ------

// 1/eps^2 as the plain twin forms it: 1 / max(eps * eps, 1e-30), each
// step rounded (the tables must equal its, bit for bit).
__device__ __forceinline__ float inv_eps2_of(float e) {
  return __fdiv_rn(1.0f, fmaxf(__fmul_rn(e, e), 1e-30f));
}

// Control r's records from source row src (layer-major w_rbf (L, N, 3),
// eps (L, N)); a padding row (valid false) keeps the coordinates, zeroes
// the weights and takes 1/eps^2 = 1, as the JAX package pads.  Returns
// max eps over the layers (1e-6 for padding), the row's cutoff radius.
__device__ __forceinline__ float write_records(const float* ctrl, const float* w_rbf,
                                               const float* eps, int N, int L, int src,
                                               bool valid, float4* o) {
  float emax = valid ? eps[src] : 1e-6f;
  o[0] = make_float4(ctrl[3 * src], ctrl[3 * src + 1], ctrl[3 * src + 2],
                     valid ? inv_eps2_of(eps[src]) : 1.0f);
  for (int l = 0; l < L; ++l) {
    float nxt = 0.0f;  // 1/eps^2 of layer l + 1, none after the last
    if (l + 1 < L) {
      const float e = eps[(size_t)(l + 1) * N + src];
      nxt = valid ? inv_eps2_of(e) : 1.0f;
      emax = valid ? fmaxf(emax, e) : emax;
    }
    const float* w = w_rbf + 3 * ((size_t)l * N + src);
    o[1 + l] = valid ? make_float4(w[0], w[1], w[2], nxt) : make_float4(0.0f, 0.0f, 0.0f, nxt);
  }
  return emax;
}

// The tail zero-padded to 4 rows: wp[0..12) from w_poly (m, 3).
__device__ __forceinline__ void write_tail(const float* w_poly, int m, float* wp) {
  const int k = threadIdx.x;
  if (blockIdx.x == 0 && k < 12) wp[k] = k < 3 * m ? w_poly[k] : 0.0f;
}

// Records (N, 1 + L) of the controls in model order, and the tail.
__global__ void __launch_bounds__(kThreads)
pack_kernel(const float* ctrl, const float* w_rbf, const float* eps, const float* w_poly,
            int m, int N, int L, float4* rec, float* wp) {
  write_tail(w_poly, m, wp);
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j < N) write_records(ctrl, w_rbf, eps, N, L, j, true, rec + (size_t)j * (1 + L));
}

// 30-bit Morton codes of the controls in their bbox, as ops/morton.py
// computes them (one block: the bbox is a block reduction).
__device__ __forceinline__ long long expand_bits10(long long x) {
  x &= 0x3FF;
  x = (x | (x << 16)) & 0x030000FF;
  x = (x | (x << 8)) & 0x0300F00F;
  x = (x | (x << 4)) & 0x030C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

constexpr int kMortonThreads = 1024;

__global__ void __launch_bounds__(kMortonThreads)
morton_kernel(const float* ctrl, int N, long long* codes) {
  __shared__ float red[6][kMortonThreads / 32];
  __shared__ float box[6];
  float lo[3] = {INFINITY, INFINITY, INFINITY}, hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = threadIdx.x; j < N; j += kMortonThreads) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = fminf(lo[k], ctrl[3 * j + k]);
      hi[k] = fmaxf(hi[k], ctrl[3 * j + k]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 3; ++k) {
    lo[k] = warp_min(lo[k]);
    hi[k] = warp_max(hi[k]);
    if (lane == 0) { red[k][warp] = lo[k]; red[3 + k][warp] = hi[k]; }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int k = threadIdx.x;
    float v = red[k][0];
    for (int w = 1; w < kMortonThreads / 32; ++w)
      v = k < 3 ? fminf(v, red[k][w]) : fmaxf(v, red[k][w]);
    box[k] = v;
  }
  __syncthreads();
  float scale[3];
  for (int k = 0; k < 3; ++k) {
    // a true division, as the twin: 1023 / span, not 1023 * (1 / span)
    scale[k] = __fdiv_rn(1023.0f, fmaxf(__fsub_rn(box[3 + k], box[k]), 1e-12f));
  }
  for (int j = threadIdx.x; j < N; j += kMortonThreads) {
    long long code = 0;
    for (int k = 0; k < 3; ++k) {
      const float q = fminf(fmaxf(__fmul_rn(__fsub_rn(ctrl[3 * j + k], box[k]), scale[k]), 0.0f),
                            1023.0f);
      code |= expand_bits10((long long)q) << k;
    }
    codes[j] = code;
  }
}

// One block a 128-control slab of the Morton order `order`: the slab's
// records (padded past N with the last control, zero weight), the bbox row
// of each 32-control sub-slab (one warp each) and of the slab, lo.xyz,
// hi.xyz, cutoff^2 = (max eps)^2 s_cut, 0; block 0 also writes the tail.
__global__ void __launch_bounds__(kCullSlab)
cull_pack_kernel(const float* ctrl, const float* w_rbf, const float* eps, const float* w_poly,
                 const long long* order, int m, int N, int L, float s_cut, float4* rec,
                 float* bbox, float* sub, float* wp) {
  __shared__ float wrow[kCullSlab / kCullSub][7];
  write_tail(w_poly, m, wp);
  const int r = blockIdx.x * kCullSlab + threadIdx.x;
  const bool valid = r < N;
  const int src = (int)order[valid ? r : N - 1];
  float e = write_records(ctrl, w_rbf, eps, N, L, src, valid, rec + (size_t)r * (1 + L));
  float lo[3], hi[3];
  for (int k = 0; k < 3; ++k) lo[k] = hi[k] = ctrl[3 * src + k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 3; ++k) { lo[k] = warp_min(lo[k]); hi[k] = warp_max(hi[k]); }
  e = warp_max(e);
  if (lane == 0) {
    float* row = sub + 8 * ((size_t)blockIdx.x * (kCullSlab / kCullSub) + warp);
    for (int k = 0; k < 3; ++k) {
      row[k] = wrow[warp][k] = lo[k];
      row[3 + k] = wrow[warp][3 + k] = hi[k];
    }
    row[6] = __fmul_rn(__fmul_rn(e, e), s_cut);
    row[7] = 0.0f;
    wrow[warp][6] = e;
  }
  __syncthreads();
  if (threadIdx.x < 7) {
    const int k = threadIdx.x;
    float v = wrow[0][k];
    for (int w = 1; w < kCullSlab / kCullSub; ++w)
      v = k < 3 ? fminf(v, wrow[w][k]) : fmaxf(v, wrow[w][k]);
    bbox[8 * (size_t)blockIdx.x + k] = k < 6 ? v : __fmul_rn(__fmul_rn(v, v), s_cut);
    if (k == 6) bbox[8 * (size_t)blockIdx.x + 7] = 0.0f;
  }
}

template <int B, int L>
cudaError_t launch_dense(const EvalArgs& a, const float4* rec, int center, cudaStream_t s) {
  const int per = 2 * (1 + a.L) * 4;  // floats a control, two buffers
  const int chunk = kStaticSmemFloats / per < kDenseChunk ? kStaticSmemFloats / per
                                                        : kDenseChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * per * chunk;
  const int grid = (a.V + kThreads * kDenseVT - 1) / (kThreads * kDenseVT);
  if constexpr (is_growing(B)) {
    if (center) {
      dense_kernel<B, L, true><<<grid, kThreads, smem, s>>>(a, rec, chunk);
      return cudaGetLastError();
    }
  } else {
    if (center) return cudaErrorInvalidValue;  // centering is for growing kernels only
  }
  dense_kernel<B, L, false><<<grid, kThreads, smem, s>>>(a, rec, chunk);
  return cudaGetLastError();
}

template <int B, int L>
cudaError_t launch_culled(const EvalArgs& a, const float4* rec, const float* bbox,
                          const float* sub, int nb, unsigned long long* pairs,
                          cudaStream_t s) {
  const size_t smem = sizeof(float4) * 2 * kCullSlab * (1 + a.L);
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t e = cudaFuncSetAttribute(
        culled_kernel<B, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int grid = (a.V + kThreads * kCullVT - 1) / (kThreads * kCullVT);
  culled_kernel<B, L><<<grid, kThreads, smem, s>>>(a, rec, bbox, sub, nb, pairs);
  return cudaGetLastError();
}

template <int B>
cudaError_t dense_of(const EvalArgs& a, const float4* rec, int center, cudaStream_t s) {
  static_assert(kMaxStaticL == 4, "the switch instantiates L = 1..4");
  switch (a.L) {
    case 1: return launch_dense<B, 1>(a, rec, center, s);
    case 2: return launch_dense<B, 2>(a, rec, center, s);
    case 3: return launch_dense<B, 3>(a, rec, center, s);
    case 4: return launch_dense<B, 4>(a, rec, center, s);
    default: return launch_dense<B, 0>(a, rec, center, s);
  }
}

template <int B>
cudaError_t culled_of(const EvalArgs& a, const float4* rec, const float* bbox,
                      const float* sub, int nb, unsigned long long* pairs, cudaStream_t s) {
  switch (a.L) {
    case 1: return launch_culled<B, 1>(a, rec, bbox, sub, nb, pairs, s);
    case 2: return launch_culled<B, 2>(a, rec, bbox, sub, nb, pairs, s);
    case 3: return launch_culled<B, 3>(a, rec, bbox, sub, nb, pairs, s);
    case 4: return launch_culled<B, 4>(a, rec, bbox, sub, nb, pairs, s);
    default: return launch_culled<B, 0>(a, rec, bbox, sub, nb, pairs, s);
  }
}

EvalArgs make_args(const float* pts, const float* dist2, const float* gate,
                   const float* w_poly, const float* fu, const float* fv,
                   const float* fn, float* out, float* falloff, int V, int N,
                   int L, int strict_parity, float r2, float rate) {
  EvalArgs a{};
  a.pts = pts; a.dist2 = dist2; a.gate = gate; a.w_poly = w_poly;
  a.fu = fu; a.fv = fv; a.fn = fn; a.out = out; a.falloff = falloff;
  a.V = V; a.N = N; a.L = L; a.strict_parity = strict_parity;
  a.r2 = r2; a.rate = rate;
  return a;
}

}  // namespace

// rec: (N, 1 + L, 4) packed control records (ops/cuda_eval.pack_records).
extern "C" int fd_eval_dense(
    const float* pts, const float* dist2, const float* gate, const float* rec,
    const float* w_poly, const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, int V, int N, int L, int basis, int strict_parity,
    int center, float r2, float rate, void* stream) {
  if (V < 1 || N < 1 || L < 1) return cudaErrorInvalidValue;
  const EvalArgs a = make_args(pts, dist2, gate, w_poly, fu, fv, fn, out, falloff,
                               V, N, L, strict_parity, r2, rate);
  const float4* r = reinterpret_cast<const float4*>(rec);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return dense_of<GAUSSIAN>(a, r, center, s);
    case THIN_PLATE: return dense_of<THIN_PLATE>(a, r, center, s);
    case MULTIQUADRIC: return dense_of<MULTIQUADRIC>(a, r, center, s);
    case INVERSE_MULTIQUADRIC: return dense_of<INVERSE_MULTIQUADRIC>(a, r, center, s);
    case LINEAR: return dense_of<LINEAR>(a, r, center, s);
    case CUBIC: return dense_of<CUBIC>(a, r, center, s);
    case WENDLAND_C2: return dense_of<WENDLAND_C2>(a, r, center, s);
    default: return cudaErrorInvalidValue;
  }
}

// rec: (n_slabs * 128, 1 + L, 4) Morton-sorted records; bbox (n_slabs, 8),
// sub (4 n_slabs, 8) (ops/cuda_eval.culled_tables); pairs: null, or one
// int64 that gains the pairs the kernel computes.
extern "C" int fd_eval_culled(
    const float* pts, const float* dist2, const float* gate, const float* rec,
    const float* w_poly, const float* fu, const float* fv, const float* fn,
    const float* bbox, const float* sub, float* out, float* falloff, void* pairs, int V,
    int n_slabs, int L, int basis, int strict_parity, float r2, float rate,
    void* stream) {
  if (V < 1 || n_slabs < 1 || L < 1) return cudaErrorInvalidValue;
  const EvalArgs a = make_args(pts, dist2, gate, w_poly, fu, fv, fn, out, falloff, V,
                               n_slabs * kCullSlab, L, strict_parity, r2, rate);
  const float4* r = reinterpret_cast<const float4*>(rec);
  auto* n = static_cast<unsigned long long*>(pairs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return culled_of<GAUSSIAN>(a, r, bbox, sub, n_slabs, n, s);
    case WENDLAND_C2: return culled_of<WENDLAND_C2>(a, r, bbox, sub, n_slabs, n, s);
    default: return cudaErrorInvalidValue;
  }
}

// The culled kernel's geometry, geom[0..4): vertices a block, vertices a
// warp, controls a slab, controls a sub-slab.
extern "C" int fd_cull_geometry(int* geom) {
  geom[0] = kThreads * kCullVT;
  geom[1] = 32 * kCullVT;
  geom[2] = kCullSlab;
  geom[3] = kCullSub;
  return 0;
}

// rec (N, 1 + L, 4) and wp (4, 3) from the model's ctrl (N, 3), w_rbf
// (L, N, 3), eps (L, N) and w_poly (m, 3) (ops/cuda_eval.control_records).
extern "C" int fd_pack_records(const float* ctrl, const float* w_rbf, const float* eps,
                               const float* w_poly, float* rec, float* wp, int m, int N,
                               int L, void* stream) {
  if (N < 1 || L < 1 || m < 0 || m > 4) return cudaErrorInvalidValue;
  pack_kernel<<<(N + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ctrl, w_rbf, eps, w_poly, m, N, L, reinterpret_cast<float4*>(rec), wp);
  return cudaGetLastError();
}

// codes (N,) int64: Morton codes of ctrl (N, 3) (ops/cuda_eval.culled_tables).
extern "C" int fd_morton(const float* ctrl, void* codes, int N, void* stream) {
  if (N < 1) return cudaErrorInvalidValue;
  morton_kernel<<<1, kMortonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ctrl, N, static_cast<long long*>(codes));
  return cudaGetLastError();
}

// The culled kernel's inputs in the Morton order `order` (N,) int64: rec
// (n_slabs * 128, 1 + L, 4), bbox (n_slabs, 8), sub (4 n_slabs, 8), wp
// (4, 3) (ops/cuda_eval.culled_tables).
extern "C" int fd_cull_pack(const float* ctrl, const float* w_rbf, const float* eps,
                            const float* w_poly, const void* order, float* rec, float* bbox,
                            float* sub, float* wp, int m, int N, int L, int n_slabs,
                            float s_cut, void* stream) {
  if (N < 1 || L < 1 || m < 0 || m > 4 || n_slabs * kCullSlab < N) return cudaErrorInvalidValue;
  cull_pack_kernel<<<n_slabs, kCullSlab, 0, static_cast<cudaStream_t>(stream)>>>(
      ctrl, w_rbf, eps, w_poly, static_cast<const long long*>(order), m, N, L, s_cut,
      reinterpret_cast<float4*>(rec), bbox, sub, wp);
  return cudaGetLastError();
}
