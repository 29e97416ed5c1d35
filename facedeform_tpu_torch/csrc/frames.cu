// All-frames fused RBF deform step for Hopper (sm_90a): the frames eval
// kernel of facedeform_tpu_torch/ops/cuda_eval.py (evaluate_cuda_frames),
// and the kernel that packs its operands on the card.
//
// Replaces (TPU): facedeform_tpu/ops/pallas_eval.py, _eval_frames_kernel
// (evaluate_pallas_frames).
//
// An animated shot shares the controls and radii across its F poses (the
// rest rig is fixed), so per vertex the squared distance and phi of each
// (control, layer) pair are computed once and contracted against every
// frame's weights: columns 3f + k of the frames-packed (L, N, 3F) weights.
// The TPU kernel runs that contraction as one Precision.HIGHEST dot on its
// matrix unit; here it runs on the tensor cores, as the PU and Jacobian
// kernels' do (pu.cu, jacobian.cu):
//   * a warp owns 16 kFramesMT consecutive vertices, kFramesMT m16 row
//     tiles that share each B fragment.  Per k-step of 8 controls and per
//     layer a lane computes phi at its A-fragment positions (rows g + 8 r,
//     columns t and t + 4: 2 x 2 kFramesMT pairs, independent chains),
//     minus the per-vertex layer-0 mean for the growing bases, splits each
//     into tf32 words and the warp runs 3xTF32 mma.sync (common.cuh)
//     against NT n8 tiles of weight columns: a launch's 3nf columns padded
//     to 8 NT.  NT is a template parameter the wrapper picks (FramesTiles:
//     1, 2, 3, 4, 6, 7, 8 or 12, up to 32 frames a launch); a longer shot
//     takes the fewest launches of balanced size.  One or two frames take
//     the same route: on the CUDA cores (a lane summing its own vertex's
//     controls in order) they ran slower (PERF.md);
//   * each k-step's three passes go into a fresh C fragment added to the
//     f32 accumulator, and the k order is fixed, so a column depends only
//     on its own A row and B column: frame f of a shot comes out bit for
//     bit the same whichever launch, and whichever other frames, it shares;
//   * the layer count is a template parameter for the decaying bases at
//     L = 1 (the slice's path), read at run time otherwise; up to 4 n8
//     tiles the pair loop runs two k-steps a pass (unroll_of), so one
//     k-step's mma overlaps the next one's phi;
//   * the operands stream through shared memory per k-step, cp.async,
//     double-buffered slabs of up to kFramesSlabSteps k-steps (the
//     dynamic-shared-memory opt-in past 48 KB): 8 control records (x, y,
//     z, 1/eps_0^2), the 1/eps^2 of layers 1 .. L - 1, then per layer the
//     weight columns pre-split in fragment order (ops/tf32.mma_fragments).
//     frames_pack_kernel builds that stream and the launch's tails on the
//     card, in one launch, equal bit for bit to the plain twin
//     (ops/cuda_eval.frames_stream_reference);
//   * the epilogue gathers each warp's C fragments through a shared tile
//     (a frame's three components lie on two lanes of a quad and maybe two
//     n-tiles), then one vertex a lane: the linear tail, the oblique tangent
//     projection with its axes computed once per vertex, p + d w into
//     (F, V, 3), in the old kernel's operation order; the falloff once per
//     vertex.
//
// What bounds it on this card: per (vertex, control, layer) pair d2, s, one
// phi (an exp for the gaussian) and the split on the CUDA cores (~22
// instructions a pair at L = 1), and 3 passes x 2 x 8 NT operations a pair
// on the tensor cores, where mma.sync runs m16n8k8 TF32 at about half the
// card's dense TF32 rate (PERF.md); against 12 B in and 12F B out per
// vertex.  The two pipes overlap only in part.  Accurate expf/logf/sqrtf,
// no fast-math; the split's subtraction exact.
//
// TPU idioms translated as in eval.cu: the "whole tile inactive" exit is a
// block-uniform __syncthreads_or(active), and a warp none of whose
// vertices is active skips the pair loop (warp-uniform) but keeps staging
// and the barriers; padding of V and N becomes bounds checks and zero
// weights; the growing-kernel centering divides by the real N and skips
// the padding controls.
//
// C ABI, loaded with ctypes; each entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

// m16 row tiles a warp (vertices a warp: 16 kFramesMT), threads a block and
// k-steps a staged slab at most, chosen by measurement (PERF.md).
constexpr int kFramesMT = 2;
constexpr int kFramesThreads = 256;
constexpr int kFramesSlabSteps = 8;
constexpr int kFramesStageFloats = 12288;  // a staging buffer holds up to 48 KB
constexpr int kMaxSmemBytes = 232448;      // 227 KB, the opt-in limit
constexpr int kMaxFrames = 32;             // frames a launch: 12 n8 tiles
constexpr int kPackThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Floats a staged k-step: 8 records of 4, 8 (L - 1) 1/eps^2, then L x NT
// fragment blocks of 32 lanes x 4.
__host__ __device__ constexpr int step_floats(int nt, int n_layers) {
  return 24 + 8 * n_layers + 128 * nt * n_layers;
}

struct FramesArgs {
  EvalArgs e;            // w_poly: (4, 8 NT) this launch's tails; w_rbf unused
  const float* stream;   // (T, step_floats) per k-step of 8 controls
  int T;                 // k-steps, ceil(N / 8)
  int f0, nf;            // this launch's frames [f0, f0 + nf) of out (F, V, 3)
};

// k-steps a pass of the pair loop: two up to 4 n8 tiles (one k-step's mma
// overlaps the next one's phi), one past that, where the registers run
// out; blocks an SM: two (128 registers) up to 8 n8 tiles.  Both by
// measurement (PERF.md).
__host__ __device__ constexpr int unroll_of(int nt) { return nt <= 4 ? 2 : 1; }
__host__ __device__ constexpr int min_blocks_of(int nt) { return nt <= 8 ? 2 : 1; }

// Per-warp epilogue tile stride: the launch's columns plus one (odd, so a
// lane reading its own row meets no bank conflict).
__host__ __device__ constexpr int tile_stride(int nt) { return 8 * nt + 1; }

// L > 0: the layer count at compile time; L = 0 reads it at run time.
template <int B, bool CENTER, int NT, int L>
__global__ void __launch_bounds__(kFramesThreads, min_blocks_of(NT))
frames_kernel(FramesArgs a, int chunk) {
  constexpr int MT = kFramesMT;
  constexpr int R = 2 * MT;              // rows a lane holds: g + 8 r
  const EvalArgs& e = a.e;
  const int n_layers = L > 0 ? L : e.L;
  const int sf = step_floats(NT, n_layers);
  const int slab = chunk * sf;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [2][slab], then the epilogue tiles
  const int lane = threadIdx.x & 31, tq = lane & 3, warp = threadIdx.x >> 5;
  const int base = (blockIdx.x * (kFramesThreads / 32) + warp) * 16 * MT;
  const int own = tq % R;                // the row whose layer-0 mean the lane sums
  float p[R][3], po[3] = {0.0f, 0.0f, 0.0f};
  bool any = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = base + (lane >> 2) + 8 * r;
    const bool valid = i < e.V;
    p[r][0] = p[r][1] = p[r][2] = 0.0f;
    if (valid) { p[r][0] = e.pts[3 * i]; p[r][1] = e.pts[3 * i + 1]; p[r][2] = e.pts[3 * i + 2]; }
    float cap, active;
    capture_of(e, i, valid, cap, active);
    any = any || active > 0.0f;
    if (r == own) { po[0] = p[r][0]; po[1] = p[r][1]; po[2] = p[r][2]; }
  }
  float acc[4 * MT * NT];  // C fragments [m-tile][n-tile][4]
#pragma unroll
  for (int q = 0; q < 4 * MT * NT; ++q) acc[q] = 0.0f;
  // block-uniform: every thread takes the same branch, barriers stay safe
  const bool live_block = __syncthreads_or(any);
  const bool live = live_block && __any_sync(kFull, any);  // warp-uniform
  if (live_block) {
    float center[R], center_own = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) center[r] = 0.0f;
    const int nslab = (a.T + chunk - 1) / chunk;
    const int total = (CENTER ? 2 : 1) * nslab;  // pass 1 (mean), pass 2
    stage_async(buf, a.stream, min(a.T, chunk) * sf);
    cp_async_commit();
    for (int it = 0; it < total; ++it) {
      const int s = it < nslab ? it : it - nslab;
      cp_async_wait<0>();
      // slab it has landed for every thread, and every warp is done with
      // slab it - 1, whose buffer the next prefetch overwrites
      __syncthreads();
      if (it + 1 < total) {
        const int nx = (it + 1 < nslab ? it + 1 : it + 1 - nslab) * chunk;
        stage_async(buf + ((it + 1) & 1) * slab, a.stream + (size_t)nx * sf,
                    min(a.T - nx, chunk) * sf);
        cp_async_commit();
      }
      if (!live) continue;
      const float* sb = buf + (it & 1) * slab;
      const int cnt = min(a.T - s * chunk, chunk);
      if (CENTER && it < nslab) {
        // pass 1: the lane's own row sums layer-0 phi over the real
        // controls in order (the dense kernel's order), then every lane
        // takes its rows' means from their owners
        float sum = center_own;
        for (int t = 0; t < cnt; ++t) {
          const float4* rec = reinterpret_cast<const float4*>(sb + t * sf);
          const int j0 = (s * chunk + t) * 8;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 c = rec[j];
            const float dx = c.x - po[0];
            const float dy = c.y - po[1];
            const float dz = c.z - po[2];
            const float ph = phi_of<B>((dx * dx + dy * dy + dz * dz) * c.w);
            sum = j0 + j < e.N ? sum + ph : sum;
          }
        }
        center_own = sum;
        if (it == nslab - 1) {
          center_own = center_own / (float)e.N;
#pragma unroll
          for (int r = 0; r < R; ++r) center[r] = __shfl_sync(kFull, center_own, (lane & ~3) | r);
        }
        continue;
      }
#pragma unroll (unroll_of(NT))
      for (int t = 0; t < cnt; ++t) {
        const float* st = sb + t * sf;
        const float4 c0 = reinterpret_cast<const float4*>(st)[tq];      // column tq
        const float4 c1 = reinterpret_cast<const float4*>(st)[tq + 4];  // column tq + 4
        float d2[R][2];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float dx0 = c0.x - p[r][0], dy0 = c0.y - p[r][1], dz0 = c0.z - p[r][2];
          const float dx1 = c1.x - p[r][0], dy1 = c1.y - p[r][1], dz1 = c1.z - p[r][2];
          d2[r][0] = dx0 * dx0 + dy0 * dy0 + dz0 * dz0;
          d2[r][1] = dx1 * dx1 + dy1 * dy1 + dz1 * dz1;
        }
        const float4* frag = reinterpret_cast<const float4*>(st + 24 + 8 * n_layers) + lane;
#pragma unroll (L > 0 ? L : 1)
        for (int l = 0; l < n_layers; ++l) {
          const float ie0 = l == 0 ? c0.w : st[24 + 8 * l + tq];
          const float ie1 = l == 0 ? c1.w : st[28 + 8 * l + tq];
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            float q0 = phi_of<B>(d2[r][0] * ie0);
            float q1 = phi_of<B>(d2[r][1] * ie1);
            if (CENTER && l == 0) { q0 -= center[r]; q1 -= center[r]; }
            split_tf32(q0, ah[r >> 1][r & 1], al[r >> 1][r & 1]);
            split_tf32(q1, ah[r >> 1][2 + (r & 1)], al[r >> 1][2 + (r & 1)]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float4 b = frag[(l * NT + nt) * 32];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc + 4 * (mt * NT + nt), ah[mt], al[mt], b);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the staging buffers
  }
  // epilogue: the warp's C fragments through its tile, then vertex base +
  // lane of the warp
  float* tile = buf + warp * 16 * MT * tile_stride(NT);
  if (live) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 16 * mt + (lane >> 2) + 8 * (q >> 1);
          tile[row * tile_stride(NT) + 8 * nt + 2 * tq + (q & 1)] = acc[4 * (mt * NT + nt) + q];
        }
    __syncwarp();
  }
  const int i = base + lane;
  if (lane < 16 * MT && i < e.V) {
    const float pi[3] = {e.pts[3 * i], e.pts[3 * i + 1], e.pts[3 * i + 2]};
    float cap, active;
    capture_of(e, i, true, cap, active);
    const float w = falloff_of(e, cap, active);
    e.falloff[i] = w;
    float a1[3], a2[3];
    const bool project = live && e.fu != nullptr;
    if (project) tangent_axes(e, i, a1, a2);  // once per vertex, not per frame
    const float* row = tile + lane * tile_stride(NT);
    for (int f = 0; f < a.nf; ++f) {
      float d[3] = {0.0f, 0.0f, 0.0f};
      if (live) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          // the linear tail, w_poly rows [1, x, y, z]
          const float* wp = e.w_poly + 3 * f + k;
          d[k] = row[3 * f + k] + wp[0] + wp[8 * NT] * pi[0] + wp[16 * NT] * pi[1]
                 + wp[24 * NT] * pi[2];
        }
        if (project) project3(d, a1, a2);
      }
      float* o = e.out + ((size_t)(a.f0 + f) * e.V + i) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = pi[k] + d[k] * w;
    }
  }
}

__host__ __device__ constexpr bool is_growing(int b) {
  return b == THIN_PLATE || b == MULTIQUADRIC || b == LINEAR || b == CUBIC;
}

template <int B, bool CENTER, int NT, int L>
cudaError_t launch_kernel(const FramesArgs& a, cudaStream_t stream) {
  const int sf = step_floats(NT, a.e.L);
  int chunk = kFramesStageFloats / sf;
  if (chunk > kFramesSlabSteps) chunk = kFramesSlabSteps;
  if (chunk < 1) chunk = 1;
  const int tile = (kFramesThreads / 32) * 16 * kFramesMT * tile_stride(NT);
  const size_t smem = sizeof(float) * (2 * chunk * sf > tile ? 2 * chunk * sf : tile);
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;  // too many layers
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t err = cudaFuncSetAttribute(frames_kernel<B, CENTER, NT, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int per_block = (kFramesThreads / 32) * 16 * kFramesMT;
  const int grid = (a.e.V + per_block - 1) / per_block;
  frames_kernel<B, CENTER, NT, L><<<grid, kFramesThreads, smem, stream>>>(a, chunk);
  return cudaGetLastError();
}

template <int B, int NT>
cudaError_t launch_nt(const FramesArgs& a, int center, cudaStream_t stream) {
  if constexpr (is_growing(B)) {
    // no path of the slice runs them here (a shot's growing bases take the
    // float64 kernel, precise.cu): the layer count at run time only
    return center ? launch_kernel<B, true, NT, 0>(a, stream)
                  : launch_kernel<B, false, NT, 0>(a, stream);
  } else {
    if (center) return cudaErrorInvalidValue;  // centering is for growing kernels only
    return a.e.L == 1 ? launch_kernel<B, false, NT, 1>(a, stream)
                      : launch_kernel<B, false, NT, 0>(a, stream);
  }
}

// The n8 tile counts NT the kernel is instantiated for: the wrapper picks
// the fewest that hold a launch's 3 nf columns (ops/cuda_eval.FRAMES_TILES,
// checked against fd_frames_geometry when the library loads).  7 keeps 17
// frames (51 columns) at two blocks an SM.
template <int... NTs>
struct Tiles {
  static constexpr int count = sizeof...(NTs);
  static constexpr int values[count] = {NTs...};
  template <int B>
  static cudaError_t launch(const FramesArgs& a, int nt, int center, cudaStream_t stream) {
    cudaError_t err = cudaErrorInvalidValue;  // an NT not in the set
    ((nt == NTs && (err = launch_nt<B, NTs>(a, center, stream), true)) || ...);
    return err;
  }
};
using FramesTiles = Tiles<1, 2, 3, 4, 6, 7, 8, 12>;
static_assert(3 * kMaxFrames <= 8 * FramesTiles::values[FramesTiles::count - 1],
              "the largest NT must hold kMaxFrames frames");

__device__ __forceinline__ float inv_eps2_of(float e) {
  return __fdiv_rn(1.0f, fmaxf(__fmul_rn(e, e), 1e-30f));
}

// One thread an output float: the launch's stream (T, step_floats) and its
// tails (4, 8 NT), from the model's ctrl (N, 3), w_rbf (F, L, N, 3), eps
// (L, N) and w_poly (F, m, 3).  Padding controls take (0, 0, 0) and
// 1/eps^2 = 1 (a finite phi) with zero weights; padding columns zero.
__global__ void __launch_bounds__(kPackThreads)
frames_pack_kernel(const float* ctrl, const float* w_rbf, const float* eps,
                   const float* w_poly, int m, int N, int L, int f0, int nf, int nt, int T,
                   float* stream, float* poly) {
  const int sf = step_floats(nt, L);
  const long long n_stream = (long long)T * sf;
  const long long idx = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  const int qn = 3 * nf;
  if (idx >= n_stream) {
    const long long r = idx - n_stream;  // a tail entry (row, column)
    if (r >= 32 * nt) return;
    const int row = (int)(r / (8 * nt)), col = (int)(r % (8 * nt));
    poly[r] = row < m && col < qn ? w_poly[((size_t)(f0 + col / 3) * m + row) * 3 + col % 3] : 0.0f;
    return;
  }
  const int t = (int)(idx / sf), q = (int)(idx % sf);
  float v;
  if (q < 32) {  // record (x, y, z, 1/eps_0^2) of control 8 t + q / 4
    const int j = 8 * t + (q >> 2), k = q & 3;
    v = j < N ? (k < 3 ? ctrl[3 * j + k] : inv_eps2_of(eps[j])) : (k < 3 ? 0.0f : 1.0f);
  } else if (q < 24 + 8 * L) {  // 1/eps^2 of layer 1 + (q - 32) / 8
    const int l = 1 + ((q - 32) >> 3), j = 8 * t + ((q - 32) & 7);
    v = j < N ? inv_eps2_of(eps[(size_t)l * N + j]) : 1.0f;
  } else {  // fragment word: lane 4 g + tt, word w -> B[tt + 4 (w & 1)][8 n + g], layer l
    const int r = q - (24 + 8 * L);
    const int l = r / (128 * nt), r2 = r % (128 * nt);
    const int lane = (r2 & 127) >> 2, w = r2 & 3;
    const int j = 8 * t + (lane & 3) + 4 * (w & 1), col = 8 * (r2 >> 7) + (lane >> 2);
    const float x = j < N && col < qn
        ? w_rbf[(((size_t)(f0 + col / 3) * L + l) * N + j) * 3 + col % 3] : 0.0f;
    const uint32_t hi = tf32_rna(x);
    v = __uint_as_float(w >= 2 ? tf32_rna(__fsub_rn(x, __uint_as_float(hi))) : hi);
  }
  stream[idx] = v;
}

}  // namespace

// stream_t: (T, step floats) per k-step of 8 controls and poly: (4, 8 nt)
// hold this launch's frames [f0, f0 + nf) in nt n8 tiles (ops/cuda_eval.py,
// frames_stream).
extern "C" int fd_eval_frames(
    const float* pts, const float* dist2, const float* gate, const float* stream_t,
    const float* poly, const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, int V, int N, int L, int T, int F, int f0, int nf, int nt, int basis,
    int strict_parity, int center, float r2, float rate, void* stream) {
  if (nf < 1 || nf > kMaxFrames || f0 < 0 || f0 + nf > F || V < 1 || N < 1 || L < 1 ||
      T != (N + 7) / 8 || 3 * nf > 8 * nt) {
    return cudaErrorInvalidValue;
  }
  FramesArgs a;
  a.e = EvalArgs{};
  a.e.pts = pts; a.e.dist2 = dist2; a.e.gate = gate; a.e.w_poly = poly;
  a.e.fu = fu; a.e.fv = fv; a.e.fn = fn; a.e.out = out; a.e.falloff = falloff;
  a.e.V = V; a.e.N = N; a.e.L = L; a.e.strict_parity = strict_parity;
  a.e.r2 = r2; a.e.rate = rate;
  a.stream = stream_t; a.T = T; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return FramesTiles::launch<GAUSSIAN>(a, nt, center, s);
    case THIN_PLATE: return FramesTiles::launch<THIN_PLATE>(a, nt, center, s);
    case MULTIQUADRIC: return FramesTiles::launch<MULTIQUADRIC>(a, nt, center, s);
    case INVERSE_MULTIQUADRIC: return FramesTiles::launch<INVERSE_MULTIQUADRIC>(a, nt, center, s);
    case LINEAR: return FramesTiles::launch<LINEAR>(a, nt, center, s);
    case CUBIC: return FramesTiles::launch<CUBIC>(a, nt, center, s);
    case WENDLAND_C2: return FramesTiles::launch<WENDLAND_C2>(a, nt, center, s);
    default: return cudaErrorInvalidValue;
  }
}

// geom: frames a launch at most, the count k of NT values, the k values,
// then the staged k-step's floats at each for n_layers (ops/cuda_eval.py,
// frames_geometry); at most 2 + 2 * 16 ints.
extern "C" int fd_frames_geometry(int* geom, int n_layers) {
  geom[0] = kMaxFrames;
  geom[1] = FramesTiles::count;
  for (int i = 0; i < FramesTiles::count; ++i) {
    geom[2 + i] = FramesTiles::values[i];
    geom[2 + FramesTiles::count + i] = step_floats(FramesTiles::values[i], n_layers);
  }
  return 0;
}

// The launch's operands from a frames-stacked model: stream_t (T, step
// floats) and poly (4, 8 nt) (ops/cuda_eval.py, frames_stream).
extern "C" int fd_frames_pack(const float* ctrl, const float* w_rbf, const float* eps,
                              const float* w_poly, float* stream_t, float* poly, int m, int N,
                              int L, int F, int f0, int nf, int nt, void* stream) {
  if (N < 1 || L < 1 || m < 0 || m > 4 || nf < 1 || nf > kMaxFrames || f0 < 0 ||
      f0 + nf > F || 3 * nf > 8 * nt) {
    return cudaErrorInvalidValue;
  }
  const int T = (N + 7) / 8;
  const long long total = (long long)T * step_floats(nt, L) + 32 * nt;
  const int grid = (int)((total + kPackThreads - 1) / kPackThreads);
  frames_pack_kernel<<<grid, kPackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ctrl, w_rbf, eps, w_poly, m, N, L, f0, nf, nt, T, stream_t, poly);
  return cudaGetLastError();
}
