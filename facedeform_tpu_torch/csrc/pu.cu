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
// tile's accumulator resident in VMEM while the output block index repeats;
// it contracts phi against the weight columns on the VPU.  Here one block
// of 256 threads owns one vertex tile and loops over its own items, with
// the accumulators sum_k W_k s_k (3F columns) and sum_k W_k in registers:
// no atomics and a fixed summation order, so the result is deterministic.
// Each warp owns 32 points of the tile as two m16 row blocks.  Per k-step
// of 8 controls a lane computes phi at its A-fragment positions (4 points
// x 2 controls: 8 independent chains), splits each into tf32 words and the
// warp contracts the (32 x 8) phi tile with the item's weight columns on
// the tensor cores, 3xTF32 mma.sync (common.cuh), against NT n8 tiles of
// columns (3nf padded).  Each output column depends only on its own row of
// phi and its own weight column, in a fixed k order, so a frame of one
// tensor-core launch equals that frame of any other.  One pose (NT = 0)
// contracts on the CUDA cores instead: its 3 FMAs a pair cost less than
// the split and the passes (machine code, PERF.md); there a lane owns one
// point (row tq of its quad's four) and sums each k-step's 8 controls in
// order, 8 phi chains a k-step.  Its rounding differs from the tensor
// path's, so a frame of a shot matches its one-pose launch within the
// kernels' tolerance, not bit for bit.
//
// Per item the patch's live controls (n_live[k], rounded up to whole
// k-steps) stream through shared memory in slabs of 8 k-steps, cp.async,
// double-buffered: per k-step the 8 centered controls ((ctrl - c_k) *
// valid, valid) and the weight fragments, pre-split and laid out by the
// wrapper (ops/tf32.mma_fragments).  An item that no point of the tile
// needs (W_k = 0 throughout) is skipped by the block (__syncthreads_or); a
// warp none of whose 32 points needs it skips the k-loop (__any_sync) but
// keeps staging and the barriers.  The epilogue of an item adds the
// centered linear tail and acc += s W_k on the C-fragment rows each lane
// holds, rounded as the plain twin rounds them (once per item); the end
// normalizes (acc / max(sum W, 1e-30) where sum W > 1e-30, else 0) and
// writes each point straight to the caller's order through perm.
//
// What bounds it on this card: per needed (point, control) pair, 3
// differences, d2, s, one phi (a log for TPS) and the split run on the
// CUDA cores; the contraction, 3 passes x 2 x 8 NT a pair, on the tensor
// cores.  NT (0: one pose; 1, 2, 3 or 6 n8 tiles) is a template parameter
// the wrapper picks; it loops over chunks of at most 16 frames.  Squared distances
// use non-contracted f32 operations (the plain twin's rounding); accurate
// logf/expf/sqrtf, no fast-math.
//
// The forced patch id is compared as an integer (the TPU compares it as
// f32).  Dead items (patch < 0) contribute nothing; an empty tile's no-op
// item has only padded or uncovered-by-it points, whose weight is 0.
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kPuThreads = 256;  // = tile_v: 8 warps of 32 points
constexpr int kSlabSteps = 8;    // k-steps (8 controls each) staged per slab

struct PuArgs {
  const float* pts;        // (V, 3) caller's order
  const int* perm;         // (V,) Z-order -> caller's index
  const int* forced;       // (n_vt * 256,) forced patch per Z-ordered point, -1 none
  const int* item_patch;   // (T',) patch of each item, sorted by tile
  const int* item_offsets; // (n_vt + 1,) CSR of items by tile
  const float* stream;     // (K, T, step_floats) per k-step: 8 x (lc.xyz, valid), fragments
  const int* n_live;       // (K,) controls past the last valid one are skipped
  const float* poly;       // (K, 4, tail columns) this launch's centered tails, zero-padded
  const float* geom;       // (K, 8) cx, cy, cz, 1/eps^2, 1/R^2, 0, 0, 0
  float* out;              // (F, V, 3) caller's order
  int V, T, F;
  int f0, nf;              // this launch's frames [f0, f0 + nf), 3 nf <= 8 NT
};

// floats per staged k-step: 8 controls x 4, then NT fragment blocks of 32
// lanes x 4, or (NT = 0, contracted on the CUDA cores) the 8 controls' f32
// weights x 4; columns of a tail row: 8 NT, 8 for one pose.
__host__ __device__ constexpr int pu_step_floats(int nt) { return nt == 0 ? 64 : 32 + 128 * nt; }
__host__ __device__ constexpr int pu_tail_columns(int nt) { return nt == 0 ? 8 : 8 * nt; }

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
}

// phi of a staged control c = (lc.xyz, valid) at a centered point xl
template <int B>
__device__ __forceinline__ float pu_phi(float4 c, const float xl[3], float inv_eps2) {
  return phi_of<B>(sq3(c.x - xl[0], c.y - xl[1], c.z - xl[2]) * inv_eps2) * c.w;
}

template <int B, int NT>
__global__ void __launch_bounds__(kPuThreads, NT >= 6 ? 1 : 2) pu_kernel(PuArgs a) {
  constexpr int CP = pu_tail_columns(NT);
  constexpr int SF = pu_step_floats(NT);
  constexpr int NTD = NT > 0 ? NT : 1;  // a divisor for the tensor path's indices
  constexpr int SLAB = kSlabSteps * SF;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [2][SLAB]
  const int vt = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  // this lane's rows: r = 0..3 -> tile point warp * 32 + lane / 4 + 8 r, the
  // fragment rows g, g + 8 of m-block 0 (r = 0, 1) and of m-block 1 (r = 2, 3)
  const int row0 = vt * kPuThreads + (threadIdx.x >> 5) * 32 + (lane >> 2);
  float px[4][3];
  int frc[4];
  bool pv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = row0 + 8 * r;
    pv[r] = i < a.V;
    frc[r] = a.forced[i];
    px[r][0] = px[r][1] = px[r][2] = 0.0f;
    if (pv[r]) {
      const int src = a.perm[i];
      px[r][0] = a.pts[3 * src]; px[r][1] = a.pts[3 * src + 1]; px[r][2] = a.pts[3 * src + 2];
    }
  }
  // blended sums: C-fragment elements (mb, nt, e) of the tensor path, or
  // the 3 columns of the lane's own row (r = tq) of the one-pose path
  constexpr int NACC = NT == 0 ? 3 : 8 * NT;
  float acc[NACC];
#pragma unroll
  for (int q = 0; q < NACC; ++q) acc[q] = 0.0f;
  float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int it_end = a.item_offsets[vt + 1];
  for (int it = a.item_offsets[vt]; it < it_end; ++it) {
    const int k = a.item_patch[it];
    if (k < 0) continue;  // dead item (block-uniform)
    const float* g = a.geom + 8 * (size_t)k;
    const float cx = g[0], cy = g[1], cz = g[2], inv_eps2 = g[3], inv_r2 = g[4];
    float xl[4][3], w[4];
    float xq[3] = {0.0f, 0.0f, 0.0f}, wq = 0.0f;  // row tq: the one-pose path's own
    bool need = false;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      xl[r][0] = px[r][0] - cx; xl[r][1] = px[r][1] - cy; xl[r][2] = px[r][2] - cz;
      const float wr = frc[r] == k
          ? 1.0f : phi_of<WENDLAND_C2>(sq3(xl[r][0], xl[r][1], xl[r][2]) * inv_r2);
      w[r] = pv[r] ? wr : 0.0f;
      need = need || w[r] > 0.0f;
      if (r == tq) { xq[0] = xl[r][0]; xq[1] = xl[r][1]; xq[2] = xl[r][2]; wq = w[r]; }
    }
    // block-uniform: every thread takes the same branch, barriers stay safe
    if (!__syncthreads_or(need)) continue;
    const bool live = __any_sync(0xffffffffu, need);  // warp-uniform
    float d[NACC];  // the patch's interpolant, in acc's layout
#pragma unroll
    for (int q = 0; q < NACC; ++q) d[q] = 0.0f;
    const int steps = (a.n_live[k] + 7) >> 3;
    const int nslab = (steps + kSlabSteps - 1) / kSlabSteps;
    const float* src = a.stream + (size_t)k * a.T * SF;
    if (nslab > 0) {
      stage_async(buf, src, min(steps, kSlabSteps) * SF);
      cp_async_commit();
    }
    for (int s = 0; s < nslab; ++s) {
      if (s + 1 < nslab) {  // prefetch the next slab into the other buffer
        const int next = (s + 1) * kSlabSteps;
        stage_async(buf + ((s + 1) & 1) * SLAB, src + (size_t)next * SF,
                    min(steps - next, kSlabSteps) * SF);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (live) {
        const float* sb = buf + (s & 1) * SLAB;
        const int cnt = min(steps - s * kSlabSteps, kSlabSteps);
        for (int t = 0; t < cnt; ++t) {
          const float* st = sb + t * SF;
          if constexpr (NT == 0) {
            // one pose: 3 FMAs a pair on the CUDA cores, fewer than the
            // split and the passes; one point a lane, the k-step's 8
            // controls in order (8 phi chains, the plain order of a sum)
            const float4* lc = reinterpret_cast<const float4*>(st);
            const float4* wv = reinterpret_cast<const float4*>(st + 32);
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float p = pu_phi<B>(lc[j], xq, inv_eps2);
              const float4 wj = wv[j];
              d[0] = fmaf(p, wj.x, d[0]);
              d[1] = fmaf(p, wj.y, d[1]);
              d[2] = fmaf(p, wj.z, d[2]);
            }
          } else {
            const float4 c0 = reinterpret_cast<const float4*>(st)[tq];      // column tq
            const float4 c1 = reinterpret_cast<const float4*>(st)[tq + 4];  // column tq + 4
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              split_tf32(pu_phi<B>(c0, xl[r], inv_eps2), ah[r >> 1][r & 1], al[r >> 1][r & 1]);
              split_tf32(pu_phi<B>(c1, xl[r], inv_eps2), ah[r >> 1][2 + (r & 1)],
                         al[r >> 1][2 + (r & 1)]);
            }
            const float4* fr = reinterpret_cast<const float4*>(st + 32) + lane;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const float4 b = fr[32 * nt];
#pragma unroll
              for (int mb = 0; mb < 2; ++mb) mma_3xtf32(d + 4 * (mb * NT + nt), ah[mb], al[mb], b);
            }
          }
        }
      }
      __syncthreads();  // the buffer is read before the next prefetch lands in it
    }
    if (live) {
      // centered linear tail [1, xl] per column, then the blend (rounded as
      // the twin rounds them: once per item, not per pair)
      const float* wp = a.poly + (size_t)k * 4 * CP;
#pragma unroll
      for (int q = 0; q < NACC; ++q) {
        const int r = 2 * (q / (4 * NTD)) + ((q & 3) >> 1);
        const int col = NT == 0 ? q : 8 * ((q >> 2) % NTD) + 2 * tq + (q & 1);
        const float* x = NT == 0 ? xq : xl[r];
        float v = __fadd_rn(d[q], wp[col]);
        v = __fadd_rn(v, __fmul_rn(wp[CP + col], x[0]));
        v = __fadd_rn(v, __fmul_rn(wp[2 * CP + col], x[1]));
        v = __fadd_rn(v, __fmul_rn(wp[3 * CP + col], x[2]));
        acc[q] = __fadd_rn(acc[q], __fmul_rn(v, NT == 0 ? wq : w[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) wsum[r] += w[r];
  }
  const int qn = 3 * a.nf;
  float wsq = 0.0f;  // the one-pose path's own row
#pragma unroll
  for (int r = 0; r < 4; ++r) wsq = r == tq ? wsum[r] : wsq;
#pragma unroll
  for (int q = 0; q < NACC; ++q) {
    const int r = 2 * (q / (4 * NTD)) + ((q & 3) >> 1);
    const int col = NT == 0 ? q : 8 * ((q >> 2) % NTD) + 2 * tq + (q & 1);
    const int i = row0 + 8 * (NT == 0 ? tq : r);
    const float ws = NT == 0 ? wsq : wsum[r];
    if (i < a.V && col < qn) {
      const int f = col / 3;
      const float v = ws > 1e-30f ? acc[q] / fmaxf(ws, 1e-30f) : 0.0f;
      a.out[((size_t)(a.f0 + f) * a.V + a.perm[i]) * 3 + (col - 3 * f)] = v;
    }
  }
}

template <int B, int NT>
cudaError_t launch_nt(const PuArgs& a, int n_vt, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 2 * kSlabSteps * pu_step_floats(NT);
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t err = cudaFuncSetAttribute(
        pu_kernel<B, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  pu_kernel<B, NT><<<n_vt, kPuThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_pu(const PuArgs& a, int nt, int n_vt, cudaStream_t stream) {
  switch (nt) {
    case 0: return launch_nt<B, 0>(a, n_vt, stream);
    case 1: return launch_nt<B, 1>(a, n_vt, stream);
    case 2: return launch_nt<B, 2>(a, n_vt, stream);
    case 3: return launch_nt<B, 3>(a, n_vt, stream);
    default: return launch_nt<B, 6>(a, n_vt, stream);
  }
}

}  // namespace

// stream_t: (K, T, step floats) and poly: (K, 4, tail columns) pack this
// launch's frames in nt n8 tiles, nt = 0 for one pose (ops/cuda_pu.py,
// _pack_launch).
extern "C" int fd_pu_tiles(
    const float* pts, const int* perm, const int* forced, const int* item_patch,
    const int* item_offsets, const float* stream_t, const int* n_live, const float* poly,
    const float* geom, float* out, int V, int n_vt, int K, int T, int F, int f0, int nf,
    int nt, int basis, void* stream) {
  if (nf < 1 || f0 < 0 || f0 + nf > F || K < 1 || T < 1 || V < 1 ||
      (long long)n_vt * kPuThreads < V || (nt == 0 ? nf != 1 : 3 * nf > 8 * nt) ||
      (nt != 0 && nt != 1 && nt != 2 && nt != 3 && nt != 6)) {
    return cudaErrorInvalidValue;
  }
  PuArgs a;
  a.pts = pts; a.perm = perm; a.forced = forced; a.item_patch = item_patch;
  a.item_offsets = item_offsets; a.stream = stream_t; a.n_live = n_live; a.poly = poly;
  a.geom = geom; a.out = out;
  a.V = V; a.T = T; a.F = F; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_pu<GAUSSIAN>(a, nt, n_vt, s);
    case THIN_PLATE: return launch_pu<THIN_PLATE>(a, nt, n_vt, s);
    case MULTIQUADRIC: return launch_pu<MULTIQUADRIC>(a, nt, n_vt, s);
    case INVERSE_MULTIQUADRIC: return launch_pu<INVERSE_MULTIQUADRIC>(a, nt, n_vt, s);
    case LINEAR: return launch_pu<LINEAR>(a, nt, n_vt, s);
    case CUBIC: return launch_pu<CUBIC>(a, nt, n_vt, s);
    case WENDLAND_C2: return launch_pu<WENDLAND_C2>(a, nt, n_vt, s);
    default: return cudaErrorInvalidValue;
  }
}
