// Displacement-field Jacobian for Hopper (sm_90a): the kernel of
// facedeform_tpu_torch/ops/cuda_jacobian.py (jacobian_cuda and
// jacobian_cuda_frames).
//
// Replaces (TPU): facedeform_tpu/ops/pallas_jacobian.py, _jac_kernel
// (jacobian_pallas, jacobian_pallas_frames).
//
// Per vertex x and frame f, with s = |x - c|^2 / eps^2 over every (control
// j, layer l) pair:
//     J[a][b] = sum 2 phi'(s) / eps^2 w_a (x_b - c_b)
// into (F, V, 3, 3).  The linear tail's constant is added by the wrapper,
// as pallas_jacobian.py does.
//
// The TPU kernel forms J = A x - T from twelve moments per frame (A = sum g
// w_a, T = sum g w_a c_b, g = 2 phi' / eps^2), contracting g with packed
// weight columns [w_a, w_a c_b] on its matrix unit at Precision.HIGHEST.
// On the tensor cores under 3xTF32 that form cancels: |T| ~ |A| |c| with
// |c| ~ 1 on a unit-scale rig, so J loses the split's 2^-22 of |T| (1.07e-5
// of max|J| at 1M x 1k against the plain twin, past its 1e-5; PERF.md).
// This kernel re-centers on each vertex instead: the A tiles it computes in
// registers are D_b = phi'(s) (c_b - x_b), one per b, and the weight
// columns are U = -2 w_a / eps^2, frame f's in columns 3f .. 3f + 2, so
// J[a][b] = sum D_b U_a with no cancellation.  Each warp owns 32 vertices
// as two m16 row blocks; per group of 8 controls a lane computes the
// differences and phi' at its A-fragment positions (4 vertices x 2
// controls), per layer the three D_b tiles, split into tf32 words, and the
// warp accumulates acc_b (32 x 3nf) += D_b . U_l with 3xTF32 mma.sync
// (common.cuh) against NT n8 tiles of columns.  U comes pre-split in
// fragment order from the wrapper (ops/tf32.mma_fragments), streamed per
// group with the controls and the layers' 1/eps^2 through shared memory by
// cp.async, double-buffered (the dynamic-shared-memory opt-in past 48 KB).
// The epilogue gathers each frame's 9 entries of a vertex through a
// per-warp shared tile and writes them one vertex a lane, coalesced.
//
// What bounds it on this card: per (vertex, control, layer) the
// differences, one phi', three products and their splits on the CUDA
// cores; the contraction, 3 b x 3 passes x 2 x 8 NT, on the tensor cores;
// against 12 B in and 36 B per frame out a vertex.  NT (1, 2 or 3 n8
// tiles: 3nf columns, nf <= 8) is a template parameter the wrapper picks,
// so one template serves the single entry and the frames entry; the
// wrapper loops over frame chunks of at most 8.  No fast-math.
//
// C ABI, loaded with ctypes; the entry point returns cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kJacThreads = 256;       // 8 warps of 32 vertices
constexpr int kMaxJacTiles = 3;        // largest NT instantiated: 8 frames
constexpr int kJacStageFloats = 12288; // a staging buffer holds up to 48 KB
constexpr int kJacMaxGroups = 8;       // groups of 8 controls per slab at most
constexpr int kEpiStride = 9;          // epilogue rows: J's 9 entries
constexpr int kMaxSmemBytes = 232448;  // 227 KB, the opt-in limit

struct JacArgs {
  const float* pts;     // (V, 3)
  const float* stream;  // (T, group_floats) per group of 8 controls, see below
  float* out;           // (F, V, 3, 3)
  int V, T, L;
  int F, f0, nf;        // this launch's frames [f0, f0 + nf), 3 nf <= 8 NT
};

// floats per group of 8 controls: 8 x (x, y, z, 0), L x 8 inv_eps2, then
// L x NT fragment blocks of 32 x 4.
__host__ __device__ constexpr int jac_group_floats(int nt, int n_layers) {
  return 32 + 8 * n_layers + 128 * n_layers * nt;
}

template <int B, int NT>
__global__ void __launch_bounds__(kJacThreads, NT >= 2 ? 1 : 2)
jac_kernel(JacArgs a, int chunk) {
  const int gs = jac_group_floats(NT, a.L);
  const int slab = chunk * gs;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);  // [2][slab], then the epilogue tiles
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int base = blockIdx.x * kJacThreads + (threadIdx.x >> 5) * 32;
  // this lane's rows r = 0..3: vertex base + lane / 4 + 8 r (fragment rows
  // g, g + 8 of m-block 0 for r = 0, 1; of m-block 1 for r = 2, 3)
  float p[4][3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = base + (lane >> 2) + 8 * r;
    p[r][0] = p[r][1] = p[r][2] = 0.0f;
    if (i < a.V) { p[r][0] = a.pts[3 * i]; p[r][1] = a.pts[3 * i + 1]; p[r][2] = a.pts[3 * i + 2]; }
  }
  float acc[3][2][NT][4];  // [b][m-block][n-tile][C fragment]
#pragma unroll
  for (int b = 0; b < 3; ++b)
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][mb][nt][e] = 0.0f;
  const int nslab = (a.T + chunk - 1) / chunk;
  stage_async(buf, a.stream, min(a.T, chunk) * gs);
  cp_async_commit();
  for (int s = 0; s < nslab; ++s) {
    if (s + 1 < nslab) {  // prefetch the next slab into the other buffer
      const int next = (s + 1) * chunk;
      stage_async(buf + ((s + 1) & 1) * slab, a.stream + (size_t)next * gs,
                  min(a.T - next, chunk) * gs);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = buf + (s & 1) * slab;
    const int cnt = min(a.T - s * chunk, chunk);
    for (int t = 0; t < cnt; ++t) {
      const float* st = sb + t * gs;
      const float4 c0 = reinterpret_cast<const float4*>(st)[tq];      // column tq
      const float4 c1 = reinterpret_cast<const float4*>(st)[tq + 4];  // column tq + 4
      // c - x at the lane's (row r, column h) positions, and |c - x|^2
      float dx[4][2][3], d2[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dx[r][0][0] = c0.x - p[r][0]; dx[r][0][1] = c0.y - p[r][1]; dx[r][0][2] = c0.z - p[r][2];
        dx[r][1][0] = c1.x - p[r][0]; dx[r][1][1] = c1.y - p[r][1]; dx[r][1][2] = c1.z - p[r][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          d2[r][h] = dx[r][h][0] * dx[r][h][0] + dx[r][h][1] * dx[r][h][1] +
                     dx[r][h][2] * dx[r][h][2];
        }
      }
      const float4* frag = reinterpret_cast<const float4*>(st + 32 + 8 * a.L) + lane;
      for (int l = 0; l < a.L; ++l) {
        const float ie0 = st[32 + 8 * l + tq], ie1 = st[32 + 8 * l + tq + 4];
        float q[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          q[r][0] = phi_prime_of<B>(d2[r][0] * ie0);
          q[r][1] = phi_prime_of<B>(d2[r][1] * ie1);
        }
        float4 bw[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) bw[nt] = frag[(l * NT + nt) * 32];
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          uint32_t ah[2][4], al[2][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            split_tf32(__fmul_rn(q[r][0], dx[r][0][b]), ah[r >> 1][r & 1], al[r >> 1][r & 1]);
            split_tf32(__fmul_rn(q[r][1], dx[r][1][b]), ah[r >> 1][2 + (r & 1)],
                       al[r >> 1][2 + (r & 1)]);
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int mb = 0; mb < 2; ++mb) mma_3xtf32(acc[b][mb][nt], ah[mb], al[mb], bw[nt]);
        }
      }
    }
    __syncthreads();  // the buffer is read before the next prefetch lands in it
  }
  // epilogue, per frame: the warp's 32 x 9 entries through its shared tile,
  // then one vertex a lane
  float* ep = buf + (threadIdx.x >> 5) * 32 * kEpiStride;
  const int i = base + lane;
  for (int f = 0; f < a.nf; ++f) {
#pragma unroll
    for (int b = 0; b < 3; ++b)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ca = 8 * nt + 2 * tq + (e & 1) - 3 * f;  // row a of J, frame f
            if (ca >= 0 && ca < 3) {
              ep[((lane >> 2) + 8 * (e >> 1) + 16 * mb) * kEpiStride + 3 * ca + b] =
                  acc[b][mb][nt][e];
            }
          }
    __syncwarp();
    if (i < a.V) {
      const float* m = ep + lane * kEpiStride;
      float* o = a.out + ((size_t)(a.f0 + f) * a.V + i) * 9;
#pragma unroll
      for (int k = 0; k < 9; ++k) o[k] = m[k];
    }
    __syncwarp();
  }
}

template <int B, int NT>
cudaError_t launch_jac_nt(const JacArgs& a, cudaStream_t stream) {
  const int gs = jac_group_floats(NT, a.L);
  int chunk = kJacStageFloats / gs;
  if (chunk > kJacMaxGroups) chunk = kJacMaxGroups;
  if (chunk < 1) chunk = 1;
  const int floats = 2 * chunk * gs > kJacThreads * kEpiStride ? 2 * chunk * gs
                                                               : kJacThreads * kEpiStride;
  const size_t smem = sizeof(float) * floats;
  if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;  // too many layers
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t err = cudaFuncSetAttribute(
        jac_kernel<B, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (a.V + kJacThreads - 1) / kJacThreads;
  jac_kernel<B, NT><<<grid, kJacThreads, smem, stream>>>(a, chunk);
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_jac(const JacArgs& a, int nt, cudaStream_t stream) {
  switch (nt) {
    case 1: return launch_jac_nt<B, 1>(a, stream);
    case 2: return launch_jac_nt<B, 2>(a, stream);
    default: return launch_jac_nt<B, 3>(a, stream);
  }
}

}  // namespace

// stream_t: (T, 32 + 8 L + 128 L nt) per group of 8 controls, with this
// launch's weight columns in nt n8 tiles (ops/cuda_jacobian.py, _pack_launch).
extern "C" int fd_jacobian(const float* pts, const float* stream_t, float* out, int V, int T,
                           int L, int F, int f0, int nf, int nt, int basis, void* stream) {
  if (nf < 1 || f0 < 0 || f0 + nf > F || V < 1 || T < 1 || L < 1 || nt < 1 ||
      nt > kMaxJacTiles || 3 * nf > 8 * nt) {
    return cudaErrorInvalidValue;
  }
  JacArgs a;
  a.pts = pts; a.stream = stream_t; a.out = out;
  a.V = V; a.T = T; a.L = L; a.F = F; a.f0 = f0; a.nf = nf;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (basis) {
    case GAUSSIAN: return launch_jac<GAUSSIAN>(a, nt, s);
    case THIN_PLATE: return launch_jac<THIN_PLATE>(a, nt, s);
    case MULTIQUADRIC: return launch_jac<MULTIQUADRIC>(a, nt, s);
    case INVERSE_MULTIQUADRIC: return launch_jac<INVERSE_MULTIQUADRIC>(a, nt, s);
    case LINEAR: return launch_jac<LINEAR>(a, nt, s);
    case CUBIC: return launch_jac<CUBIC>(a, nt, s);
    case WENDLAND_C2: return launch_jac<WENDLAND_C2>(a, nt, s);
    default: return cudaErrorInvalidValue;
  }
}
