// Float64 deform step for growing kernels on Hopper (sm_90a): the precise
// eval kernel of facedeform_tpu_torch/ops/cuda_precise.py, for one pose or
// a shot of poses that share their controls and radii.
//
// Replaces (TPU): facedeform_tpu/ops/pallas_precise.py, _precise_kernel
// (evaluate_pallas_precise).  The TPU has no float64, so that kernel
// carries every value as a double-float (hi, lo) pair of f32 words built
// from error-free transforms; the H100 has native fp64, so this kernel
// computes the same quantity in double and keeps none of the pair
// arithmetic.
//
// Per vertex: squared distance to every control from the exact f32
// coordinates, s = d2 / eps^2, phi(s), the contraction against
// w_rbf + w_rbf_lo and the linear tail [1, x, y, z] . (w_poly + w_poly_lo),
// all in double; then each frame's displacement is rounded to f32 once,
// projected to the tangent plane and weighted by the capture falloff in
// f32 exactly as the dense f32 kernel does (common.cuh), and P + w * disp
// and w are written.  No centering of phi: that is the f32 kernel's
// cancellation guard, not needed in double.
//
// What bounds it on this card: instruction issue, fp64 first.  A (vertex,
// control) pair costs 21 fp64 instructions at one frame (thin plate, read
// from the SASS), each two issue cycles of a sub-partition's 16 fp64
// lanes, and about as many integer, select and shared-memory
// instructions beside them, while a vertex moves ~28 B of device memory.
// What the design does about it:
//   * frames: F poses of a shot differ only in their weights, so d2, s and
//     phi are computed once per (vertex, control, layer) and contracted
//     against 3 FB columns, FB (frames per launch) a template parameter in
//     {1, 2, 4, 8}; a frame costs 3 FMAs a pair on top.  The weights arrive
//     frames-packed, (L, N, 3F), column 3f + k = frame f's component k; the
//     tails (4, 3F).  Frames past 8 take further launches.  Every frame
//     accumulates in the single-pose launch's order with explicit fma(),
//     so a frame of an FB-frame launch equals the single-pose launch of
//     that frame bit for bit.
//   * the thin-plate log: libdevice's log(double) was 42% of the TPS launch.
//     log_core is Tang's table method: s = 2^k m with m in [0.749, 1.498)
//     (s near 1 keeps k = 0 and c = 1, so k ln2 and log c never cancel),
//     c_j from a 256-entry table of (1/c_j, log c_j) built on the host
//     (ops/cuda_precise.log_table) and staged in shared memory, r = m/c_j - 1
//     in one FMA (|r| <= 2^-9), log1p(r) by a degree-5 polynomial, k ln2
//     with a hi/lo split of ln2: 10 fp64 instructions, within 1 ulp of log
//     where |log s| >= 1 and 2^-53 absolute elsewhere.  The 0.5 of
//     0.5 s log s is folded into the staged weights (a power of two: the
//     products round as before).
//   * latency: each thread owns two vertices, kBlockVerts / 2 apart, so
//     two independent log and accumulation chains interleave, and each
//     staged control's doubles are read once per two vertices.
// Controls are staged through shared memory in chunks of AoS records
// [x, y, z, 1/eps^2 per layer (padded to even), per layer the 3 FB weights
// (padded to even)], all double, read as 16-byte broadcasts; the chunk is
// sized to the 48 KB static limit beside the log table.  The capture
// early exit is the block-uniform __syncthreads_or over both vertices of
// every thread; the TPU's padding of V and N to tile multiples becomes
// bounds checks.
//
// No fast-math: every fma() here is written out, and the f32 epilogue
// contracts as the dense kernel does.  No error-free transform is computed
// in this file (a double-float rewrite in f32 would need --fmad=false).
//
// C ABI, loaded with ctypes; the entry points return cudaGetLastError().

#include "common.cuh"

namespace {

constexpr int kPreciseThreads = 128;
constexpr int kVertsPerThread = 2;
constexpr int kBlockVerts = kPreciseThreads * kVertsPerThread;
constexpr int kPreciseChunk = 256;             // most controls staged per chunk
constexpr int kMaxFrames = 8;                  // largest FB instantiated
constexpr int kLogTableSize = 256;             // (1/c_j, log c_j) entries
constexpr size_t kSmemTargetBytes = 49152;     // chunk sized to the static limit
constexpr size_t kMaxSmemBytes = 232448;       // 227 KB opt-in limit

// The device log's constants; ops/cuda_precise.py holds the same numbers
// (a CPU test reads them back from this file).
constexpr double kLn2Hi = 0x1.62e42fee00000p-1;    // 21 trailing zero bits
constexpr double kLn2Lo = 0x1.a39ef35793c76p-33;
constexpr double kLog1pC2 = -0x1.0000000000000p-1;  // log1p(r) = r + r^2 (c2 + r (c3
constexpr double kLog1pC3 = 0x1.5555555555555p-2;   //   + r (c4 + r c5)))
constexpr double kLog1pC4 = -0x1.0000000000000p-2;
constexpr double kLog1pC5 = 0x1.999999999999ap-3;
constexpr double kIntMagic = 0x1.0000080000000p+52;  // 2^52 + 2^31
constexpr long long kTinyBits = 0x39b4484bfeebc2a0LL;  // 1e-30

struct PreciseArgs {
  EvalArgs e;                // f32 vertex inputs, (F, V, 3) out, f32 ctrl, sizes, capture
  const double* inv_eps2;    // (L, N)
  const double* w;           // (L, N, 3F): w_rbf + w_rbf_lo, frames-packed
  const double* w_poly;      // (4, 3F): w_poly + w_poly_lo, absent rows zero
  const double2* log_table;  // (kLogTableSize,): (1/c_j, log c_j)
  int F;                     // frames in the packed arrays
  int f0, nf;                // this launch's frames [f0, f0 + nf), 1 <= nf <= FB
};

// log s for a normal, finite, positive s (k_adj: exponent of a pre-scale).
__device__ __forceinline__ double log_core(double s, const double2* tab, int k_adj) {
  const int hi = __double2hiint(s);
  const int k = (hi - 0x3FE7F800) >> 20;             // m = s 2^-k in [0.749, 1.498)
  const double m = __hiloint2double(hi - (k << 20), __double2loint(s));
  const double2 t = tab[((hi + 0x800) >> 12) & (kLogTableSize - 1)];
  const double r = fma(m, t.x, -1.0);
  const double q = fma(fma(fma(kLog1pC5, r, kLog1pC4), r, kLog1pC3), r, kLog1pC2);
  const double poly = fma(r * r, q, r);
  const double kd = __hiloint2double(0x43300000, (k + k_adj) ^ 0x80000000) - kIntMagic;
  return fma(kd, kLn2Hi, t.y) + fma(kd, kLn2Lo, poly);
}

// log s for any finite positive s, subnormals scaled by 2^54 first.
__device__ __forceinline__ double log_dev(double s, const double2* tab) {
  if (__double2hiint(s) < 0x00100000) return log_core(s * 0x1p54, tab, -54);
  return log_core(s, tab, 0);
}

// The staged weights of basis B carry this factor (exact: a power of two).
template <int B>
__host__ __device__ constexpr double weight_scale() { return B == THIN_PLATE ? 0.5 : 1.0; }

// phi(s) / weight_scale<B>(): s log s for the thin plate (s > 1e-30, else
// 0; s >= 0, so the test reads the bits), the others as accurate libdevice
// calls.  The thin plate's guard selects instead of branching (log of 1 in
// the masked lanes): a branch around each vertex's log made the compiler
// emit the two vertices' logs one after the other.
template <int B>
__device__ __forceinline__ double phi64(double s, const double2* tab) {
  if constexpr (B == GAUSSIAN) {
    return exp(-s);
  } else if constexpr (B == THIN_PLATE) {
    const bool pos = __double_as_longlong(s) > kTinyBits;
    const double l = log_core(pos ? s : 1.0, tab, 0);
    return pos ? s * l : 0.0;
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

// Doubles of one staged control: x, y, z, 1/eps^2 per layer (padded to an
// even count), then per layer the 3 FB weights (padded to even).
__host__ __device__ constexpr int even(int n) { return (n + 1) / 2 * 2; }
__host__ __device__ constexpr int head_of(int L) { return even(3 + L); }
template <int FB>
__host__ __device__ constexpr int record_of(int L) { return head_of(L) + L * even(3 * FB); }

// Stage controls [base, base + cnt) as records of `rec` doubles: the
// frames [f0, f0 + nf) of the weights, zero beyond, times weight_scale.
template <int B, int FB>
__device__ __forceinline__ void stage64(const PreciseArgs& a, double* s, int rec, int base,
                                        int cnt) {
  constexpr int S = even(3 * FB);
  const EvalArgs& e = a.e;
  const int L = e.L, N = e.N, head = head_of(L);
  const int f3 = 3 * a.F, q0 = 3 * a.f0, qn = 3 * a.nf;
  for (int idx = threadIdx.x; idx < cnt * rec; idx += blockDim.x) {
    const int t = idx / rec, q = idx - t * rec;
    const int j = base + t;
    double v = 0.0;
    if (q < 3) {
      v = e.ctrl[3 * j + q];
    } else if (q < 3 + L) {
      v = a.inv_eps2[(q - 3) * N + j];
    } else if (q >= head) {
      const int l = (q - head) / S, c = (q - head) - l * S;
      if (c < qn) v = a.w[((size_t)l * N + j) * f3 + q0 + c] * weight_scale<B>();
    }
    s[idx] = v;
  }
}

template <int B, int FB>
__global__ void __launch_bounds__(kPreciseThreads)
precise_kernel(PreciseArgs a, int chunk) {
  constexpr int S = even(3 * FB);
  constexpr int kTab = B == THIN_PLATE ? kLogTableSize : 0;
  extern __shared__ double2 smem2[];
  double2* tab = smem2;
  double* ctl = reinterpret_cast<double*>(smem2 + kTab);
  const EvalArgs& e = a.e;
  const int L = e.L, head = head_of(L), rec = record_of<FB>(L);
  int vi[kVertsPerThread];
  bool valid[kVertsPerThread];
  float p[kVertsPerThread][3], cap[kVertsPerThread], active[kVertsPerThread];
  bool any = false;
#pragma unroll
  for (int u = 0; u < kVertsPerThread; ++u) {
    vi[u] = blockIdx.x * kBlockVerts + u * kPreciseThreads + threadIdx.x;
    valid[u] = vi[u] < e.V;
    for (int k = 0; k < 3; ++k) p[u][k] = valid[u] ? e.pts[3 * vi[u] + k] : 0.0f;
    capture_of(e, vi[u], valid[u], cap[u], active[u]);
    any = any || active[u] > 0.0f;
  }
  double acc[kVertsPerThread][3 * FB];
#pragma unroll
  for (int u = 0; u < kVertsPerThread; ++u)
#pragma unroll
    for (int q = 0; q < 3 * FB; ++q) acc[u][q] = 0.0;
  // block-uniform: every thread takes the same branch, barriers stay safe
  const bool run = __syncthreads_or(any);
  if (run) {
    double px[kVertsPerThread], py[kVertsPerThread], pz[kVertsPerThread];
#pragma unroll
    for (int u = 0; u < kVertsPerThread; ++u) { px[u] = p[u][0]; py[u] = p[u][1]; pz[u] = p[u][2]; }
    if constexpr (kTab > 0) {
      for (int t = threadIdx.x; t < kTab; t += blockDim.x) tab[t] = a.log_table[t];
    }
    for (int base = 0; base < e.N; base += chunk) {
      const int cnt = min(chunk, e.N - base);
      __syncthreads();
      stage64<B, FB>(a, ctl, rec, base, cnt);
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const double* c = ctl + j * rec;
        const double2 xy = *reinterpret_cast<const double2*>(c);
        const double2 zi = *reinterpret_cast<const double2*>(c + 2);
        double d2[kVertsPerThread];
#pragma unroll
        for (int u = 0; u < kVertsPerThread; ++u) {
          const double dx = xy.x - px[u], dy = xy.y - py[u], dz = zi.x - pz[u];
          d2[u] = fma(dz, dz, fma(dy, dy, dx * dx));
        }
        for (int l = 0; l < L; ++l) {
          const double inv = l == 0 ? zi.y : c[3 + l];
          const double2* w = reinterpret_cast<const double2*>(c + head + l * S);
          double ph[kVertsPerThread];
#pragma unroll
          for (int u = 0; u < kVertsPerThread; ++u) ph[u] = phi64<B>(d2[u] * inv, tab);
#pragma unroll
          for (int q = 0; q < S / 2; ++q) {
            const double2 wq = w[q];
#pragma unroll
            for (int u = 0; u < kVertsPerThread; ++u) {
              acc[u][2 * q] = fma(ph[u], wq.x, acc[u][2 * q]);
              if (2 * q + 1 < 3 * FB) acc[u][2 * q + 1] = fma(ph[u], wq.y, acc[u][2 * q + 1]);
            }
          }
        }
      }
    }
  }
  const int f3 = 3 * a.F;
#pragma unroll
  for (int u = 0; u < kVertsPerThread; ++u) {
    if (!valid[u]) continue;
    const int i = vi[u];
    float d[3 * FB];
    if (run) {
      const double px = p[u][0], py = p[u][1], pz = p[u][2];
#pragma unroll
      for (int f = 0; f < FB; ++f) {
        // per-frame linear tail, w_poly rows [1, x, y, z] x (3F,)
        const double* wp = a.w_poly + 3 * (a.f0 + min(f, a.nf - 1));
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const double tail = fma(wp[3 * f3 + k], pz,
                                  fma(wp[2 * f3 + k], py, fma(wp[f3 + k], px, wp[k])));
          d[3 * f + k] = static_cast<float>(acc[u][3 * f + k] + tail);
        }
      }
      if (e.fu != nullptr) {
        // the axes do not depend on the displacement: once per vertex
        float a1[3], a2[3];
        tangent_axes(e, i, a1, a2);
#pragma unroll
        for (int f = 0; f < FB; ++f) project3(d + 3 * f, a1, a2);
      }
    } else {
#pragma unroll
      for (int q = 0; q < 3 * FB; ++q) d[q] = 0.0f;
    }
    const float w = falloff_of(e, cap[u], active[u]);
    e.falloff[i] = w;
#pragma unroll
    for (int f = 0; f < FB; ++f) {
      if (f < a.nf) {
        float* o = e.out + ((size_t)(a.f0 + f) * e.V + i) * 3;
        for (int k = 0; k < 3; ++k) o[k] = fmaf(d[3 * f + k], w, p[u][k]);
      }
    }
  }
}

template <int B, int FB>
cudaError_t launch_fb(const PreciseArgs& a, cudaStream_t stream) {
  const size_t tab = B == THIN_PLATE ? sizeof(double2) * kLogTableSize : 0;
  const size_t per = sizeof(double) * record_of<FB>(a.e.L);   // bytes per control
  size_t chunk = (kSmemTargetBytes - tab) / per;
  if (chunk < 1) chunk = (kMaxSmemBytes - tab) / per;         // very many layers
  if (chunk > kPreciseChunk) chunk = kPreciseChunk;
  if (chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = tab + per * chunk;
  if (smem > sizeof(float) * kStaticSmemFloats) {
    const cudaError_t err = cudaFuncSetAttribute(
        precise_kernel<B, FB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int grid = (a.e.V + kBlockVerts - 1) / kBlockVerts;
  precise_kernel<B, FB><<<grid, kPreciseThreads, smem, stream>>>(a, static_cast<int>(chunk));
  return cudaGetLastError();
}

template <int B>
cudaError_t launch_precise(const PreciseArgs& a, cudaStream_t stream) {
  if (a.nf <= 1) return launch_fb<B, 1>(a, stream);
  if (a.nf <= 2) return launch_fb<B, 2>(a, stream);
  if (a.nf <= 4) return launch_fb<B, 4>(a, stream);
  return launch_fb<B, 8>(a, stream);
}

__global__ void log_probe_kernel(const double* s, double* out, const double2* tab, int n) {
  __shared__ double2 t[kLogTableSize];
  for (int j = threadIdx.x; j < kLogTableSize; j += blockDim.x) t[j] = tab[j];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = log_dev(s[i], t);
}

}  // namespace

extern "C" int fd_eval_precise(
    const float* pts, const float* dist2, const float* gate, const float* ctrl,
    const double* w, const double* inv_eps2, const double* w_poly,
    const float* fu, const float* fv, const float* fn, float* out,
    float* falloff, const void* log_table, int V, int N, int L, int F, int f0, int nf,
    int basis, int strict_parity, float r2, float rate, void* stream) {
  if (nf < 1 || nf > kMaxFrames || f0 < 0 || f0 + nf > F) return cudaErrorInvalidValue;
  PreciseArgs a;
  a.e.pts = pts; a.e.dist2 = dist2; a.e.gate = gate; a.e.ctrl = ctrl;
  a.e.w_rbf = nullptr; a.e.inv_eps2 = nullptr; a.e.w_poly = nullptr;
  a.e.fu = fu; a.e.fv = fv; a.e.fn = fn; a.e.out = out; a.e.falloff = falloff;
  a.e.V = V; a.e.N = N; a.e.L = L; a.e.strict_parity = strict_parity;
  a.e.r2 = r2; a.e.rate = rate;
  a.inv_eps2 = inv_eps2; a.w = w; a.w_poly = w_poly;
  a.log_table = static_cast<const double2*>(log_table);
  a.F = F; a.f0 = f0; a.nf = nf;
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

// The device log of every s (finite, positive) into out: the thin-plate
// basis's log, exposed for its accuracy sweep.
extern "C" int fd_log_probe(const double* s, double* out, const void* log_table, int n,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  log_probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      s, out, static_cast<const double2*>(log_table), n);
  return cudaGetLastError();
}
