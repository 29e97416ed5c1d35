// Device helpers shared by the port's hand-written kernels (eval.cu,
// frames.cu, jacobian.cu, precise.cu, pu.cu): the seven radial bases and
// their s-derivatives, the 3xTF32 tensor-core contraction and cp.async
// staging, the per-vertex capture inputs, the reference's oblique tangent
// projection and the falloff write.  Accurate expf/logf/sqrtf/rsqrtf, no
// fast-math: the 5e-5 displacement budget is the contract.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStaticSmemFloats = 12288;  // 48 KB without opt-in

enum Basis {
  GAUSSIAN = 0, THIN_PLATE = 1, MULTIQUADRIC = 2, INVERSE_MULTIQUADRIC = 3,
  LINEAR = 4, CUBIC = 5, WENDLAND_C2 = 6,
};

struct EvalArgs {
  const float* pts;       // (V, 3)
  const float* dist2;     // (V,)
  const float* gate;      // (V,)
  const float* ctrl;      // (N, 3)
  const float* w_rbf;     // (L, N, 3), or (L, N, 3F) frames-packed
  const float* inv_eps2;  // (L, N)
  const float* w_poly;    // (4, 3), or (4, 3F); absent rows zero
  const float* fu;        // (V, 3) or null
  const float* fv;
  const float* fn;
  float* out;             // (V, 3), or (F, V, 3)
  float* falloff;         // (V,)
  int V, N, L;
  int strict_parity;
  float r2, rate;
};

template <int B>
__device__ __forceinline__ float phi_of(float s) {
  if constexpr (B == GAUSSIAN) {
    return expf(-s);
  } else if constexpr (B == THIN_PLATE) {
    // the log outside the guard: a select, not a branch around each log,
    // so several chains of a thread interleave
    const float l = logf(fmaxf(s, 1e-30f));
    return s > 1e-30f ? 0.5f * s * l : 0.0f;
  } else if constexpr (B == MULTIQUADRIC) {
    return sqrtf(1.0f + s);
  } else if constexpr (B == INVERSE_MULTIQUADRIC) {
    return rsqrtf(1.0f + s);
  } else if constexpr (B == LINEAR) {
    return sqrtf(s);
  } else if constexpr (B == CUBIC) {
    return s * sqrtf(s);
  } else {
    const float t = sqrtf(s);
    const float b = fmaxf(1.0f - t, 0.0f);
    const float b2 = b * b;
    return b2 * b2 * (4.0f * t + 1.0f);
  }
}

// d phi / d s with s = (r/eps)^2, finite at s = 0 for every basis: the
// device twin of ops/kernels.phi_prime_s (the r -> 0 limits).
template <int B>
__device__ __forceinline__ float phi_prime_of(float s) {
  if constexpr (B == GAUSSIAN) {
    return -expf(-s);
  } else if constexpr (B == THIN_PLATE) {
    const float l = logf(fmaxf(s, 1e-30f));
    return s > 1e-30f ? 0.5f * (l + 1.0f) : 0.0f;
  } else if constexpr (B == MULTIQUADRIC) {
    return 0.5f * rsqrtf(1.0f + s);
  } else if constexpr (B == INVERSE_MULTIQUADRIC) {
    const float q = rsqrtf(1.0f + s);
    return -0.5f * q / (1.0f + s);
  } else if constexpr (B == LINEAR) {
    return s > 1e-30f ? 0.5f * rsqrtf(fmaxf(s, 1e-30f)) : 0.0f;
  } else if constexpr (B == CUBIC) {
    return 1.5f * sqrtf(s);
  } else {
    const float b = fmaxf(1.0f - sqrtf(s), 0.0f);
    return -10.0f * b * b * b;
  }
}

// ---- 3xTF32 contraction on the tensor cores (pu.cu, jacobian.cu, frames.cu)
//
// mma.sync.m16n8k8 with tf32 inputs and f32 accumulation: per warp, a
// 16 x 8 A tile times an 8 x 8 B tile.  Lane l = 4 g + t (g = l >> 2,
// t = l & 3) holds A[g][t], A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]
// (a0..a3), B[t][g] and B[t + 4][g] (b0, b1), and C[g][2t], C[g][2t + 1],
// C[g + 8][2t], C[g + 8][2t + 1] (c0..c3).  Every operand is split into
// two tf32 words, hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) (the
// subtraction exact), and a product is A_lo B_hi + A_hi B_lo + A_hi B_hi:
// about 22 bits of each operand, the TPU's Precision.HIGHEST, where one
// tf32 pass keeps 11.  The tensor cores add inside an mma with truncation,
// so each k-step's three passes go into a fresh C fragment that the
// caller adds to its f32 accumulator (round to nearest) on the CUDA cores.
// The kernels split the A tile they compute; B (weights, constant per
// model) comes pre-split from the wrapper (ops/tf32.py, mma_fragments) as
// one float4 (b0 hi, b1 hi, b0 lo, b1 lo) per lane.  The subtraction must
// stay exact: __fsub_rn, never contracted into an FMA, no fast-math.

// cvt.rna.tf32.f32 for a finite x, by integer arithmetic: half a tf32 ulp
// added to the magnitude bits, then the 13 low bits cleared (ties away
// from zero; a carry moves to the next binade, as the rounding does).  The
// PTX instruction compiles to a longer sequence that also handles NaN and
// infinity, which these operands never are (machine code, PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A B for one k-step: the three passes into a zeroed fragment, small
// terms first, then one f32 add per element.
__device__ __forceinline__ void mma_3xtf32(float acc[4], const uint32_t ah[4],
                                           const uint32_t al[4], float4 b) {
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(c, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(c, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(c, ah, __float_as_uint(b.x), __float_as_uint(b.y));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] = __fadd_rn(acc[e], c[e]);
}

// ---- cp.async staging (sm_80+): 16-byte copies global -> shared ---------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The block copies n floats (a multiple of 4; both ends 16-byte aligned).
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n) {
  for (int q = threadIdx.x; q < n / 4; q += blockDim.x) cp_async16(dst + 4 * q, src + 4 * q);
}

__device__ __forceinline__ void normalize3(float v[3]) {
  const float r = rsqrtf(fmaxf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-20f));
  v[0] *= r; v[1] *= r; v[2] *= r;
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// The reference's oblique projection axes of vertex i: a1 = norm(u B),
// a2 = norm(v B) with B = u u^T + v v^T + n n^T.  They do not depend on
// the displacement, so a frames kernel computes them once per vertex.
__device__ __forceinline__ void tangent_axes(const EvalArgs& a, int i, float a1[3],
                                             float a2[3]) {
  float u[3], v[3], n[3];
  for (int k = 0; k < 3; ++k) {
    u[k] = a.fu[3 * i + k]; v[k] = a.fv[3 * i + k]; n[k] = a.fn[3 * i + k];
  }
  normalize3(u); normalize3(v); normalize3(n);
  const float uu = dot3(u, u), uv = dot3(u, v), un = dot3(u, n);
  const float vu = dot3(v, u), vv = dot3(v, v), vn = dot3(v, n);
  for (int k = 0; k < 3; ++k) {
    a1[k] = uu * u[k] + uv * v[k] + un * n[k];
    a2[k] = vu * u[k] + vv * v[k] + vn * n[k];
  }
  normalize3(a1); normalize3(a2);
}

// disp' = a1 (disp.a1) + a2 (disp.a2), in place.
__device__ __forceinline__ void project3(float d[3], const float a1[3],
                                         const float a2[3]) {
  const float da1 = dot3(d, a1), da2 = dot3(d, a2);
  for (int k = 0; k < 3; ++k) d[k] = a1[k] * da1 + a2[k] * da2;
}

__device__ __forceinline__ void project_tangent(const EvalArgs& a, int i, float d[3]) {
  float a1[3], a2[3];
  tangent_axes(a, i, a1, a2);
  project3(d, a1, a2);
}

// Capture inputs of vertex i: clamped d2 and active = (d2 <= r^2) * gate.
__device__ __forceinline__ void capture_of(const EvalArgs& a, int i, bool valid,
                                           float& cap, float& active) {
  cap = valid ? a.dist2[i] : 0.0f;
  if (!a.strict_parity) cap = fmaxf(cap, 0.0f);
  active = valid ? (cap <= a.r2 ? 1.0f : 0.0f) * a.gate[i] : 0.0f;
}

// Falloff (1 - min(d2/r^2, 1))^rate * active.
__device__ __forceinline__ float falloff_of(const EvalArgs& a, float cap, float active) {
  const float ratio = fminf(cap / a.r2, 1.0f);
  const float base = a.strict_parity ? 1.0f - ratio : fmaxf(1.0f - ratio, 0.0f);
  return powf(base, a.rate) * active;
}

}  // namespace
