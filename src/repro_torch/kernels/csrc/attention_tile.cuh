// Shared inner loop of the attention kernels (paged_attention.cu,
// flash_attention.cu): one warp per query row carries the online softmax
// (m, l, acc) in f32 registers over K/V tiles staged in shared memory.
//
// Lane l of a warp holds head-dim elements [l * EPL, (l + 1) * EPL) of its
// query and of acc; below HD = 32 only the first HD lanes hold any.  Over
// each 32-key slice of a staged tile, a score is a warp-wide dot product
// and lane jj keeps the score of key jj; a key the caller's `visible`
// rejects scores -inf, and a slice with no visible key leaves the carry
// alone (the test is warp-uniform).  A query with no visible key at all
// writes 0: l is clamped at 1e-30, as the TPU kernels do.
//
// The score function is a compile-time mode (the attn_approx catalog of
// core/attn_approx.py): the exact online softmax, or one of the four
// exp-free datapaths of paged attention.  With d = s - m_new <= 0 and
// m_new the running max after the slice, a visible key weighs
//   kExact    expf(d)                              carry expf(m - m_new)
//   kPseudo   exp2f(d)                             carry exp2f(m - m_new)
//   kBase2    2^n * LUT[clamp(rint(v * 256))]      carry expf(m - m_new)
//   kPwl      2^n * chord of ROM over 16 segments  carry expf(m - m_new)
// (y = d * log2 e = n + v, n = floor(y)); masked keys weigh 0, never
// f(-inf).  kMaxOnly is a comparator carry: a slice whose best visible
// score beats the carry's strictly resets acc to the V row of its first
// such key and l to 1, so ties keep the earlier, lower position.  The
// LUT (256 entries) and the ROM (17) are f32 tables in shared memory,
// built by the caller from core.softmax_variants.base2_frac_lut and
// core.attn_approx.pwl_lut.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;

// Score modes, as the C entry of paged_attention.cu numbers them.
constexpr int kExact = 0, kBase2 = 1, kPseudo = 2, kPwl = 3, kMaxOnly = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBase2Lut = 256;     // 2^8 entries: BASE2_PRECISION_BITS
constexpr int kPwlSegments = 16;   // PWL_SEGMENTS; the ROM has 17 entries

// f32 entries of the mode's table (0: none).
template <int MODE>
constexpr int kRomSize =
    MODE == kBase2 ? kBase2Lut : (MODE == kPwl ? kPwlSegments + 1 : 0);

// The mode's weight of d = s - m_new (finite, <= 0), rounding where the
// plain version rounds: the products are explicit so that nvcc fuses
// none of them into an FMA.
template <int MODE>
__device__ __forceinline__ float weight_exp(float d, const float* rom) {
  if constexpr (MODE == kExact) {
    return expf(d);
  } else if constexpr (MODE == kPseudo) {
    return exp2f(d);
  } else {
    const float y = __fmul_rn(d, kLog2e);
    const float n = floorf(y);
    const float v = y - n;  // in [0, 1)
    if constexpr (MODE == kBase2) {
      // round half to even, as jnp.round and torch.round do
      const int i = min(max((int)rintf(v * kBase2Lut), 0), kBase2Lut - 1);
      return __fmul_rn(exp2f(n), rom[i]);
    } else {
      const float pos = v * kPwlSegments;
      const int i = min(max((int)floorf(pos), 0), kPwlSegments - 1);
      const float t = pos - (float)i;
      const float lo = rom[i], hi = rom[i + 1];
      return __fmul_rn(exp2f(n), __fadd_rn(lo, __fmul_rn(hi - lo, t)));
    }
  }
}

// The carry's rescale for a running-max bump dm = m - m_new <= 0.
template <int MODE>
__device__ __forceinline__ float carry_scale(float dm) {
  if constexpr (MODE == kPseudo) return exp2f(dm);
  return expf(dm);
}

// Head-dim elements per lane.
template <int HD>
constexpr int kEpl = HD >= 32 ? HD / 32 : 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
struct alignas(sizeof(T) * N > 16 ? 16 : sizeof(T) * N) Vec {
  T v[N];
};

// N consecutive elements -> f32 registers, one vector load.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(x.v[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// The warp's query row (lane's slice), zero on lanes that hold none.
template <typename T, int HD>
__device__ __forceinline__ void load_query(const T* row, int lane,
                                           float (&qv)[kEpl<HD>]) {
  constexpr int EPL = kEpl<HD>;
#pragma unroll
  for (int e = 0; e < EPL; ++e) qv[e] = 0.f;
  if (lane < HD / EPL) load_floats<T, EPL>(row + lane * EPL, qv);
}

// Fold keys p0 .. p0 + STAGE - 1, staged as the (STAGE, HD) tiles ks and
// vs, into the carry (m, l, acc) of query qv under score mode MODE;
// visible(p) says whether key p counts, rom is the mode's table in
// shared memory (kRomSize<MODE> entries).  Every lane of the warp calls
// it.
template <typename T, int HD, int STAGE, int MODE = kExact,
          typename Visible>
__device__ __forceinline__ void fold_stage(const T* ks, const T* vs, int p0,
                                           int lane,
                                           const float (&qv)[kEpl<HD>],
                                           float (&acc)[kEpl<HD>], float& m,
                                           float& l, float scale,
                                           Visible visible,
                                           const float* rom = nullptr) {
  constexpr int EPL = kEpl<HD>;
  const bool lane_on = lane < HD / EPL;
  for (int j0 = 0; j0 < STAGE; j0 += 32) {
    // lane jj keeps the score of key p0 + j0 + jj
    float s_mine = -INFINITY;
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      float kr[EPL] = {};
      if (lane_on) load_floats<T, EPL>(ks + (j0 + jj) * HD + lane * EPL, kr);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) part = fmaf(qv[e], kr[e], part);
      part = warp_sum(part);
      if (lane == jj && visible(p0 + j0 + jj)) s_mine = part * scale;
    }
    const float smax = warp_max(s_mine);
    if (smax == -INFINITY) continue;  // warp-uniform: no visible key here
    if constexpr (MODE == kMaxOnly) {
      if (smax > m) {  // warp-uniform; a tie keeps the earlier winner
        // the first visible key at smax (invisible lanes hold -inf)
        const int jw = __ffs(__ballot_sync(kFull, s_mine == smax)) - 1;
        float vr[EPL] = {};
        if (lane_on) load_floats<T, EPL>(vs + (j0 + jw) * HD + lane * EPL, vr);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = vr[e];
        l = 1.f;
        m = smax;
      }
      continue;
    }
    const float m_new = fmaxf(m, smax);
    const float alpha = (m == -INFINITY) ? 0.f : carry_scale<MODE>(m - m_new);
    const float p_mine =
        (s_mine == -INFINITY) ? 0.f : weight_exp<MODE>(s_mine - m_new, rom);
    l = l * alpha + warp_sum(p_mine);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float pj = __shfl_sync(kFull, p_mine, jj);
      float vr[EPL] = {};
      if (lane_on) load_floats<T, EPL>(vs + (j0 + jj) * HD + lane * EPL, vr);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pj, vr[e], acc[e]);
    }
    m = m_new;
  }
}

// out_row[lane's slice] = acc / l in T.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* out_row, int lane,
                                          const float (&acc)[kEpl<HD>],
                                          float l) {
  constexpr int EPL = kEpl<HD>;
  if (lane >= HD / EPL) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    store_from_float(out_row + lane * EPL + e, acc[e] * inv);
}

}  // namespace attn
