// Shared inner loop of the attention kernels (paged_attention.cu,
// flash_attention.cu's f32 route): one warp per query row carries the
// online softmax (m, l, acc) in f32 registers over K/V tiles staged in
// shared memory.
//
// The warp's query row sits in shared memory as f32 (stage_query).  Over
// each 32-key slice of a staged tile, lane jj computes the whole score
// of key jj: a dot product over the head dim in f32, the key's row read
// 16 bytes at a time and the query broadcast.  Staged rows are padded by
// 16 bytes (row stride LD = HD + 16 / sizeof(T) elements), so the 8
// lanes of each quarter-warp read 8 different bank groups.  A key the
// caller's `visible` rejects scores -inf, and a slice with no visible key
// leaves the carry alone (the test is warp-uniform).  For P.V, lane l
// holds head-dim elements [l * EPL, (l + 1) * EPL) of acc (below HD = 32
// only the first HD lanes hold any) and takes each key's weight by a
// shuffle.  A query with no visible key at all writes 0: l is clamped at
// 1e-30, as the TPU kernels do.
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
//
// The header also holds the 16-byte cp.async helpers with which both
// kernels stage their K/V tiles, double-buffered.
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

// 16-byte asynchronous copy global -> shared (cp.async.cg, through L2
// only); with pred false it reads nothing and zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Elements of a staged K/V row, padded by 16 bytes (see the header).
template <typename T, int HD>
constexpr int kLd = HD + 16 / (int)sizeof(T);

// The warp's query row -> qs (HD f32 in shared memory, 16-byte aligned);
// every lane of the warp calls it.
template <typename T, int HD>
__device__ __forceinline__ void stage_query(const T* row, int lane,
                                            float* qs) {
  for (int d = lane; d < HD; d += 32) qs[d] = to_float(row[d]);
  __syncwarp();
}

// Fold keys p0 .. p0 + STAGE - 1, staged as the (STAGE, LD) tiles ks and
// vs (LD = kLd<T, HD>), into the carry (m, l, acc) of the query row qs
// (stage_query) under score mode MODE; visible(p) says whether key p
// counts, rom is the mode's table in shared memory (kRomSize<MODE>
// entries).  Every lane of the warp calls it.
template <typename T, int HD, int STAGE, int MODE = kExact,
          typename Visible>
__device__ __forceinline__ void fold_stage(const T* ks, const T* vs, int p0,
                                           int lane, const float* qs,
                                           float (&acc)[kEpl<HD>], float& m,
                                           float& l, float scale,
                                           Visible visible,
                                           const float* rom = nullptr) {
  constexpr int EPL = kEpl<HD>;
  constexpr int LD = kLd<T, HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte read
  const bool lane_on = lane < HD / EPL;
  for (int j0 = 0; j0 < STAGE; j0 += 32) {
    // lane jj scores key p0 + j0 + jj
    const T* kr = ks + (j0 + lane) * LD;
    float dot = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += VEC) {
      float kf[VEC], qf[VEC];
      load_floats<T, VEC>(kr + d, kf);
      load_floats<float, VEC>(qs + d, qf);
#pragma unroll
      for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
    }
    const float s_mine = visible(p0 + j0 + lane) ? dot * scale : -INFINITY;
    const float smax = warp_max(s_mine);
    if (smax == -INFINITY) continue;  // warp-uniform: no visible key here
    if constexpr (MODE == kMaxOnly) {
      if (smax > m) {  // warp-uniform; a tie keeps the earlier winner
        // the first visible key at smax (invisible lanes hold -inf)
        const int jw = __ffs(__ballot_sync(kFull, s_mine == smax)) - 1;
        float vr[EPL] = {};
        if (lane_on) load_floats<T, EPL>(vs + (j0 + jw) * LD + lane * EPL, vr);
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
      if (lane_on) load_floats<T, EPL>(vs + (j0 + jj) * LD + lane * EPL, vr);
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
