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
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;

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
// vs, into the carry (m, l, acc) of query qv; visible(p) says whether key
// p counts.  Every lane of the warp calls it.
template <typename T, int HD, int STAGE, typename Visible>
__device__ __forceinline__ void fold_stage(const T* ks, const T* vs, int p0,
                                           int lane,
                                           const float (&qv)[kEpl<HD>],
                                           float (&acc)[kEpl<HD>], float& m,
                                           float& l, float scale,
                                           Visible visible) {
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
    const float m_new = fmaxf(m, smax);
    const float alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
    const float p_mine = (s_mine == -INFINITY) ? 0.f : expf(s_mine - m_new);
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
