// The full softmax unit for Hopper (sm_90a): the paper's baseline, in
// the two phases of the TPU kernels, plus the cross-entropy head that
// shares phase 1.
//
// Replaces the TPU kernels
//   src/repro/kernels/online_softmax.py  softmax_stats (:69, pallas_call
//     :82, body _stats_kernel :26) -- per-row (m, l) = (max, sum exp(x -
//     max)) by one online pass;
//   src/repro/kernels/online_softmax.py  online_softmax (:106,
//     pallas_call :121, body _normalize_kernel :53) -- exp(x - m) / l;
//   src/repro/kernels/fused_xent.py      fused_xent (:59, pallas_call
//     :75, body _xent_kernel :24) -- m + log l - x[label] per row.
//
// Bound on the H100: memory.  Each phase reads x once (and phase 2
// writes the (B, V) f32 probabilities once) for a handful of flops and
// one exp per element, far below the card's flops per byte.
//
// Design, right and simple first:
//   * phase 1 splits each row's V over `nsplit` thread blocks, enough to
//     cover the SMs several times at decode batch sizes (one block per
//     row would leave most of the 132 SMs idle at B = 12, V = 151936);
//     each thread carries an online (m, l) over its elements, loaded 16
//     bytes at a time where the row allows, and the block merges its
//     threads' pairs in a fixed tree;
//   * a second small kernel merges a row's nsplit partials in split
//     order, l = sum_i l_i * exp(m_i - m): no atomics, so the result is
//     deterministic.  The cross-entropy entry runs the same phase 1 and
//     a merge that also reads the label logit once (exactly one column
//     hits, so it equals the TPU kernel's masked sum) and writes
//     m + log l - x[label];
//   * phase 2 is one elementwise pass, exp(x - m) / l in f32;
//   * rows sit on grid.y, at most 65,535 of them per launch; the phase-1
//     and phase-2 blocks stride over the rows beyond (a training batch's
//     B * T rows), so any row count takes one launch, as the TPU kernels'
//     row tiling does.
// What it leaves for later PRs: online_softmax reads x twice (phase 1,
// then phase 2), as the TPU kernels do; a one-pass form would keep each
// block's slice of x on chip between the phases.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;  // rows beyond it stride in the kernels

int grid_rows(int B) { return B < kMaxGridY ? B : kMaxGridY; }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Fold one element into an online (m, l) pair.
__device__ __forceinline__ void fold(float x, float& m, float& l) {
  if (x > m) {
    l = (m == -INFINITY ? 0.f : l * expf(m - x)) + 1.f;
    m = x;
  } else if (x != -INFINITY) {
    l += expf(x - m);
  }
}

// Merge pair (m2, l2) into (m, l); an empty pair is (-inf, 0).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

__device__ __forceinline__ void warp_merge(float& m, float& l) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float l2 = __shfl_xor_sync(kFull, l, o);
    merge(m, l, m2, l2);
  }
}

// Phase 1: block (split, row) folds x[row, begin:end) into one (m, l)
// partial.  VEC elements per load; row starts and split bounds are
// multiples of VEC.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) stats_partial_kernel(
    const T* __restrict__ x, float* __restrict__ pm, float* __restrict__ pl,
    int B, int V, int per_split, int nsplit) {
  __shared__ float wm[kThreads / 32], wl[kThreads / 32];
  const int split = blockIdx.x;
  const int begin = split * per_split;
  const int end = max(begin, min(V, begin + per_split));
  const int nvec = (end - begin) / VEC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows stride by gridDim.y (at most 65,535), so any B takes one launch
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    const T* xr = x + (size_t)row * V;
    float m = -INFINITY, l = 0.f;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      const Vec<T, VEC> c =
          *reinterpret_cast<const Vec<T, VEC>*>(xr + begin + i * VEC);
#pragma unroll
      for (int e = 0; e < VEC; ++e) fold(to_float(c.v[e]), m, l);
    }
    for (int j = begin + nvec * VEC + threadIdx.x; j < end; j += kThreads)
      fold(to_float(xr[j]), m, l);
    warp_merge(m, l);
    if (lane == 0) {
      wm[warp] = m;
      wl[warp] = l;
    }
    __syncthreads();
    if (warp == 0) {
      m = lane < kThreads / 32 ? wm[lane] : -INFINITY;
      l = lane < kThreads / 32 ? wl[lane] : 0.f;
      warp_merge(m, l);
      if (lane == 0) {
        pm[(size_t)row * nsplit + split] = m;
        pl[(size_t)row * nsplit + split] = l;
      }
    }
    __syncthreads();  // wm / wl are free for the next row
  }
}

// One warp per row: merge the row's nsplit partials, lane by lane in
// split order, then across lanes in a fixed tree.
__device__ __forceinline__ void merge_row(const float* __restrict__ pm,
                                         const float* __restrict__ pl,
                                         int nsplit, int row, int lane,
                                         float& m, float& l) {
  m = -INFINITY;
  l = 0.f;
  for (int s = lane; s < nsplit; s += 32)
    merge(m, l, pm[(size_t)row * nsplit + s], pl[(size_t)row * nsplit + s]);
  warp_merge(m, l);
}

__global__ void __launch_bounds__(kThreads) stats_merge_kernel(
    const float* __restrict__ pm, const float* __restrict__ pl, int nsplit,
    int B, float* __restrict__ m_out, float* __restrict__ l_out) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // warp-uniform
  float m, l;
  merge_row(pm, pl, nsplit, row, lane, m, l);
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) xent_merge_kernel(
    const float* __restrict__ pm, const float* __restrict__ pl, int nsplit,
    int B, const T* __restrict__ x, int V, const long long* __restrict__ lab,
    float* __restrict__ loss) {
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= B) return;  // warp-uniform
  float m, l;
  merge_row(pm, pl, nsplit, row, lane, m, l);
  if (lane == 0)
    loss[row] = m + logf(l) - to_float(x[(size_t)row * V + lab[row]]);
}

// Phase 2: out[row, j] = exp(x[row, j] - m[row]) / l[row], f32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) normalize_kernel(
    const T* __restrict__ x, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ out, int B, int V) {
  constexpr int SV = VEC < 4 ? VEC : 4;  // f32 elements per store
  const int nvec = V / VEC;
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    const float m = m_in[row], l = l_in[row];
    const T* xr = x + (size_t)row * V;
    float* orow = out + (size_t)row * V;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < nvec;
         i += gridDim.x * kThreads) {
      const Vec<T, VEC> c =
          *reinterpret_cast<const Vec<T, VEC>*>(xr + i * VEC);
      Vec<float, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = expf(to_float(c.v[e]) - m) / l;
#pragma unroll
      for (int e = 0; e < VEC; e += SV)  // 16-byte stores
        *reinterpret_cast<Vec<float, SV>*>(orow + i * VEC + e) =
            *reinterpret_cast<const Vec<float, SV>*>(o.v + e);
    }
    for (int j = nvec * VEC + blockIdx.x * kThreads + threadIdx.x; j < V;
         j += gridDim.x * kThreads)
      orow[j] = expf(to_float(xr[j]) - m) / l;
  }
}

// Vector width in elements: 16 bytes when every row start (and so every
// split bound, a multiple of 16 bytes' worth) is aligned, else 1.
template <typename T>
int vec_of(const void* x, int V) {
  const int vec = 16 / (int)sizeof(T);
  return (V % vec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) ? vec : 1;
}

template <typename T>
cudaError_t stats_partial(const void* x, float* pm, float* pl, int B, int V,
                          int nsplit, cudaStream_t s) {
  const int vec = vec_of<T>(x, V);
  // split bounds on 16-byte multiples, so each split's vector loads align
  const int step = 16 / (int)sizeof(T);
  const int per_split = ((V + nsplit - 1) / nsplit + step - 1) / step * step;
  const dim3 grid(nsplit, grid_rows(B));
  if (vec > 1)
    stats_partial_kernel<T, (int)(16 / sizeof(T))><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), pm, pl, B, V, per_split, nsplit);
  else
    stats_partial_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), pm, pl, B, V, per_split, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t normalize(const void* x, const float* m, const float* l,
                      float* out, int B, int V, cudaStream_t s) {
  const int vec = vec_of<T>(x, V);
  const int per_block = kThreads * vec * 4;  // four loads per thread
  const dim3 grid((V + per_block - 1) / per_block, grid_rows(B));
  if (vec > 1)
    normalize_kernel<T, (int)(16 / sizeof(T))><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), m, l, out, B, V);
  else
    normalize_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), m, l, out, B, V);
  return cudaGetLastError();
}

bool bad_shape(int B, int V, int nsplit) {
  return B <= 0 || V <= 0 || nsplit <= 0 || nsplit > V;
}

}  // namespace

// x (B, V) row-major of dtype 0 = float32, 1 = bfloat16, 2 = float16.
// pm/pl: (B, nsplit) f32 scratch; m_out/l_out (B,) f32.  Returns a
// cudaError_t.
extern "C" int repro_softmax_stats(const void* x, void* pm, void* pl,
                                   void* m_out, void* l_out, int B, int V,
                                   int nsplit, int dtype, void* stream) {
  if (bad_shape(B, V, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *fm = static_cast<float*>(pm), *fl = static_cast<float*>(pl);
  cudaError_t err = dtype == 0 ? stats_partial<float>(x, fm, fl, B, V, nsplit, s)
                    : dtype == 1
                        ? stats_partial<__nv_bfloat16>(x, fm, fl, B, V, nsplit, s)
                    : dtype == 2 ? stats_partial<__half>(x, fm, fl, B, V, nsplit, s)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  stats_merge_kernel<<<(B + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                       s>>>(fm, fl, nsplit, B, static_cast<float*>(m_out),
                            static_cast<float*>(l_out));
  return (int)cudaGetLastError();
}

// Phase 2 over x (B, V) as above with its row stats m, l (B,) f32;
// out (B, V) f32.  Returns a cudaError_t.
extern "C" int repro_softmax_normalize(const void* x, const void* m,
                                       const void* l, void* out, int B, int V,
                                       int dtype, void* stream) {
  if (bad_shape(B, V, 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fm = static_cast<const float*>(m),
              *fl = static_cast<const float*>(l);
  float* fo = static_cast<float*>(out);
  cudaError_t err = dtype == 0   ? normalize<float>(x, fm, fl, fo, B, V, s)
                    : dtype == 1 ? normalize<__nv_bfloat16>(x, fm, fl, fo, B, V, s)
                    : dtype == 2 ? normalize<__half>(x, fm, fl, fo, B, V, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// Cross-entropy per row: loss (B,) f32 = m + log l - x[row, lab[row]],
// lab (B,) int64 in [0, V) (not checked here).  x, pm, pl as for
// repro_softmax_stats.  Returns a cudaError_t.
extern "C" int repro_fused_xent(const void* x, const void* lab, void* pm,
                                void* pl, void* loss, int B, int V,
                                int nsplit, int dtype, void* stream) {
  if (bad_shape(B, V, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float *fm = static_cast<float*>(pm), *fl = static_cast<float*>(pl);
  const dim3 grid((B + kThreads / 32 - 1) / (kThreads / 32));
  const long long* lb = static_cast<const long long*>(lab);
  float* out = static_cast<float*>(loss);
  cudaError_t err;
  if (dtype == 0) {
    err = stats_partial<float>(x, fm, fl, B, V, nsplit, s);
    if (err != cudaSuccess) return (int)err;
    xent_merge_kernel<float><<<grid, kThreads, 0, s>>>(
        fm, fl, nsplit, B, static_cast<const float*>(x), V, lb, out);
  } else if (dtype == 1) {
    err = stats_partial<__nv_bfloat16>(x, fm, fl, B, V, nsplit, s);
    if (err != cudaSuccess) return (int)err;
    xent_merge_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        fm, fl, nsplit, B, static_cast<const __nv_bfloat16*>(x), V, lb, out);
  } else if (dtype == 2) {
    err = stats_partial<__half>(x, fm, fl, B, V, nsplit, s);
    if (err != cudaSuccess) return (int)err;
    xent_merge_kernel<__half><<<grid, kThreads, 0, s>>>(
        fm, fl, nsplit, B, static_cast<const __half*>(x), V, lb, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
