// The CUDA-core pass 1 of the vocabulary-split head kernels -- the top-k
// head (fused_topk_head.cu) and the f32 route of the argmax and verify heads
// (fused_argmax_head.cu; bf16 runs their tensor-core tile): h rows staged
// in shared memory, and one warp's tile of dot products with kRV rows of
// the (V, D) row-major head weight.  Also the comparator helpers (better,
// warp_best) that every head kernel merges with.
//
// A block stages up to BT rows of h as f32 in a lane-minor layout, so
// every shared read of a warp is bank-conflict free; each warp then
// streams kRV vocab rows at a time with 16-byte loads (kRV loads in
// flight per lane), so each staged h value feeds kRV multiply-adds, and
// accumulates the BT x kRV dots in f32 registers.  The order of every sum
// depends on D only, so equal vocab rows give bit-equal logits.
//
// The staged rows take 4 * BT * D bytes of shared memory (rounded up), so
// the wrappers pick BT per call: the largest of {8, 4, 2, 1}, at most the
// row count, whose staging fits the card's opt-in limit (less 2 KB for a
// kernel's static shared memory).  opt_in raises a kernel's dynamic shared
// memory ceiling to that limit once per device, instead of an attribute
// call before every launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace head {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps per pass-1 block
constexpr int kRV = 4;     // vocab rows per warp iteration

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// (v1, i1) beats (v2, i2): larger value, or equal value and lower index.
// An index < 0 marks "no candidate".
__device__ __forceinline__ bool better(float v1, int i1, float v2, int i2) {
  if (i1 < 0) return false;
  if (i2 < 0) return true;
  return v1 > v2 || (v1 == v2 && i1 < i2);
}

// Butterfly reduce of (value, index, tag) over the warp with `better`: a
// strict total order on (value, index), so every lane ends with the same
// winner and its tag.
__device__ __forceinline__ void warp_best(float& v, int& i, int& tag) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int oi = __shfl_xor_sync(kFull, i, o);
    const int ot = __shfl_xor_sync(kFull, tag, o);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      tag = ot;
    }
  }
}

constexpr int kMaxDevices = 64;

// The device's opt-in shared memory per block, in bytes (0 on error), read
// once per device.
inline int smem_optin(int dev) {
  static std::atomic<int> cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 0;
  int v = cache[dev].load(std::memory_order_relaxed);
  if (v > 0) return v;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  cache[dev].store(v, std::memory_order_relaxed);
  return v;
}

// The dynamic shared memory a kernel instance may ask for on each device
// (0: not set yet); one static per instance.
struct OptIn {
  std::atomic<int> max_dynamic[kMaxDevices];
};

// Let `kernel` launch with the current device's opt-in shared memory less
// its static shared memory: one attribute call per (kernel, device),
// remembered in `state`.  Fails with cudaErrorInvalidValue when `smem`
// bytes of dynamic shared memory exceed that.
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem, OptIn& state) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  int max_dynamic = state.max_dynamic[dev].load(std::memory_order_relaxed);
  if (max_dynamic == 0) {
    const int limit = smem_optin(dev);
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (limit <= (int)attr.sharedSizeBytes) return cudaErrorInvalidValue;
    max_dynamic = limit - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_dynamic);
    if (err != cudaSuccess) return err;
    state.max_dynamic[dev].store(max_dynamic, std::memory_order_relaxed);
  }
  return smem <= (size_t)max_dynamic ? cudaSuccess : cudaErrorInvalidValue;
}

// Floats of shared memory that stage_h fills: (nit, VEC, BT, 32).
template <typename T, int BT>
__host__ __device__ inline int staged_floats(int D) {
  constexpr int VEC = 16 / sizeof(T);
  return (D + 32 * VEC - 1) / (32 * VEC) * VEC * BT * 32;
}

// Rows [r0, r0 + BT) of h (B, D) into hs as f32; rows past B and columns
// past D read as 0.  The whole block takes part; ends with a barrier.
template <typename T, int BT>
__device__ void stage_h(const T* __restrict__ h, float* hs, int B, int D,
                        int r0) {
  constexpr int VEC = 16 / sizeof(T);
  const int n = staged_floats<T, BT>(D);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int l = i % 32, r = (i / 32) % BT, k = (i / (32 * BT)) % VEC;
    const int it = i / (32 * BT * VEC);
    const int c = (it * 32 + l) * VEC + k;
    const int row = r0 + r;
    hs[i] = (row < B && c < D) ? to_float(h[(size_t)row * D + c]) : 0.f;
  }
  __syncthreads();
}

// One warp: acc[i][r] = dot(h row r, W row v0 + i) for i < kRV, the full
// sum in every lane; W rows at or past v_end read as 0.
template <typename T, int BT>
__device__ __forceinline__ void dot_tile(const float* hs,
                                         const T* __restrict__ w, int D,
                                         int v0, int v_end, int lane,
                                         float (&acc)[kRV][BT]) {
  constexpr int VEC = 16 / sizeof(T);
  const int nit = (D + 32 * VEC - 1) / (32 * VEC);
#pragma unroll
  for (int i = 0; i < kRV; ++i)
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[i][r] = 0.f;
  for (int it = 0; it < nit; ++it) {
    const int c = (it * 32 + lane) * VEC;
    Vec16<T> wv[kRV];
#pragma unroll
    for (int i = 0; i < kRV; ++i) {
      if (v0 + i < v_end && c < D) {
        wv[i] = *reinterpret_cast<const Vec16<T>*>(w + (size_t)(v0 + i) * D + c);
      } else {
        *reinterpret_cast<uint4*>(&wv[i]) = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float hv = hs[((it * VEC + k) * BT + r) * 32 + lane];
#pragma unroll
        for (int i = 0; i < kRV; ++i)
          acc[i][r] = fmaf(to_float(wv[i].v[k]), hv, acc[i][r]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRV; ++i)
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[i][r] = warp_sum(acc[i][r]);
}

}  // namespace head
