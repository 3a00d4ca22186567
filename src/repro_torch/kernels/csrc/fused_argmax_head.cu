// The fused argmax LM head for Hopper (sm_90a): (argmax_v, max_v) of
// h @ W^T over the vocabulary without ever storing the (B, V) logits --
// the paper's comparator unit fused with the head matmul.
//
// Replaces the TPU kernel src/repro/kernels/fused_argmax_head.py
// (fused_argmax_head_with_value, pallas_call at :106, body _kernel at :34).
//
// Bound on the H100: memory.  At decode batch sizes the head is a skinny
// GEMM: every weight is read once and used for B multiply-adds, far below
// the card's ~295 flops per byte, so the least time is one read of W
// (V * D * 2 bytes in bf16) over the 3.35 TB/s of HBM.
//
// Design, right and simple first:
//   * W is the tied (V, D) row-major embedding, read in place (the head
//     never builds embed.T).  Pass 1 splits V into contiguous ranges, one
//     per thread block, enough blocks to cover every SM several times;
//   * a block stages up to BT rows of h in shared memory as f32, in a
//     lane-minor layout so every shared read is bank-conflict free; each
//     warp streams RV vocab rows at a time with 16-byte loads (RV loads in
//     flight per lane), so each staged h value feeds RV multiply-adds,
//     accumulating the BT x RV dots in f32 registers;
//   * each warp keeps a running (max, idx) per h row with a strict '>'
//     over increasing vocab ids; warps merge with "larger value, else
//     lower index", and each block writes one partial per h row;
//   * pass 2 reduces a row's partials with the same rule.  No atomics:
//     the result is deterministic and the lowest index wins every tie,
//     as jnp.argmax and torch.argmax do.
// What it leaves on the table: h rows beyond BT = 8 re-read W per chunk
// of 8, and W loads are plain vector loads (no TMA ring).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps per pass-1 block
constexpr int kRV = 4;             // vocab rows per warp iteration
constexpr int kReduceThreads = 256;

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

// h (B, D); w (V, D); partials (B, nsplit).
template <typename T, int BT>
__global__ void __launch_bounds__(kWarps * 32) argmax_partial_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int B, int D, int V,
    int rows_per_split, int nsplit) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ float hs[];  // (nit, VEC, BT, 32): lane-minor
  __shared__ float wbest[kWarps][BT];
  __shared__ int widx[kWarps][BT];

  const int nit = (D + 32 * VEC - 1) / (32 * VEC);
  const int r0 = blockIdx.y * BT;
  for (int i = threadIdx.x; i < nit * VEC * BT * 32; i += blockDim.x) {
    const int l = i % 32, r = (i / 32) % BT, k = (i / (32 * BT)) % VEC;
    const int it = i / (32 * BT * VEC);
    const int c = (it * 32 + l) * VEC + k;
    const int row = r0 + r;
    hs[i] = (row < B && c < D) ? to_float(h[(size_t)row * D + c]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v_begin = blockIdx.x * rows_per_split;
  const int v_end = min(V, v_begin + rows_per_split);
  float best[BT];
  int bidx[BT];
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    best[r] = -INFINITY;
    bidx[r] = -1;
  }

  for (int v0 = v_begin + warp * kRV; v0 < v_end; v0 += kWarps * kRV) {
    float acc[kRV][BT];
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
    for (int i = 0; i < kRV; ++i) {
      if (v0 + i >= v_end) break;  // warp-uniform
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float s = warp_sum(acc[i][r]);
        if (s > best[r]) {  // strict: the earlier (lower) id keeps a tie
          best[r] = s;
          bidx[r] = v0 + i;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      wbest[warp][r] = best[r];
      widx[warp][r] = bidx[r];
    }
  }
  __syncthreads();
  if (threadIdx.x < BT) {
    const int r = threadIdx.x;
    float bv = -INFINITY;
    int bi = -1;
    for (int wi = 0; wi < kWarps; ++wi) {
      if (better(wbest[wi][r], widx[wi][r], bv, bi)) {
        bv = wbest[wi][r];
        bi = widx[wi][r];
      }
    }
    if (r0 + r < B) {
      pval[(size_t)(r0 + r) * nsplit + blockIdx.x] = bv;
      pidx[(size_t)(r0 + r) * nsplit + blockIdx.x] = bi;
    }
  }
}

// One block per h row: reduce the row's nsplit partials.
__global__ void __launch_bounds__(kReduceThreads) argmax_reduce_kernel(
    const float* __restrict__ pval, const int* __restrict__ pidx, int nsplit,
    int* __restrict__ out_idx, float* __restrict__ out_val) {
  __shared__ float sv[kReduceThreads];
  __shared__ int si[kReduceThreads];
  const int row = blockIdx.x, tid = threadIdx.x;
  float bv = -INFINITY;
  int bi = -1;
  for (int s = tid; s < nsplit; s += kReduceThreads) {
    const float v = pval[(size_t)row * nsplit + s];
    const int i = pidx[(size_t)row * nsplit + s];
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
  sv[tid] = bv;
  si[tid] = bi;
  __syncthreads();
  for (int off = kReduceThreads / 2; off > 0; off >>= 1) {
    if (tid < off && better(sv[tid + off], si[tid + off], sv[tid], si[tid])) {
      sv[tid] = sv[tid + off];
      si[tid] = si[tid + off];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out_idx[row] = si[0] < 0 ? 0 : si[0];
    out_val[row] = sv[0];
  }
}

template <typename T, int BT>
cudaError_t launch(const void* h, const void* w, void* pval, void* pidx,
                   void* out_idx, void* out_val, int B, int D, int V,
                   int nsplit, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nit = (D + 32 * VEC - 1) / (32 * VEC);
  const size_t smem = (size_t)nit * VEC * BT * 32 * sizeof(float);
  auto kernel = argmax_partial_kernel<T, BT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int rows_per_split = (V + nsplit - 1) / nsplit;
  const dim3 grid(nsplit, (B + BT - 1) / BT);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<float*>(pval), static_cast<int*>(pidx), B, D, V,
      rows_per_split, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  argmax_reduce_kernel<<<B, kReduceThreads, 0, stream>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      static_cast<int*>(out_idx), static_cast<float*>(out_val));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* h, const void* w, void* pval, void* pidx,
                     void* out_idx, void* out_val, int B, int D, int V,
                     int nsplit, cudaStream_t s) {
  if (B >= 8) return launch<T, 8>(h, w, pval, pidx, out_idx, out_val, B, D, V, nsplit, s);
  if (B >= 4) return launch<T, 4>(h, w, pval, pidx, out_idx, out_val, B, D, V, nsplit, s);
  if (B >= 2) return launch<T, 2>(h, w, pval, pidx, out_idx, out_val, B, D, V, nsplit, s);
  return launch<T, 1>(h, w, pval, pidx, out_idx, out_val, B, D, V, nsplit, s);
}

}  // namespace

// h (B, D) and w (V, D), both row-major of one dtype (0 = float32,
// 1 = bfloat16), D a multiple of 16 bytes' worth of elements.
// pval/pidx: (B, nsplit) f32/i32 scratch.  out_idx (B,) i32,
// out_val (B,) f32.  Returns a cudaError_t.
extern "C" int repro_fused_argmax_head(const void* h, const void* w,
                                       void* pval, void* pidx, void* out_idx,
                                       void* out_val, int B, int D, int V,
                                       int nsplit, int dtype, void* stream) {
  if (B <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || nsplit > V)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return (int)dispatch<__nv_bfloat16>(h, w, pval, pidx, out_idx, out_val, B,
                                        D, V, nsplit, s);
  }
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;
    return (int)dispatch<float>(h, w, pval, pidx, out_idx, out_val, B, D, V,
                                nsplit, s);
  }
  return (int)cudaErrorInvalidValue;
}
