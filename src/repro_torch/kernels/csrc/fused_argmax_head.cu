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
//   * a block stages up to BT rows of h in shared memory and each warp
//     streams RV vocab rows at a time against them (head_tile.cuh, shared
//     with the top-k head), accumulating the BT x RV dots in f32;
//   * each warp keeps a running (max, idx) per h row with a strict '>'
//     over increasing vocab ids; warps merge with "larger value, else
//     lower index", and each block writes one partial per h row;
//   * pass 2 reduces a row's partials with the same rule.  No atomics:
//     the result is deterministic and the lowest index wins every tie,
//     as jnp.argmax and torch.argmax do.
// What it leaves on the table: h rows beyond BT = 8 re-read W per chunk
// of 8, and W loads are plain vector loads (no TMA ring).
//
// The speculative verify head (repro_fused_verify_head) is the same pass 1
// over the flattened (B*T, D) position rows -- Theorem 1 applied at every
// draft position -- and replaces src/repro/kernels/fused_topk_head.py
// (fused_verify_head, :170).  Its pass 2 reduces the T rows of one batch
// row per block and then computes the accepted draft length on the card:
// one warp takes a ballot of ids[b, i] == cand[b, i] over each 32
// positions and counts the leading run (a prefix AND).  The -1 padding of
// a ragged draft never equals an id.  At B*T = 64 rows pass 1 reads W
// eight times (the BT = 8 chunking above); the bound is still one read.
#include "head_tile.cuh"

namespace {

using head::better;
using head::kFull;
using head::kRV;
using head::kWarps;
constexpr int kReduceThreads = 256;

// h (B, D); w (V, D); partials (B, nsplit).
template <typename T, int BT>
__global__ void __launch_bounds__(kWarps * 32) argmax_partial_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int B, int D, int V,
    int rows_per_split, int nsplit) {
  extern __shared__ float hs[];  // staged h rows (head_tile.cuh)
  __shared__ float wbest[kWarps][BT];
  __shared__ int widx[kWarps][BT];

  const int r0 = blockIdx.y * BT;
  head::stage_h<T, BT>(h, hs, B, D, r0);

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
    head::dot_tile<T, BT>(hs, w, D, v0, v_end, lane, acc);
#pragma unroll
    for (int i = 0; i < kRV; ++i) {
      if (v0 + i >= v_end) break;  // warp-uniform
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        const float s = acc[i][r];
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

// One block per batch row b: warp t reduces the partials of h row
// b * T + t, then warp 0 counts the leading run of ids == cand.
__global__ void __launch_bounds__(kReduceThreads) verify_reduce_kernel(
    const float* __restrict__ pval, const int* __restrict__ pidx, int nsplit,
    int T, const int* __restrict__ cand, int* __restrict__ out_ids,
    int* __restrict__ out_accept) {
  extern __shared__ int ids_s[];  // (T)
  const int b = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t = warp; t < T; t += kReduceThreads / 32) {
    const size_t row = (size_t)b * T + t;
    float bv = -INFINITY;
    int bi = -1, unused = 0;
    for (int s = lane; s < nsplit; s += 32) {
      const float v = pval[row * nsplit + s];
      const int i = pidx[row * nsplit + s];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    head::warp_best(bv, bi, unused);
    if (lane == 0) {
      out_ids[row] = bi < 0 ? 0 : bi;
      ids_s[t] = bi < 0 ? 0 : bi;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int k = T - 1;  // draft positions
    int run = 0;
    for (int base = 0; base < k; base += 32) {  // warp-uniform trip count
      const int i = base + lane;
      const bool ok = i < k && ids_s[i] == cand[(size_t)b * k + i];
      const unsigned hits = __ballot_sync(kFull, ok);
      if (hits != kFull) {
        run += __ffs(~hits) - 1;  // leading ones of the ballot
        break;
      }
      run += 32;
    }
    if (lane == 0) out_accept[b] = run;
  }
}

template <typename T, int BT>
cudaError_t launch_partial(const void* h, const void* w, void* pval,
                           void* pidx, int B, int D, int V, int nsplit,
                           cudaStream_t stream) {
  const size_t smem = (size_t)head::staged_floats<T, BT>(D) * sizeof(float);
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
  return cudaGetLastError();
}

template <typename T>
cudaError_t partial(const void* h, const void* w, void* pval, void* pidx,
                    int B, int D, int V, int nsplit, cudaStream_t s) {
  if (B >= 8) return launch_partial<T, 8>(h, w, pval, pidx, B, D, V, nsplit, s);
  if (B >= 4) return launch_partial<T, 4>(h, w, pval, pidx, B, D, V, nsplit, s);
  if (B >= 2) return launch_partial<T, 2>(h, w, pval, pidx, B, D, V, nsplit, s);
  return launch_partial<T, 1>(h, w, pval, pidx, B, D, V, nsplit, s);
}

// Pass 1 for dtype 0 (float32) or 1 (bfloat16); D a multiple of 16 bytes'
// worth of elements.
cudaError_t partial_any(const void* h, const void* w, void* pval, void* pidx,
                        int B, int D, int V, int nsplit, int dtype,
                        cudaStream_t s) {
  if (B <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || nsplit > V)
    return cudaErrorInvalidValue;
  if (dtype == 1 && D % 8 == 0)
    return partial<__nv_bfloat16>(h, w, pval, pidx, B, D, V, nsplit, s);
  if (dtype == 0 && D % 4 == 0)
    return partial<float>(h, w, pval, pidx, B, D, V, nsplit, s);
  return cudaErrorInvalidValue;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = partial_any(h, w, pval, pidx, B, D, V, nsplit, dtype, s);
  if (err != cudaSuccess) return (int)err;
  argmax_reduce_kernel<<<B, kReduceThreads, 0, s>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      static_cast<int*>(out_idx), static_cast<float*>(out_val));
  return (int)cudaGetLastError();
}

// The speculative verify head.  h (B*T, D) -- the (B, T, D) position rows
// flattened -- and w as above; cand (B, T-1) i32 draft ids, -1 past each
// row's width.  pval/pidx: (B*T, nsplit) scratch.  out_ids (B, T) i32 =
// argmax per position; out_accept (B,) i32 = leading run of
// out_ids[:, :T-1] == cand.  Returns a cudaError_t.
extern "C" int repro_fused_verify_head(const void* h, const void* w,
                                       const void* cand, void* pval,
                                       void* pidx, void* out_ids,
                                       void* out_accept, int B, int T, int D,
                                       int V, int nsplit, int dtype,
                                       void* stream) {
  if (B <= 0 || T <= 0 || T > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      partial_any(h, w, pval, pidx, B * T, D, V, nsplit, dtype, s);
  if (err != cudaSuccess) return (int)err;
  verify_reduce_kernel<<<B, kReduceThreads, (size_t)T * sizeof(int), s>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      T, static_cast<const int*>(cand), static_cast<int*>(out_ids),
      static_cast<int*>(out_accept));
  return (int)cudaGetLastError();
}
