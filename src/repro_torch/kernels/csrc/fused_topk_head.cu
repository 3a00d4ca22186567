// The fused top-k comparator head for Hopper (sm_90a): the k largest
// (value, index) pairs of h @ W^T over the vocabulary without storing the
// (B, V) logits -- the paper's comparator unit widened to a k-winner
// selection network (still no exp, no sum, no divide; a sampler then runs
// an O(k) softmax over the survivors on the host).
//
// Replaces the TPU kernel src/repro/kernels/fused_topk_head.py
// (fused_topk_head, pallas_call at :144, body _kernel at :66).
//
// Output contract (repro.kernels.ref.topk_select): values descending, and
// among equal values the LOWER vocab index first -- the order of k stable
// selection passes, which torch.topk does not promise.
//
// Bound on the H100: memory, as for the argmax head.  At decode batch
// sizes every weight is read once and used for B multiply-adds, so the
// least time is one read of W (V * D * 2 bytes in bf16) over 3.35 TB/s.
//
// Design, right and simple first:
//   * pass 1 is the argmax kernel's vocab split: one thread block per
//     contiguous vocab range, h rows (up to BT = 8) staged in shared
//     memory, each warp streaming RV vocab rows against them with f32
//     accumulation (head_tile.cuh, shared with the argmax head).  The
//     block keeps its range's BT x rows logits in shared memory (never in
//     HBM), then one warp per h row picks the range's top k by k
//     selection passes.  A
//     pass takes the best entry STRICTLY AFTER the previous pick in the
//     order (value descending, index ascending), so no entry is marked or
//     copied and -inf logits still sort by index.  Each block writes one
//     sorted partial list of k (value, index) pairs per h row, padded
//     with index -1 when its range holds fewer than k ids;
//   * pass 2, one block per h row, merges the nsplit sorted lists: k
//     rounds, each taking the best list head by "larger value, else lower
//     index" and advancing that list.  No atomics: the result is
//     deterministic and matches k stable selection passes exactly.
// What it leaves on the table: h rows beyond BT = 8 re-read W per chunk
// of 8, W loads are plain vector loads (no TMA ring), and the merge's k
// rounds each synchronise the block twice.
#include "head_tile.cuh"

namespace {

using head::better;
using head::kRV;
using head::kWarps;
using head::warp_best;
constexpr int kMergeThreads = 256;
constexpr int kMaxK = 64;          // MAX_TOP_K of the samplers
constexpr int kMaxRowsPerSplit = 4096;

// h (B, D); w (V, D); partial lists (B, nsplit, K) of (value, index).
template <typename T, int BT>
__global__ void __launch_bounds__(kWarps * 32) topk_partial_kernel(
    const T* __restrict__ h, const T* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int B, int D, int V,
    int K, int rows_per_split, int nsplit) {
  extern __shared__ float smem[];
  float* hs = smem;                                 // staged h rows
  float* lg = smem + head::staged_floats<T, BT>(D);  // (BT, rows_per_split)

  const int r0 = blockIdx.y * BT;
  head::stage_h<T, BT>(h, hs, B, D, r0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v_begin = blockIdx.x * rows_per_split;
  const int v_end = min(V, v_begin + rows_per_split);
  const int n = max(0, v_end - v_begin);

  for (int v0 = v_begin + warp * kRV; v0 < v_end; v0 += kWarps * kRV) {
    float acc[kRV][BT];
    head::dot_tile<T, BT>(hs, w, D, v0, v_end, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kRV; ++i) {
        if (v0 + i >= v_end) break;
#pragma unroll
        for (int r = 0; r < BT; ++r)
          lg[r * rows_per_split + (v0 + i - v_begin)] = acc[i][r];
      }
    }
  }
  __syncthreads();

  // one warp per h row: k selection passes over the range's logits
  for (int r = warp; r < BT; r += kWarps) {
    const int row = r0 + r;
    if (row >= B) break;  // warp-uniform; later r are larger still
    const float* lr = lg + r * rows_per_split;
    float* ov = pval + ((size_t)row * nsplit + blockIdx.x) * K;
    int* oi = pidx + ((size_t)row * nsplit + blockIdx.x) * K;
    float pv = INFINITY;
    int pi = -1;  // no pick yet: every entry is eligible
    int p = 0;
    for (; p < K; ++p) {
      float bv = -INFINITY;
      int bi = -1, unused = 0;
      for (int j = lane; j < n; j += 32) {
        const float v = lr[j];
        const int id = v_begin + j;
        const bool after = pi < 0 || v < pv || (v == pv && id > pi);
        if (after && better(v, id, bv, bi)) {
          bv = v;
          bi = id;
        }
      }
      warp_best(bv, bi, unused);
      if (bi < 0) break;  // warp-uniform: the range is exhausted
      if (lane == 0) {
        ov[p] = bv;
        oi[p] = bi;
      }
      pv = bv;
      pi = bi;
    }
    for (int q = p + lane; q < K; q += 32) {
      ov[q] = -INFINITY;
      oi[q] = -1;
    }
  }
}

// One block per h row: k rounds of "take the best list head".
__global__ void __launch_bounds__(kMergeThreads) topk_merge_kernel(
    const float* __restrict__ pval, const int* __restrict__ pidx, int nsplit,
    int K, float* __restrict__ out_val, int* __restrict__ out_idx) {
  extern __shared__ int next[];  // (nsplit): next entry of each list
  __shared__ float wv[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32], ws[kMergeThreads / 32];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* rv = pval + (size_t)row * nsplit * K;
  const int* ri = pidx + (size_t)row * nsplit * K;
  for (int s = tid; s < nsplit; s += kMergeThreads) next[s] = 0;
  __syncthreads();
  for (int p = 0; p < K; ++p) {
    float bv = -INFINITY;
    int bi = -1, bs = -1;
    for (int s = tid; s < nsplit; s += kMergeThreads) {
      const int at = next[s];
      if (at < K) {
        const float v = rv[(size_t)s * K + at];
        const int i = ri[(size_t)s * K + at];
        if (better(v, i, bv, bi)) {
          bv = v;
          bi = i;
          bs = s;
        }
      }
    }
    warp_best(bv, bi, bs);
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      ws[warp] = bs;
    }
    __syncthreads();
    if (tid == 0) {
      for (int j = 1; j < kMergeThreads / 32; ++j) {
        if (better(wv[j], wi[j], bv, bi)) {
          bv = wv[j];
          bi = wi[j];
          bs = ws[j];
        }
      }
      out_val[(size_t)row * K + p] = bv;
      out_idx[(size_t)row * K + p] = bi;
      if (bs >= 0) next[bs] += 1;
    }
    __syncthreads();
  }
}

template <typename T, int BT>
cudaError_t launch(const void* h, const void* w, void* pval, void* pidx,
                   void* out_val, void* out_idx, int B, int D, int V, int K,
                   int nsplit, cudaStream_t stream) {
  const int rows_per_split = (V + nsplit - 1) / nsplit;
  const size_t smem = ((size_t)head::staged_floats<T, BT>(D) +
                       (size_t)BT * rows_per_split) * sizeof(float);
  auto kernel = topk_partial_kernel<T, BT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nsplit, (B + BT - 1) / BT);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<float*>(pval), static_cast<int*>(pidx), B, D, V, K,
      rows_per_split, nsplit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t msmem = (size_t)nsplit * sizeof(int);
  if (msmem > 48 * 1024) {
    err = cudaFuncSetAttribute(topk_merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)msmem);
    if (err != cudaSuccess) return err;
  }
  topk_merge_kernel<<<B, kMergeThreads, msmem, stream>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      K, static_cast<float*>(out_val), static_cast<int*>(out_idx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* h, const void* w, void* pval, void* pidx,
                     void* out_val, void* out_idx, int B, int D, int V, int K,
                     int nsplit, cudaStream_t s) {
  if (B >= 8) return launch<T, 8>(h, w, pval, pidx, out_val, out_idx, B, D, V, K, nsplit, s);
  if (B >= 4) return launch<T, 4>(h, w, pval, pidx, out_val, out_idx, B, D, V, K, nsplit, s);
  if (B >= 2) return launch<T, 2>(h, w, pval, pidx, out_val, out_idx, B, D, V, K, nsplit, s);
  return launch<T, 1>(h, w, pval, pidx, out_val, out_idx, B, D, V, K, nsplit, s);
}

}  // namespace

// h (B, D) and w (V, D), both row-major of one dtype (0 = float32,
// 1 = bfloat16), D a multiple of 16 bytes' worth of elements; 1 <= K <=
// min(64, V); ceil(V / nsplit) <= 4096.  pval/pidx: (B, nsplit, K) f32/i32
// scratch.  out_val (B, K) f32, out_idx (B, K) i32.  Returns a cudaError_t.
extern "C" int repro_fused_topk_head(const void* h, const void* w, void* pval,
                                     void* pidx, void* out_val, void* out_idx,
                                     int B, int D, int V, int K, int nsplit,
                                     int dtype, void* stream) {
  if (B <= 0 || D <= 0 || V <= 0 || K < 1 || K > kMaxK || K > V ||
      nsplit <= 0 || nsplit > V ||
      (V + nsplit - 1) / nsplit > kMaxRowsPerSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return (int)dispatch<__nv_bfloat16>(h, w, pval, pidx, out_val, out_idx, B,
                                        D, V, K, nsplit, s);
  }
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;
    return (int)dispatch<float>(h, w, pval, pidx, out_val, out_idx, B, D, V,
                                K, nsplit, s);
  }
  return (int)cudaErrorInvalidValue;
}
