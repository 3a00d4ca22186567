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
//   * pass 1 splits the vocabulary into contiguous ranges, one thread
//     block each, with BT rows of h staged as f32 in shared memory, each
//     warp streaming RV vocab rows against them with f32 accumulation
//     (head_tile.cuh, shared with the argmax head's f32 route).  The
//     wrapper picks BT, the largest of {8, 4, 2, 1} up to B whose staging
//     (4 * BT * D bytes) and logits fit the card's opt-in shared memory:
//     8 at qwen3-0.6b's D 1024, 2 at nemotron-4-340b's D 18432, where B 8
//     takes four row chunks and so reads W four times.  The
//     block keeps its range's BT x rows logits in shared memory (never in
//     HBM), then one warp per h row picks the range's top k by k
//     selection passes.  The order (value descending, index ascending) is
//     one 64-bit key per entry.  Where the range is at most 320 ids (528
//     ranges of 288 at qwen3-0.6b) each lane sorts its keys in registers
//     once and a pass is a warp max over the lanes' heads, the winner
//     popping its own; a longer range takes the largest key below the
//     previous pick each pass.  No entry is marked or copied, and -inf
//     logits still sort by index.  Each block writes one sorted
//     partial list of k (value, index) pairs per h row, padded with index
//     -1 when its range holds fewer than k ids;
//   * pass 2 merges a row's nsplit sorted lists by trees of pairwise
//     merges: each entry of a pair finds its rank in the merged list by a
//     binary search on the keys of the other list (real keys are
//     distinct, so no two entries tie) and is written there if the rank
//     is below k.  A block of 256 threads merges 32 lists in 5 levels, one
//     barrier each; at the H100's 528 lists a first launch spreads 17
//     blocks per row over the SMs (one block per row would leave the
//     merge on B SMs) and a second merges their 17 lists.  No atomics:
//     the result is deterministic and matches k stable selection passes
//     exactly (ref.topk_merge_tree is its plain model).
// What it leaves on the table: h rows beyond BT re-read W per chunk of
// BT, W loads are plain vector loads (no TMA ring), and pass 1 picks a
// range's top k by k serial passes per warp while the block's other warps
// wait.
#include "head_tile.cuh"

namespace {

using head::kRV;
using head::kWarps;
constexpr int kMergeWarps = 8;     // pass 2: blocks of 256 threads
constexpr int kListsPerBlock = 32; // lists a pass-2 block merges
constexpr int kMaxK = 64;          // MAX_TOP_K of the samplers
constexpr int kMaxRowsPerSplit = 4096;
constexpr int kLaneKeys = 10;      // keys a lane sorts in registers

// The order as one 64-bit key: larger value first, then lower index, so
// the larger key is the better entry.  The value's bits are flipped to
// sort as unsigned (-0 enters as +0: equal values tie, as in the plain
// version); the index goes in complemented.  Key 0 is no entry: every
// real entry's low word, ~index, is at least 2^31.
using Key = unsigned long long;

__device__ __forceinline__ Key make_key(float v, int i) {
  unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (unsigned)~i;
}

__device__ __forceinline__ float key_value(Key k) {
  unsigned u = (unsigned)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(Key k) { return (int)~(unsigned)k; }

__device__ __forceinline__ Key warp_max_key(Key k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Key x = __shfl_xor_sync(head::kFull, k, o);
    k = x > k ? x : k;
  }
  return k;
}

// k[0 .. N) sorted descending in registers: odd-even transposition, N
// rounds of compare-exchanges on fixed pairs, so every index is a
// compile-time constant and the keys never leave registers.
template <int N>
__device__ __forceinline__ void sort_desc(Key (&k)[N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int i = r & 1; i + 1 < N; i += 2) {
      const Key a = k[i], b = k[i + 1];
      k[i] = a > b ? a : b;
      k[i + 1] = a > b ? b : a;
    }
  }
}

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

  // one warp per h row: k selection passes over the range's logits, each
  // taking the largest key below the previous pick
  for (int r = warp; r < BT; r += kWarps) {
    const int row = r0 + r;
    if (row >= B) break;  // warp-uniform; later r are larger still
    const float* lr = lg + r * rows_per_split;
    float* ov = pval + ((size_t)row * nsplit + blockIdx.x) * K;
    int* oi = pidx + ((size_t)row * nsplit + blockIdx.x) * K;
    int p = 0;
    if (n <= 32 * kLaneKeys) {
      // each lane sorts its keys once; a pass takes the warp's largest
      // head and its lane pops it (keys are distinct: one lane pops)
      Key k[kLaneKeys];
#pragma unroll
      for (int e = 0; e < kLaneKeys; ++e) {
        const int j = lane + 32 * e;
        k[e] = j < n ? make_key(lr[j], v_begin + j) : 0;
      }
      sort_desc(k);
      for (; p < K; ++p) {
        const Key best = warp_max_key(k[0]);
        if (best == 0) break;  // warp-uniform: the range is exhausted
        if (lane == 0) {
          ov[p] = key_value(best);
          oi[p] = key_index(best);
        }
        const bool pop = k[0] == best;
#pragma unroll
        for (int e = 0; e + 1 < kLaneKeys; ++e) k[e] = pop ? k[e + 1] : k[e];
        k[kLaneKeys - 1] = pop ? 0 : k[kLaneKeys - 1];
      }
    } else {
      Key prev = ~0ull;  // no pick yet: every entry is eligible
      for (; p < K; ++p) {
        Key best = 0;
        for (int j = lane; j < n; j += 32) {
          const Key key = make_key(lr[j], v_begin + j);
          best = (key < prev && key > best) ? key : best;
        }
        best = warp_max_key(best);
        if (best == 0) break;  // warp-uniform: the range is exhausted
        if (lane == 0) {
          ov[p] = key_value(best);
          oi[p] = key_index(best);
        }
        prev = best;
      }
    }
    for (int q = p + lane; q < K; q += 32) {
      ov[q] = -INFINITY;
      oi[q] = -1;
    }
  }
}

// Keys of `other` (sorted descending, n of them) placed before key a in
// the merge: those above it (a from the left list), or those not below
// it (a from the right list), so that the left list wins a tie -- which
// only padding (key 0) can make: real keys are distinct.  Either count
// is the length of a prefix of `other`, found by binary search.
template <bool kLeft>
__device__ __forceinline__ int placed_before(const Key* other, int n, Key a) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const Key o = other[mid];
    if (kLeft ? o > a : o >= a)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Entry e of a pair -- e < K: entry e of the left list x, else entry
// e - K of the right list y -- goes to its rank in the other list plus its
// own; ranks past K fall off.  ny = 0: no right list (an odd list out
// passes through).
__device__ __forceinline__ void place(const Key* x, const Key* y, int ny,
                                      int K, int e, Key* dst) {
  const bool left = e < K;
  const int j = left ? e : e - K;
  const Key a = left ? x[j] : y[j];
  const int r = j + (left ? placed_before<true>(y, ny, a)
                          : placed_before<false>(x, K, a));
  if (r < K) dst[r] = a;
}

// Block (g, row) merges lists [g * kListsPerBlock, ...) of row's n lists
// of K (value, index) pairs, sorted, into one, written as list g of the
// row's ceil(n / kListsPerBlock) outputs.  A tree of pairwise merges:
// every entry finds its rank in the merged pair by a binary search in the
// other list, so a level is one parallel step and the tree takes
// log2 kListsPerBlock = 5 levels, one barrier each.  Level 1 reads the
// lists from global memory as keys, one warp per pair through its own
// scratch; the later levels go from shared buffer to shared buffer.
__global__ void __launch_bounds__(kMergeWarps * 32) topk_merge_kernel(
    const float* __restrict__ in_val, const int* __restrict__ in_idx, int n,
    int K, float* __restrict__ out_val, int* __restrict__ out_idx) {
  constexpr int kHalf = kListsPerBlock / 2;
  __shared__ Key buf_a[kHalf * kMaxK];  // level 1's lists
  __shared__ Key buf_b[kHalf * kMaxK];  // level 2's; level 1's scratch
  const int g = blockIdx.x, row = blockIdx.y, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int first = g * kListsPerBlock;
  const int lists = min(kListsPerBlock, n - first);
  const int n1 = (lists + 1) / 2;
  const size_t base = ((size_t)row * n + first) * K;

  // level 1: warp w merges pairs w, w + kMergeWarps, ...
  Key* scratch = buf_b + warp * 2 * K;
  for (int p = warp; p < n1; p += kMergeWarps) {
    const int ny = 2 * p + 1 < lists ? K : 0;
    for (int e = lane; e < K + ny; e += 32) {
      const size_t at = base + (size_t)2 * p * K + e;
      const int i = in_idx[at];
      scratch[e] = i < 0 ? 0 : make_key(in_val[at], i);
    }
    __syncwarp();
    for (int e = lane; e < K + ny; e += 32)
      place(scratch, scratch + K, ny, K, e, buf_a + p * K);
    __syncwarp();  // the scratch is free for the next pair
  }
  __syncthreads();

  // levels 2 ...: the whole block, buffer to buffer
  Key* src = buf_a;
  Key* dst = buf_b;
  for (int m = n1; m > 1; m = (m + 1) / 2) {
    const int pairs = (m + 1) / 2;
    for (int idx = tid; idx < pairs * 2 * K; idx += kMergeWarps * 32) {
      const int p = idx / (2 * K), e = idx % (2 * K);
      const int ny = 2 * p + 1 < m ? K : 0;
      if (e < K + ny)
        place(src + 2 * p * K, src + (2 * p + 1) * K, ny, K, e, dst + p * K);
    }
    __syncthreads();
    Key* t = src;
    src = dst;
    dst = t;
  }
  const size_t out = ((size_t)row * gridDim.x + g) * K;
  for (int j = tid; j < K; j += kMergeWarps * 32) {
    out_val[out + j] = src[j] ? key_value(src[j]) : -INFINITY;
    out_idx[out + j] = src[j] ? key_index(src[j]) : -1;
  }
}

template <typename T, int BT>
cudaError_t launch(const void* h, const void* w, void* pval, void* pidx,
                   void* mval, void* midx, void* out_val, void* out_idx,
                   int B, int D, int V, int K, int nsplit,
                   cudaStream_t stream) {
  static head::OptIn opt;
  const int rows_per_split = (V + nsplit - 1) / nsplit;
  const size_t smem = ((size_t)head::staged_floats<T, BT>(D) +
                       (size_t)BT * rows_per_split) * sizeof(float);
  auto kernel = topk_partial_kernel<T, BT>;
  cudaError_t err = head::opt_in(kernel, smem, opt);
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, (B + BT - 1) / BT);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<float*>(pval), static_cast<int*>(pidx), B, D, V, K,
      rows_per_split, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // pass 2: nsplit lists -> ceil(nsplit / 32) -> 1, a launch per stage
  const int g1 = (nsplit + kListsPerBlock - 1) / kListsPerBlock;
  if (g1 > 1) {
    topk_merge_kernel<<<dim3(g1, B), kMergeWarps * 32, 0, stream>>>(
        static_cast<const float*>(pval), static_cast<const int*>(pidx),
        nsplit, K, static_cast<float*>(mval), static_cast<int*>(midx));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  topk_merge_kernel<<<dim3(1, B), kMergeWarps * 32, 0, stream>>>(
      static_cast<const float*>(g1 > 1 ? mval : pval),
      static_cast<const int*>(g1 > 1 ? midx : pidx), g1 > 1 ? g1 : nsplit,
      K, static_cast<float*>(out_val), static_cast<int*>(out_idx));
  return cudaGetLastError();
}

// BT rows of h per block, as the wrapper picked it (1, 2, 4 or 8).
template <typename T>
cudaError_t dispatch(const void* h, const void* w, void* pval, void* pidx,
                     void* mval, void* midx, void* out_val, void* out_idx,
                     int B, int D, int V, int K, int nsplit, int bt,
                     cudaStream_t s) {
#define REPRO_TOPK_BT(BT)                                                  \
  return launch<T, BT>(h, w, pval, pidx, mval, midx, out_val, out_idx, B, \
                       D, V, K, nsplit, s)
  switch (bt) {
    case 8: REPRO_TOPK_BT(8);
    case 4: REPRO_TOPK_BT(4);
    case 2: REPRO_TOPK_BT(2);
    case 1: REPRO_TOPK_BT(1);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_TOPK_BT
}

}  // namespace

// h (B, D) and w (V, D), both row-major of one dtype (0 = float32,
// 1 = bfloat16), D a multiple of 16 bytes' worth of elements; 1 <= K <=
// min(64, V); ceil(V / nsplit) <= 4096; nsplit <= 1024 (two merge
// stages); bt in {1, 2, 4, 8} rows of h per pass-1 block, whose staging
// and logits fit the card's opt-in shared memory.  pval/pidx: (B, nsplit,
// K) f32/i32 scratch; mval/midx: (B, ceil(nsplit / 32), K) f32/i32
// scratch.  out_val (B, K) f32, out_idx (B, K) i32.  Returns a
// cudaError_t.
extern "C" int repro_fused_topk_head(const void* h, const void* w, void* pval,
                                     void* pidx, void* mval, void* midx,
                                     void* out_val, void* out_idx, int B,
                                     int D, int V, int K, int nsplit, int bt,
                                     int dtype, void* stream) {
  if (B <= 0 || B > 65535 || D <= 0 || V <= 0 || K < 1 || K > kMaxK ||
      K > V || nsplit <= 0 || nsplit > V ||
      nsplit > kListsPerBlock * kListsPerBlock ||
      (V + nsplit - 1) / nsplit > kMaxRowsPerSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (D % 8) return (int)cudaErrorInvalidValue;
    return (int)dispatch<__nv_bfloat16>(h, w, pval, pidx, mval, midx,
                                        out_val, out_idx, B, D, V, K,
                                        nsplit, bt, s);
  }
  if (dtype == 0) {
    if (D % 4) return (int)cudaErrorInvalidValue;
    return (int)dispatch<float>(h, w, pval, pidx, mval, midx, out_val,
                                out_idx, B, D, V, K, nsplit, bt, s);
  }
  return (int)cudaErrorInvalidValue;
}
