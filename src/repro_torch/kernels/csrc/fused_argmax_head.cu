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
// (V * D * 2 bytes in bf16; 311 MB, 0.093 ms for qwen3-0.6b) over the
// 3.35 TB/s of HBM.
//
// bf16 runs on the tensor cores (argmax_wgmma_partial_kernel):
//   * W is the tied (V, D) row-major embedding, read in place (the head
//     never builds embed.T).  The vocabulary is cut into tiles of kVT = 64
//     ids, and block x of the grid takes a range of whole tiles: ranges of
//     ceil(tiles / SMs) tiles, from (V, the SM count, the tile) only --
//     never from B or T.  One persistent block per SM: V = 151936 is 2374
//     tiles, 131 ranges of 18 and one of 16 on the H100's 132 SMs;
//   * a block takes a group of up to kNR = 64 rows of h (grid.y walks the
//     groups), so W is read once per 64 rows: once at B 8, once for the
//     verify head's 64 rows at B 8, T 8, four times at 256 rows;
//   * W streams through a ring of kStages (64 vocab rows x 128 K) tiles in
//     shared memory by 16-byte cp.async, with the group's h slab (64 rows x
//     128 K) beside each: 4 stages, 64 KB of W, in flight while the block
//     multiplies the fifth (256 contiguous bytes of each W row per stage).
//     Only the group's real rows of h are loaded; its padding rows are
//     zeroed once and stay zero.  The K loop goes over D in 128-wide slabs,
//     all eight k16 steps of each (past D they multiply zero-filled
//     columns), so any width D (a multiple of 8) fits;
//   * the products run on the tensor cores as one warpgroup's
//     wgmma.mma_async m64n64k16 bf16 x bf16 -> f32, both operands read
//     from shared memory (K-major, 128-byte swizzle, written in that
//     layout by cp.async): the 64 vocab rows of the tile against the 64
//     rows of the group, eight k16 steps per stage back to back (nothing
//     touches the accumulators between them), asynchronous to the loads.
//     The padded rows cost tensor-core time only, which the bound leaves
//     spare (64 rows x V x D x 2 = 20 GFLOP, 0.02 ms at peak);
//   * the fused epilogue: after a tile's K loop each thread folds its two
//     vocab rows into a running (max, idx) per h row with a strict '>' over
//     increasing ids (the lower id keeps a tie); ids >= V are skipped,
//     never scored 0 (the zero-filled tail of W would beat an all-negative
//     row, as the Pallas kernel's -inf mask at :56-60 prevents).  Lanes and
//     warps merge with "larger value, else lower index", and the block
//     writes one partial per (row, range);
//   * the same bits for a row in every call: its logits are f32 sums over
//     D in an order set by D alone, every call runs the same instruction
//     sequence on a fixed 64-row tile, and every merge is a total order.
//     So a row's (val, idx) does not follow B, its place in the batch, or
//     which of the argmax and verify heads asked.
// f32 stays on the CUDA cores (argmax_partial_kernel, head_tile.cuh): the
// tensor cores would round it to tf32.  A block stages BT rows of h as f32
// (BT picked by the wrapper to fit the card's shared memory) and each warp
// streams kRV vocab rows at a time; rows beyond BT re-read W per chunk.
//
// Pass 2 reduces a row's partials with the same rule, in block order.  No
// atomics: the result is deterministic and the lowest index wins every
// tie, as jnp.argmax and torch.argmax do.
//
// The speculative verify head (repro_fused_verify_head) is the same pass 1
// over the flattened (B*T, D) position rows -- Theorem 1 applied at every
// draft position -- and replaces src/repro/kernels/fused_topk_head.py
// (fused_verify_head, :170).  Its pass 2 reduces the T rows of one batch
// row per block and then computes the accepted draft length on the card:
// one warp takes a ballot of ids[b, i] == cand[b, i] over each 32
// positions and counts the leading run (a prefix AND).  The -1 padding of
// a ragged draft never equals an id.
#include "attention_tile.cuh"
#include "head_tile.cuh"

namespace {

using head::better;
using head::kFull;
using head::kRV;
using head::kWarps;
using bf16 = __nv_bfloat16;
constexpr int kReduceThreads = 256;

// The tensor-core tile (kernels/fused_argmax_head.py mirrors these).
constexpr int kVT = 64;            // vocab ids per tile: the wgmma's M
constexpr int kKS = 128;           // K slab: 256 bytes of a W row
constexpr int kNR = 64;            // h rows per group: the wgmma's N
constexpr int kStages = 5;         // ring depth
constexpr int kWgThreads = 128;    // one warpgroup
constexpr int kAtom = 64;          // K elements of a 128-byte swizzle atom
constexpr int kSubBytes = 64 * 128;  // 64 rows x one atom
constexpr int kStageBytes = 2 * (kKS / kAtom) * kSubBytes;  // W, then h
// + 1 KB to align the ring to the swizzle's 1024-byte period
constexpr size_t kWgSmem = (size_t)kStages * kStageBytes + 1024;
static_assert(kVT == 64 && kNR == 64, "one m64n64 tile per stage");

// Shared-memory byte offset of 16-byte chunk c (of the row's kKS / 8) of
// row r in a (64 rows x kKS) K-major operand: atoms of 64 rows x 128 bytes,
// chunk (c % 8) of a row stored at (c % 8) ^ (r % 8) -- the 128-byte
// swizzle the wgmma descriptor names.
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kSubBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// A wgmma shared-memory descriptor of a K-major operand at shared address
// `addr` (1024-aligned atom plus a k offset): 128-byte swizzle, 8-row
// groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// d (+)= A (64 x 16, K-major in shared memory) * B (16 x 64, K-major):
// thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8),
// columns 8 j + 2 (t % 4) + {0, 1} in d[4 j + {0, 1}] ({2, 3}: row + 8).
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Registers the wgmma writes asynchronously: the compiler must not move
// their reads or writes across this point.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// h (R, D) bf16; w (V, D) bf16; partials (R, nsplit).  Block (x, y): vocab
// tiles [x * tiles_per_split, ...) against rows [64 y, 64 y + 64).
__global__ void __launch_bounds__(kWgThreads, 1) argmax_wgmma_partial_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int R, int D, int V,
    int tiles_per_split, int nsplit) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float wbest[4][kNR];
  __shared__ int widx[4][kNR];
  const unsigned raw = attn::smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const unsigned ring_addr = attn::smem_u32(ring);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = blockIdx.y * kNR;
  const int nreal = min(kNR, R - r0);
  const int ntiles = (V + kVT - 1) / kVT;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(ntiles, t_begin + tiles_per_split);
  const int nslab = (D + kKS - 1) / kKS;
  const int n_iter = max(0, t_end - t_begin) * nslab;

  // the group's padding rows of h, in every stage: zero once, never loaded
  const int per = (kNR - nreal) * (kKS / 8);
  for (int i = tid; i < kStages * per; i += kWgThreads) {
    const int s = i / per, j = i % per;
    const int r = nreal + j / (kKS / 8), c = j % (kKS / 8);
    *reinterpret_cast<uint4*>(ring + s * kStageBytes + kStageBytes / 2 +
                              swz(r, c)) = make_uint4(0, 0, 0, 0);
  }

  // The stream's next stage: vocab tile ld_tile, K slab ld_slab, into
  // ring slot ld_slot; W rows past V and columns past D are zero-filled.
  int ld_tile = t_begin, ld_slab = 0, ld_slot = 0;
  auto load_next = [&]() {
    unsigned char* ws = ring + ld_slot * kStageBytes;
    unsigned char* hs = ws + kStageBytes / 2;
    const int v0 = ld_tile * kVT, k0 = ld_slab * kKS;
#pragma unroll
    for (int q = 0; q < kVT * (kKS / 8) / kWgThreads; ++q) {
      const int i = tid + q * kWgThreads;
      const int row = i / (kKS / 8), c = i % (kKS / 8), col = k0 + c * 8;
      const bool ok = v0 + row < V && col < D;
      attn::cp_async16(ws + swz(row, c),
                       w + (ok ? (size_t)(v0 + row) * D + col : 0), ok);
    }
    for (int i = tid; i < nreal * (kKS / 8); i += kWgThreads) {
      const int row = i / (kKS / 8), c = i % (kKS / 8), col = k0 + c * 8;
      const bool ok = col < D;
      attn::cp_async16(hs + swz(row, c),
                       h + (ok ? (size_t)(r0 + row) * D + col : 0), ok);
    }
    if (++ld_slab == nslab) {
      ld_slab = 0;
      ++ld_tile;
    }
    ld_slot = ld_slot + 1 == kStages ? 0 : ld_slot + 1;
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_next();
    attn::cp_async_commit();
  }

  float acc[32];
  float best[8][2];
  int bidx[8][2];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    best[j][0] = best[j][1] = -INFINITY;
    bidx[j][0] = bidx[j][1] = -1;
  }

  int slab = 0, tile = t_begin, slot = 0;
  for (int it = 0; it < n_iter; ++it) {
    attn::cp_async_wait<kStages - 2>();
    // this thread's copies of stage it, visible to the wgmma's reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // stage it landed for all; stage it - 1 is free
    if (it + kStages - 1 < n_iter) load_next();
    attn::cp_async_commit();

    const unsigned wa = ring_addr + slot * kStageBytes;
    const unsigned ha = wa + kStageBytes / 2;
    slot = slot + 1 == kStages ? 0 : slot + 1;
    // all eight k16 steps, also past D (zero-filled: they add 0), so that
    // no instruction touches the accumulators between two wgmmas
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kKS / 16; ++kk) {
      const unsigned off = (kk >> 2) * kSubBytes + (kk & 3) * 32;
      wgmma_64x64x16(acc, sw128_desc(wa + off), sw128_desc(ha + off),
                     slab > 0 || kk > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);

    if (++slab == nslab) {  // the tile's logits are whole: fold them
      const int vb = tile * kVT + warp * 16 + gid;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // ids vb, vb + 8: increasing
        const int v = vb + 8 * hf;
        if (v < V) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float s = acc[4 * j + 2 * hf + c];
              if (s > best[j][c]) {  // strict: the lower id keeps a tie
                best[j][c] = s;
                bidx[j][c] = v;
              }
            }
          }
        }
      }
      slab = 0;
      ++tile;
    }
  }
  attn::cp_async_wait<0>();

  // merge the 8 lanes of each h row (same tig), then the 4 warps
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        const float ov = __shfl_xor_sync(kFull, best[j][c], o);
        const int oi = __shfl_xor_sync(kFull, bidx[j][c], o);
        if (better(ov, oi, best[j][c], bidx[j][c])) {
          best[j][c] = ov;
          bidx[j][c] = oi;
        }
      }
      if (gid == 0) {
        wbest[warp][8 * j + 2 * tig + c] = best[j][c];
        widx[warp][8 * j + 2 * tig + c] = bidx[j][c];
      }
    }
  }
  __syncthreads();
  if (tid < nreal) {
    float bv = -INFINITY;
    int bi = -1;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (better(wbest[q][tid], widx[q][tid], bv, bi)) {
        bv = wbest[q][tid];
        bi = widx[q][tid];
      }
    }
    pval[(size_t)(r0 + tid) * nsplit + blockIdx.x] = bv;
    pidx[(size_t)(r0 + tid) * nsplit + blockIdx.x] = bi;
  }
}

// h (B, D) f32; w (V, D) f32; partials (B, nsplit): the CUDA-core route.
template <int BT>
__global__ void __launch_bounds__(kWarps * 32) argmax_partial_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    float* __restrict__ pval, int* __restrict__ pidx, int B, int D, int V,
    int rows_per_split, int nsplit) {
  extern __shared__ float hs[];  // staged h rows (head_tile.cuh)
  __shared__ float wbest[kWarps][BT];
  __shared__ int widx[kWarps][BT];

  const int r0 = blockIdx.y * BT;
  head::stage_h<float, BT>(h, hs, B, D, r0);

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
    head::dot_tile<float, BT>(hs, w, D, v0, v_end, lane, acc);
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

cudaError_t launch_wgmma(const void* h, const void* w, void* pval,
                         void* pidx, int R, int D, int V, int nsplit,
                         int split_ids, cudaStream_t stream) {
  static head::OptIn opt;
  if (split_ids % kVT) return cudaErrorInvalidValue;
  cudaError_t err = head::opt_in(argmax_wgmma_partial_kernel, kWgSmem, opt);
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, (R + kNR - 1) / kNR);
  argmax_wgmma_partial_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<float*>(pval), static_cast<int*>(pidx), R, D, V,
      split_ids / kVT, nsplit);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_f32(const void* h, const void* w, void* pval, void* pidx,
                       int R, int D, int V, int nsplit, int split_ids,
                       cudaStream_t stream) {
  static head::OptIn opt;
  const size_t smem = (size_t)head::staged_floats<float, BT>(D) * sizeof(float);
  cudaError_t err = head::opt_in(argmax_partial_kernel<BT>, smem, opt);
  if (err != cudaSuccess) return err;
  const dim3 grid(nsplit, (R + BT - 1) / BT);
  argmax_partial_kernel<BT><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(h), static_cast<const float*>(w),
      static_cast<float*>(pval), static_cast<int*>(pidx), R, D, V,
      split_ids, nsplit);
  return cudaGetLastError();
}

// Pass 1 over R rows.  dtype 1 (bfloat16): the tensor-core tile, rows in
// groups of 64 (row_block must be 64), split_ids a multiple of 64;
// dtype 0 (float32): the CUDA-core route, row_block = BT in {1, 2, 4, 8}.
// D a multiple of 16 bytes' worth of elements; nsplit ranges of split_ids
// ids must cover V (trailing ranges may hold none).
cudaError_t partial_any(const void* h, const void* w, void* pval, void* pidx,
                        int R, int D, int V, int nsplit, int split_ids,
                        int row_block, int dtype, cudaStream_t s) {
  if (R <= 0 || D <= 0 || V <= 0 || nsplit <= 0 || nsplit > V ||
      split_ids <= 0 || (long long)nsplit * split_ids < V)
    return cudaErrorInvalidValue;
  if (dtype == 1 && D % 8 == 0 && row_block == kNR)
    return launch_wgmma(h, w, pval, pidx, R, D, V, nsplit, split_ids, s);
  if (dtype == 0 && D % 4 == 0) {
    switch (row_block) {
      case 8: return launch_f32<8>(h, w, pval, pidx, R, D, V, nsplit, split_ids, s);
      case 4: return launch_f32<4>(h, w, pval, pidx, R, D, V, nsplit, split_ids, s);
      case 2: return launch_f32<2>(h, w, pval, pidx, R, D, V, nsplit, split_ids, s);
      case 1: return launch_f32<1>(h, w, pval, pidx, R, D, V, nsplit, split_ids, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The card's opt-in shared memory per block on `device`, in bytes (0 on
// error): the budget the wrappers plan with.
extern "C" int repro_head_smem_optin(int device) {
  return head::smem_optin(device);
}

// The tensor-core tile's geometry, for the wrappers to check their copy:
// out[0..4] = vocab tile, K slab, row group, stages, shared memory bytes.
extern "C" void repro_head_tile_geometry(int* out) {
  out[0] = kVT;
  out[1] = kKS;
  out[2] = kNR;
  out[3] = kStages;
  out[4] = (int)kWgSmem;
}

// h (B, D) and w (V, D), both row-major of one dtype (0 = float32,
// 1 = bfloat16), D a multiple of 16 bytes' worth of elements; the plan
// (nsplit, split_ids, row_block) as partial_any takes it.  pval/pidx:
// (B, nsplit) f32/i32 scratch.  out_idx (B,) i32, out_val (B,) f32.
// Returns a cudaError_t.
extern "C" int repro_fused_argmax_head(const void* h, const void* w,
                                       void* pval, void* pidx, void* out_idx,
                                       void* out_val, int B, int D, int V,
                                       int nsplit, int split_ids,
                                       int row_block, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = partial_any(h, w, pval, pidx, B, D, V, nsplit,
                                split_ids, row_block, dtype, s);
  if (err != cudaSuccess) return (int)err;
  argmax_reduce_kernel<<<B, kReduceThreads, 0, s>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      static_cast<int*>(out_idx), static_cast<float*>(out_val));
  return (int)cudaGetLastError();
}

// The speculative verify head.  h (B*T, D) -- the (B, T, D) position rows
// flattened -- and w and the plan as above; cand (B, T-1) i32 draft ids,
// -1 past each row's width.  pval/pidx: (B*T, nsplit) scratch.  out_ids
// (B, T) i32 = argmax per position; out_accept (B,) i32 = leading run of
// out_ids[:, :T-1] == cand.  Returns a cudaError_t.
extern "C" int repro_fused_verify_head(const void* h, const void* w,
                                       const void* cand, void* pval,
                                       void* pidx, void* out_ids,
                                       void* out_accept, int B, int T, int D,
                                       int V, int nsplit, int split_ids,
                                       int row_block, int dtype,
                                       void* stream) {
  if (B <= 0 || T <= 0 || T > 4096) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = partial_any(h, w, pval, pidx, B * T, D, V, nsplit,
                                split_ids, row_block, dtype, s);
  if (err != cudaSuccess) return (int)err;
  verify_reduce_kernel<<<B, kReduceThreads, (size_t)T * sizeof(int), s>>>(
      static_cast<const float*>(pval), static_cast<const int*>(pidx), nsplit,
      T, static_cast<const int*>(cand), static_cast<int*>(out_ids),
      static_cast<int*>(out_accept));
  return (int)cudaGetLastError();
}
