// Paged attention for Hopper (sm_90a): ragged GQA decode attention read
// straight from the block-paged KV pool through each row's block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py
// (paged_attention, pallas_call at :219, body _kernel at :76) in all five
// score modes of its static attn_approx (exact, base2, pseudo, pwl,
// maxonly; a template argument here too), with the sliding-window mask.
//
// Bound on the H100: memory.  A decode query reads every K and V row of
// its history once and does 4*hd flops per row, far below the card's
// ~295 flops per byte, so the least time is the row's K/V bytes over
// the 3.35 TB/s of HBM.  What holds a kernel back at decode sizes is
// latency: a block that walked its row's whole history in serial stages
// let the longest row set the time, so the positions are split.
//
// Design: split-KV decode at fixed chunk edges, with a deterministic
// combine, in every mode, on two routes.
//   * query rows: the g = Hq/Hkv query heads of a kv head and the row's T
//     query tokens share each staged K/V tile -- GQA-native, no K/V
//     repeat;
//   * chunks: the kv positions [0, nb*bs) split into n_chunks chunks of
//     chunk_keys positions, one thread block per (query group, chunk, kv
//     head h, batch row b): grid (groups * n_chunks, Hkv, B).  The
//     wrapper fixes chunk_keys per (dtype, head dim), never from B, T, the
//     mode or the table width, so chunk edges sit at fixed multiples of
//     absolute position;
//   * a block walks the positions of its chunk inside its group's extent
//     [lo, hi] (hi = the group's largest query position, lo = the
//     window's start) in stages that start at multiples of the stage's
//     width in absolute position -- never at lo -- so every stage and
//     32-key slice edge, and so every sum a row takes, depends on that
//     row's own positions only.  Each stage's K and V rows are copied
//     through the table with 16-byte cp.async, double-buffered: the next
//     stage's copies fly while the current one is folded; rows past the
//     chunk's end are zero-filled and never visible;
//   * route by dtype only (the entry's dispatch): bf16 takes
//     paged_attention_mma_kernel, the tensor-core tile of flash attention
//     (attn::mma_fold_tile in csrc/attention_tile.cuh): the T*g query rows
//     of a (row, kv head) packed into 16-row m-tiles (rows past T*g masked
//     out), 32-key tiles, S and PV as mma.sync bf16 -> f32, P into PV as
//     bf16 plus its bf16 remainder.  T = 1 rides the same tile as T = 32:
//     at decode the kernel is memory-bound, and one route for every T
//     keeps a row's bits independent of T.  f32 (TF32 would miss the f32
//     checks) takes paged_attention_kernel, one warp per query row
//     carrying the f32 online softmax through attn::fold_stage (shared
//     with flash attention's f32 route);
//   * base2 and pwl weigh a score s by f(s - m) through a LUT bin or a
//     chord that depends on where s - m falls, so a partial taken at a
//     chunk's own max could not be rescaled to the row's.  They weigh at
//     the row's max M instead, the plain version's definition, in three
//     launches: a row-max pre-pass (paged_rowmax_mma_kernel /
//     paged_rowmax_kernel: the fold's grid, extent, stage and slice edges,
//     K only) writes each query row's max per chunk, scored by the fold's
//     own routine (attn::mma_scores / attn::key_score) in the fold's
//     order, so every score the fold meets is <= M bit for bit; the fold
//     reads its rows' chunk maxima, takes M (max is exact in any order)
//     and seeds its carry with it, so the running max never moves, the
//     carry is never rescaled and every weight is f(s - M); the combine
//     then merges chunks that all carry m = M: a plain sum;
//   * with one chunk the block writes acc / l itself.  Otherwise it
//     writes its rows' f32 partials (m, l, acc[hd]) -- a chunk with no
//     visible key writes m = -inf, l = 0 and no acc -- into scratch the
//     wrapper allocates, and a combine kernel, one warp per query row,
//     merges them in chunk order with no atomics, so the output is the
//     same bits every call: exact rescales chunk c by expf(m_c - M),
//     pseudo by exp2f(m_c - M), base2 and pwl by expf(0) = 1; a chunk of
//     weight 0 is skipped and the sums start at -0, so one non-empty
//     chunk among empty ones gives exactly the bits of the one-chunk
//     path; maxonly is a comparator merge: the strictly higher m wins, so
//     a tie keeps the earlier chunk and its lower positions.  A row's
//     output is thus the same bits alone and beside any batch-mates, and
//     at any T;
//   * a query with no visible key writes 0 (l is clamped at 1e-30 as the
//     TPU kernel does);
//   * the base2 LUT (256 f32) and the pwl ROM (17 f32) come from the
//     caller and sit in shared memory, loaded once per block: lanes index
//     different entries, which __constant__ memory would serialise.
// What it leaves on the table: base2 and pwl read K twice (the pre-pass
// and the fold: about 1.5x the function's bytes) and launch three
// kernels; the mma route leaves the rows of an m-tile past T*g idle (a
// decode step's g rows use 2 of 16 at qwen3-0.6b), which costs little
// while the kernel waits on memory.
#include <climits>

#include "attention_tile.cuh"

namespace {

using attn::bf16;

// CUDA-core route: 64 staged positions when both tiles fit in 32 KB,
// else 32.
template <typename T, int HD>
constexpr int kStage = (2 * 64 * HD * (int)sizeof(T) <= 32768) ? 64 : 32;
// Tensor-core route: 32-key K/V tiles, up to 4 warps of 16 query rows.
constexpr int kMmaKeys = 32;
constexpr int kMmaWarps = 4;
// chunk_keys is a multiple of this, and so of every stage width above.
constexpr int kChunkQuantum = 64;
// Modes that weigh at the row's max, after the row-max pre-pass.
template <int MODE>
constexpr bool kPremax = attn::kRomSize<MODE> > 0;

// Shared memory for a block of `warps` warps: 2 buffers of (STAGE, LD)
// K (and V, but for the pre-pass), each warp's query row in f32, the
// mode's table, then 2 stages' pool-block ids (a stage spans at most
// STAGE + 1 blocks).
template <typename T, int HD, int MODE, bool ROWMAX>
size_t smem_bytes(int warps) {
  return (ROWMAX ? 2 : 4) * (size_t)kStage<T, HD> * attn::kLd<T, HD> *
             sizeof(T) +
         (size_t)warps * HD * sizeof(float) +
         (ROWMAX ? 0 : attn::kRomSize<MODE>) * sizeof(float) +
         2 * (kStage<T, HD> + 1) * sizeof(int);
}

// The mma route's shared memory: the Q tile of 16 * warps rows, 2 buffers
// of (kMmaKeys, LD) K (and V, but for the pre-pass), then the mode's
// table.
template <int HD, int MODE, bool ROWMAX>
constexpr size_t mma_smem_bytes(int warps) {
  return (size_t)(16 * warps + (ROWMAX ? 2 : 4) * kMmaKeys) *
             attn::kMmaLd<HD> * 2 +
         (ROWMAX ? 0 : attn::kRomSize<MODE>) * sizeof(float);
}

// The kv extent a query group walks inside chunk `chunk`: [lo_c, hi_c],
// lo_c on a multiple of `stage` in absolute position.  The group's
// largest query position caps it (clipped to the table), its smallest
// one minus the window opens it.
struct Extent {
  int lo_c, hi_c;
};

__device__ __forceinline__ Extent chunk_extent(const int* prow, int t0,
                                               int t1, int nb, int bs,
                                               int window, int chunk,
                                               int chunk_keys, int stage) {
  int hi = -1, lo_q = INT_MAX;
  for (int t = t0; t <= t1; ++t) {
    hi = max(hi, prow[t]);
    lo_q = min(lo_q, prow[t]);
  }
  hi = min(hi, nb * bs - 1);
  const int lo = window > 0 ? max(0, lo_q - window + 1) : 0;
  const int c0 = chunk * chunk_keys;  // a multiple of stage
  return {max(lo / stage * stage, c0), min(hi, c0 + chunk_keys - 1)};
}

// Operands of both routes and passes.  q (B, T, Hq, HD); pools
// (num_blocks, bs, Hkv, HD); btab (B, nb) i32; pos (B, T) i32; out (B, T,
// Hq, HD); rom the mode's f32 table (attn::kRomSize<MODE> entries; unused
// without one).  window <= 0 means no window.  The query rows R = (b*T +
// t)*Hq + qh: with n_chunks > 1, part holds their partials, acc at
// part[(R*n_chunks + c)*HD], then m and then l at [RC*HD + R*n_chunks + c]
// and [RC*HD + RC + ...], RC = B*T*Hq*n_chunks; for base2 and pwl, cmax
// holds their chunk maxima at [R*n_chunks + c], written by the pre-pass
// and read by the fold.
template <typename T>
struct Args {
  const T* __restrict__ q;
  const T* __restrict__ kpool;
  const T* __restrict__ vpool;
  const int* __restrict__ btab;
  const int* __restrict__ pos;
  const float* __restrict__ rom;
  T* __restrict__ out;
  float* __restrict__ part;
  float* __restrict__ cmax;
  int B, tq, hq, hkv, bs, nb, window;
  float scale;
  int n_chunks, chunk_keys;
};

// The CUDA-core route, one warp per query row, groups of at most 32 rows:
// grid (groups * n_chunks, Hkv, B).  ROWMAX: the pre-pass, K only, each
// row's max score in the chunk into cmax; else the fold.
template <typename T, int HD, int MODE, bool ROWMAX>
__device__ __forceinline__ void paged_core(const Args<T>& a) {
  constexpr int STAGE = kStage<T, HD>;
  constexpr int LD = attn::kLd<T, HD>;
  constexpr int EPL = attn::kEpl<HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = HD / VEC;        // 16-byte chunks per kv row
  constexpr int ROM = ROWMAX ? 0 : attn::kRomSize<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (2, STAGE, LD)
  T* vs = ks + 2 * STAGE * LD;         // (2, STAGE, LD), not for ROWMAX
  float* q_s = reinterpret_cast<float*>(ks + (ROWMAX ? 2 : 4) * STAGE * LD);
  float* rom_s = q_s + (blockDim.x >> 5) * HD;
  int* tab_s = reinterpret_cast<int*>(rom_s + ROM);
  for (int i = threadIdx.x; i < ROM; i += blockDim.x) rom_s[i] = a.rom[i];

  const int n_chunks = a.n_chunks;
  const int group = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.hq / a.hkv, window = a.window, bs = a.bs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = group * 32;  // this group's first query row
  const int qrow = row0 + warp;
  const int row_end = min(a.tq * g, row0 + 32);
  const bool active = qrow < row_end;
  const int* prow = a.pos + (size_t)b * a.tq;
  const int* trow = a.btab + (size_t)b * a.nb;

  const Extent ext = chunk_extent(prow, row0 / g, (row_end - 1) / g, a.nb,
                                  bs, window, chunk, a.chunk_keys, STAGE);
  const int lo_c = ext.lo_c, hi_c = ext.hi_c;
  const int nst = hi_c >= lo_c ? (hi_c - lo_c) / STAGE + 1 : 0;

  int my_pos = -1;
  size_t r = 0;  // the query row's index
  float* qs = q_s + warp * HD;
  float acc[EPL] = {};
  float m = -INFINITY, l = 0.f;
  bool seen = true;  // the chunk has a key this row sees
  if (active) {
    const int t = qrow / g;
    my_pos = prow[t];
    r = ((size_t)b * a.tq + t) * a.hq + h * g + qrow % g;
    attn::stage_query<T, HD>(a.q + r * HD, lane, qs);
    if constexpr (kPremax<MODE> && !ROWMAX) {
      // the row's max, in which every chunk weighs
      const float* cm = a.cmax + r * n_chunks;
      for (int c = lane; c < n_chunks; c += 32) m = fmaxf(m, cm[c]);
      m = attn::warp_max(m);
      seen = cm[chunk] > -INFINITY;
    }
  }

  // The pool blocks of the stage at p0, one table read each.
  auto load_table = [&](int buf, int p0) {
    const int first = p0 / bs, last = min(p0 + STAGE - 1, hi_c) / bs;
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x)
      tab_s[buf * (STAGE + 1) + i] = trow[first + i];
  };
  // Its K (and V) rows, one cp.async group; rows past hi_c zero.
  auto load_stage = [&](int buf, int p0) {
    const int first = p0 / bs;
    const int* tab = tab_s + buf * (STAGE + 1);
    T* kd = ks + buf * STAGE * LD;
    T* vd = vs + buf * STAGE * LD;
    for (int i = threadIdx.x; i < STAGE * CPR; i += blockDim.x) {
      const int j = i / CPR, c = (i % CPR) * VEC, p = p0 + j;
      const bool ok = p <= hi_c;
      size_t off = 0;
      if (ok)
        off = (((size_t)tab[p / bs - first] * bs + p % bs) * a.hkv + h) * HD +
              c;
      attn::cp_async16(kd + j * LD + c, a.kpool + off, ok);
      if constexpr (!ROWMAX)
        attn::cp_async16(vd + j * LD + c, a.vpool + off, ok);
    }
    attn::cp_async_commit();
  };
  auto visible = [=](int p) {
    return p <= hi_c && p <= my_pos && (window <= 0 || p > my_pos - window);
  };

  if (nst > 0) load_table(0, lo_c);
  __syncthreads();  // the table (and the mode's ROM) are published
  if (nst > 0) load_stage(0, lo_c);
  for (int s = 0; s < nst; ++s) {
    const int p0 = lo_c + s * STAGE;
    const bool more = s + 1 < nst;
    if (more) load_table((s + 1) & 1, p0 + STAGE);
    __syncthreads();  // ... and every warp is done with buffer (s + 1) & 1
    if (more) {
      load_stage((s + 1) & 1, p0 + STAGE);
      attn::cp_async_wait<1>();  // stage s has landed
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (!active) continue;
    const T* kt = ks + (s & 1) * STAGE * LD;
    if constexpr (ROWMAX) {
      // the fold's scores (attn::fold_stage), their max
      for (int j0 = 0; j0 < STAGE; j0 += 32)
        m = fmaxf(m, attn::key_score<T, HD>(kt + (j0 + lane) * LD, qs,
                                            a.scale,
                                            visible(p0 + j0 + lane)));
    } else {
      attn::fold_stage<T, HD, STAGE, MODE>(kt, vs + (s & 1) * STAGE * LD,
                                           p0, lane, qs, acc, m, l, a.scale,
                                           visible, rom_s);
    }
  }

  if (!active) return;
  const size_t rc = r * n_chunks + chunk;
  if constexpr (ROWMAX) {
    m = attn::warp_max(m);
    if (lane == 0) a.cmax[rc] = m;
    return;
  }
  if (n_chunks == 1) {
    attn::store_row<T, HD>(a.out + r * HD, lane, acc, l);
    return;
  }
  const size_t nrc = (size_t)a.B * a.tq * a.hq * n_chunks;
  if (!seen) m = -INFINITY;  // a seeded carry with no key of its own
  if (m > -INFINITY && lane < HD / EPL) {  // the combine skips m = -inf
    attn::Vec<float, EPL> x;
#pragma unroll
    for (int e = 0; e < EPL; ++e) x.v[e] = acc[e];
    *reinterpret_cast<attn::Vec<float, EPL>*>(a.part + rc * HD + lane * EPL) =
        x;
  }
  if (lane == 0) {
    a.part[nrc * HD + rc] = m;
    a.part[nrc * HD + nrc + rc] = l;
  }
}

template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const Args<T> a) {
  paged_core<T, HD, MODE, false>(a);
}

template <typename T, int HD>
__global__ void __launch_bounds__(1024) paged_rowmax_kernel(const Args<T> a) {
  paged_core<T, HD, attn::kExact, true>(a);
}

// The tensor-core route (bf16): the T*g query rows of (b, h) are rows r =
// t*g + (head in the group), 16 * warps of them per block; the block's
// K/V tiles of kMmaKeys positions, staged through the table, feed
// attn::mma_fold_tile (ROWMAX: the pre-pass, K only, attn::mma_scores and
// each row's max into cmax).  Grid as the CUDA-core route's.
template <int HD, int MODE, bool ROWMAX>
__device__ __forceinline__ void paged_mma(const Args<bf16>& a) {
  constexpr int BN = kMmaKeys, LD = attn::kMmaLd<HD>;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int DT = HD / 8;
  constexpr int ROM = ROWMAX ? 0 : attn::kRomSize<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, rows = 16 * warps;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (rows, LD)
  bf16* ks = qs + rows * LD;                 // (2, BN, LD)
  bf16* vs = ks + 2 * BN * LD;               // (2, BN, LD), not for ROWMAX
  float* rom_s = reinterpret_cast<float*>(vs + 2 * BN * LD);

  const int n_chunks = a.n_chunks;
  const int group = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = a.hq / a.hkv, nrows = a.tq * g, window = a.window;
  const int row0 = group * rows, row_end = min(nrows, row0 + rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tig = lane & 3;
  const int* prow = a.pos + (size_t)b * a.tq;
  const int* trow = a.btab + (size_t)b * a.nb;

  const Extent ext = chunk_extent(prow, row0 / g, (row_end - 1) / g, a.nb,
                                  a.bs, window, chunk, a.chunk_keys, BN);
  const int lo_c = ext.lo_c, hi_c = ext.hi_c;
  const int ntiles = hi_c >= lo_c ? (hi_c - lo_c) / BN + 1 : 0;
  const size_t nrc = (size_t)a.B * a.tq * a.hq * n_chunks;
  // query row r's index (b*T + t)*Hq + qh
  auto row_index = [&](int r) {
    return ((size_t)b * a.tq + r / g) * a.hq + h * g + r % g;
  };

  if (ntiles == 0) {  // no key of this chunk: an empty partial, or zeros
    const int per_row = !ROWMAX && n_chunks == 1 ? HD : 1;
    for (int i = tid; i < (row_end - row0) * per_row; i += blockDim.x) {
      if (ROWMAX) {
        a.cmax[row_index(row0 + i) * n_chunks + chunk] = -INFINITY;
      } else if (n_chunks == 1) {
        a.out[row_index(row0 + i / HD) * HD + i % HD] = __float2bfloat16(0.f);
      } else {
        const size_t rc = row_index(row0 + i) * n_chunks + chunk;
        a.part[nrc * HD + rc] = -INFINITY;
        a.part[nrc * HD + nrc + rc] = 0.f;
      }
    }
    return;
  }

  // group 0: the Q tile (rows past the group's last zero)
  for (int i = tid; i < rows * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = (i % CPR) * 8, r = row0 + rr;
    const bool ok = r < row_end;
    attn::cp_async16(qs + rr * LD + c, ok ? a.q + row_index(r) * HD + c : a.q,
                     ok);
  }
  attn::cp_async_commit();
  // one group per K (and V) tile, read through the table; rows past hi_c
  // zero
  auto load_kv = [&](int buf, int p0) {
    bf16* kd = ks + buf * BN * LD;
    bf16* vd = vs + buf * BN * LD;
    for (int i = tid; i < BN * CPR; i += blockDim.x) {
      const int j = i / CPR, c = (i % CPR) * 8, p = p0 + j;
      const bool ok = p <= hi_c;
      size_t off = 0;
      if (ok)
        off = (((size_t)trow[p / a.bs] * a.bs + p % a.bs) * a.hkv + h) * HD +
              c;
      attn::cp_async16(kd + j * LD + c, a.kpool + off, ok);
      if constexpr (!ROWMAX)
        attn::cp_async16(vd + j * LD + c, a.vpool + off, ok);
    }
    attn::cp_async_commit();
  };
  load_kv(0, lo_c);
  // the mode's table, while the first copies fly
  for (int i = tid; i < ROM; i += blockDim.x) rom_s[i] = a.rom[i];

  // This thread's two query rows (gid and gid + 8 of the warp's 16) and
  // their positions; a row past the group's last sees no key.
  const int ra = row0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int pos_a = ra < row_end ? prow[ra / g] : -1;
  const int pos_b = rb < row_end ? prow[rb / g] : -1;
  // the keys each sees: lo < p <= hi
  const int lo_r[2] = {window > 0 ? pos_a - window : -1,
                       window > 0 ? pos_b - window : -1};
  const int hi_r[2] = {min(pos_a, hi_c), min(pos_b, hi_c)};
  attn::MmaCarry<HD> c;
  attn::mma_carry_init(c);
  bool seen[2] = {true, true};  // the chunk has a key the row sees
  if constexpr (kPremax<MODE> && !ROWMAX) {
    // each row's max, in which every chunk weighs: the quad splits the
    // chunk maxima
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = x ? rb : ra;
      if (r >= row_end) continue;  // quad-uniform
      const float* cm = a.cmax + row_index(r) * n_chunks;
      for (int k = tig; k < n_chunks; k += 4) c.m[x] = fmaxf(c.m[x], cm[k]);
      seen[x] = cm[chunk] > -INFINITY;
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      c.m[0] = fmaxf(c.m[0], __shfl_xor_sync(attn::kFull, c.m[0], off));
      c.m[1] = fmaxf(c.m[1], __shfl_xor_sync(attn::kFull, c.m[1], off));
    }
  }
  attn::MmaQuery<HD> qf;
  attn::mma_query_init(qf, qs, warp, lane);

  for (int it = 0; it < ntiles; ++it) {
    const int p0 = lo_c + it * BN;
    if (it + 1 < ntiles) {
      load_kv((it + 1) & 1, p0 + BN);
      attn::cp_async_wait<1>();  // Q and tile it have landed
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // (and the mode's ROM is published)
    if (it == 0) attn::mma_query_load(qf);
    const bf16* kt = ks + (it & 1) * BN * LD;
    if constexpr (ROWMAX) {
      // the fold's scores (attn::mma_fold_tile), their max
      float s[BN / 8][4];
      attn::mma_scores<HD, BN>(s, qf, kt, p0, lane, a.scale, false, lo_r,
                               hi_r);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        c.m[0] = fmaxf(c.m[0], fmaxf(s[j][0], s[j][1]));
        c.m[1] = fmaxf(c.m[1], fmaxf(s[j][2], s[j][3]));
      }
    } else {
      attn::mma_fold_tile<HD, BN, MODE, true>(
          c, qf, kt, vs + (it & 1) * BN * LD, p0, lane, a.scale, false, lo_r,
          hi_r, rom_s);
    }
    __syncthreads();  // every warp is done with this buffer
  }

  if constexpr (ROWMAX) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      c.m[0] = fmaxf(c.m[0], __shfl_xor_sync(attn::kFull, c.m[0], off));
      c.m[1] = fmaxf(c.m[1], __shfl_xor_sync(attn::kFull, c.m[1], off));
    }
    if (tig == 0) {
      if (ra < row_end) a.cmax[row_index(ra) * n_chunks + chunk] = c.m[0];
      if (rb < row_end) a.cmax[row_index(rb) * n_chunks + chunk] = c.m[1];
    }
    return;
  } else {
    attn::mma_finish<HD, MODE>(c);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = x ? rb : ra;
      if (r >= row_end) continue;
      const size_t ri = row_index(r);
      if (n_chunks == 1) {
        attn::mma_store_row<HD>(a.out + ri * HD, c, x, lane);
        continue;
      }
      const size_t rc = ri * n_chunks + chunk;
      const float m = seen[x] ? c.m[x] : -INFINITY;
      if (m > -INFINITY) {  // the combine skips m = -inf
        float* dst = a.part + rc * HD + tig * 2;
#pragma unroll
        for (int d = 0; d < DT; ++d)
          *reinterpret_cast<float2*>(dst + d * 8) =
              make_float2(c.o[d][2 * x], c.o[d][2 * x + 1]);
      }
      if (tig == 0) {
        a.part[nrc * HD + rc] = m;
        a.part[nrc * HD + nrc + rc] = c.l[x];
      }
    }
  }
}

template <int HD, int MODE>
__global__ void __launch_bounds__(32 * kMmaWarps) paged_attention_mma_kernel(
    const Args<bf16> a) {
  paged_mma<HD, MODE, false>(a);
}

template <int HD>
__global__ void __launch_bounds__(32 * kMmaWarps) paged_rowmax_mma_kernel(
    const Args<bf16> a) {
  paged_mma<HD, attn::kExact, true>(a);
}

// Merge the n_chunks partials of each query row in chunk order: one warp
// per row, nothing atomic.  The lanes read 32 chunks' (m, l) at a time and
// weigh them; the sums then run over the chunks in order, skipping every
// chunk of weight 0 (empty, m = -inf, or far below the max) and starting
// from -0, so that a single chunk of weight 1 passes its partial through
// bit for bit: the one-chunk path's result.
template <typename T, int HD, int MODE>
__global__ void paged_combine_kernel(const float* __restrict__ part,
                                     T* __restrict__ out, int rows,
                                     int n_chunks) {
  constexpr int EPL = attn::kEpl<HD>;
  const int r = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const size_t nrc = (size_t)rows * n_chunks;
  const float* pacc = part + (size_t)r * n_chunks * HD + lane * EPL;
  const float* pm = part + nrc * HD + (size_t)r * n_chunks;
  const float* pl = pm + nrc;
  const bool lane_on = lane < HD / EPL;
  float mx = -INFINITY;
  for (int c = lane; c < n_chunks; c += 32) mx = fmaxf(mx, pm[c]);
  mx = attn::warp_max(mx);
  const float zero = mx == -INFINITY ? 0.f : -0.f;
  float acc[EPL], l = zero;
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = zero;
  if constexpr (MODE == attn::kMaxOnly) {
    // the first chunk at the highest max: a strictly higher max wins, so
    // a tie keeps the earlier chunk
    for (int c0 = 0; c0 < n_chunks && mx > -INFINITY; c0 += 32) {
      const int c = c0 + lane;
      const unsigned hit =
          __ballot_sync(attn::kFull, c < n_chunks && pm[c] == mx);
      if (hit) {
        const int win = c0 + __ffs(hit) - 1;
        l = pl[win];
        if (lane_on) attn::load_floats<float, EPL>(pacc + win * HD, acc);
        break;
      }
    }
  } else {
    for (int c0 = 0; c0 < n_chunks && mx > -INFINITY; c0 += 32) {
      const int c = c0 + lane;
      // an empty chunk (m = -inf) weighs nothing
      const float mc = c < n_chunks ? pm[c] : -INFINITY;
      const float w_mine =
          mc == -INFINITY ? 0.f : attn::carry_scale<MODE>(mc - mx);
      const float l_mine = c < n_chunks ? pl[c] : 0.f;
      const int n = min(32, n_chunks - c0);
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const float w = __shfl_sync(attn::kFull, w_mine, j);
        const float lj = __shfl_sync(attn::kFull, l_mine, j);
        if (w == 0.f) continue;  // warp-uniform
        l = fmaf(lj, w, l);
        float x[EPL] = {};
        if (lane_on) attn::load_floats<float, EPL>(pacc + (c0 + j) * HD, x);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(x[e], w, acc[e]);
      }
    }
  }
  attn::store_row<T, HD>(out + (size_t)r * HD, lane, acc, l);
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD, int MODE>
cudaError_t combine(void* part, void* out, int B, int tq, int hq,
                    int n_chunks, cudaStream_t stream) {
  const int rows = B * tq * hq;
  paged_combine_kernel<T, HD, MODE><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(part), static_cast<T*>(out), rows, n_chunks);
  return cudaGetLastError();
}

// The pre-pass (kPremax modes), the fold, then the combine (n_chunks > 1),
// on the CUDA-core route.
template <typename T, int HD, int MODE>
cudaError_t launch(const Args<T>& a, cudaStream_t stream) {
  const int nq = a.tq * (a.hq / a.hkv);
  const int warps = nq < 4 ? 4 : (nq > 32 ? 32 : nq);
  const dim3 grid(((nq + 31) / 32) * a.n_chunks, a.hkv, a.B);
  if constexpr (kPremax<MODE>) {
    auto pre = paged_rowmax_kernel<T, HD>;
    static const cudaError_t attr =
        allow_smem(pre, smem_bytes<T, HD, MODE, true>(32));
    if (attr != cudaSuccess) return attr;
    pre<<<grid, 32 * warps, smem_bytes<T, HD, MODE, true>(warps), stream>>>(
        a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = paged_attention_kernel<T, HD, MODE>;
  static const cudaError_t attr =
      allow_smem(kernel, smem_bytes<T, HD, MODE, false>(32));
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, 32 * warps, smem_bytes<T, HD, MODE, false>(warps),
           stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return err;
  return combine<T, HD, MODE>(a.part, a.out, a.B, a.tq, a.hq, a.n_chunks,
                              stream);
}

// The same three launches on the tensor-core route.
template <int HD, int MODE>
cudaError_t launch_mma(const Args<bf16>& a, cudaStream_t stream) {
  const int nq = a.tq * (a.hq / a.hkv);
  const int warps = (nq + 15) / 16 < kMmaWarps ? (nq + 15) / 16 : kMmaWarps;
  const int groups = (nq + 16 * warps - 1) / (16 * warps);
  const dim3 grid(groups * a.n_chunks, a.hkv, a.B);
  if constexpr (kPremax<MODE>) {
    auto pre = paged_rowmax_mma_kernel<HD>;
    static const cudaError_t attr =
        allow_smem(pre, mma_smem_bytes<HD, MODE, true>(kMmaWarps));
    if (attr != cudaSuccess) return attr;
    pre<<<grid, 32 * warps, mma_smem_bytes<HD, MODE, true>(warps), stream>>>(
        a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = paged_attention_mma_kernel<HD, MODE>;
  static const cudaError_t attr =
      allow_smem(kernel, mma_smem_bytes<HD, MODE, false>(kMmaWarps));
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, 32 * warps, mma_smem_bytes<HD, MODE, false>(warps),
           stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return err;
  return combine<bf16, HD, MODE>(a.part, a.out, a.B, a.tq, a.hq, a.n_chunks,
                                 stream);
}

template <int MODE>
cudaError_t dispatch(const void* q, const void* kpool, const void* vpool,
                     const void* btab, const void* pos, const void* rom,
                     void* out, void* part, void* cmax, int B, int tq,
                     int hq, int hkv, int hd, int bs, int nb, int window,
                     int dtype, float scale, int n_chunks, int chunk_keys,
                     cudaStream_t s) {
  // the route: the dtype only (the header)
#define REPRO_PA_ARGS(TYPE)                                                 \
  Args<TYPE>{static_cast<const TYPE*>(q), static_cast<const TYPE*>(kpool),  \
             static_cast<const TYPE*>(vpool), static_cast<const int*>(btab), \
             static_cast<const int*>(pos), static_cast<const float*>(rom),   \
             static_cast<TYPE*>(out), static_cast<float*>(part),            \
             static_cast<float*>(cmax), B, tq, hq, hkv, bs, nb, window,     \
             scale, n_chunks, chunk_keys}
#define REPRO_PA_CASE(HD) \
  return launch<float, HD, MODE>(REPRO_PA_ARGS(float), s)
#define REPRO_PA_MMA(HD) \
  return launch_mma<HD, MODE>(REPRO_PA_ARGS(bf16), s)
  if (dtype == 1) {
    switch (hd) {
      case 16: REPRO_PA_MMA(16);
      case 32: REPRO_PA_MMA(32);
      case 64: REPRO_PA_MMA(64);
      case 128: REPRO_PA_MMA(128);
      case 192: REPRO_PA_MMA(192);
      case 256: REPRO_PA_MMA(256);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_PA_CASE(16);
      case 32: REPRO_PA_CASE(32);
      case 64: REPRO_PA_CASE(64);
      case 128: REPRO_PA_CASE(128);
      case 192: REPRO_PA_CASE(192);
      case 256: REPRO_PA_CASE(256);
    }
  }
#undef REPRO_PA_MMA
#undef REPRO_PA_CASE
#undef REPRO_PA_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {16, 32, 64, 128, 192, 256};
// any T * Hq / Hkv; B and Hkv at most 65,535.  mode: 0 exact, 1 base2,
// 2 pseudo, 3 pwl, 4 maxonly; rom: device f32 table of 256 (base2) or 17
// (pwl) entries, ignored by the other modes.  n_chunks chunks of
// chunk_keys positions (a multiple of 64) cover [0, nb * bs); n_chunks >
// 1 needs part, f32 scratch of B*T*Hq*n_chunks*(hd + 2) floats; base2
// and pwl need cmax, f32 scratch of B*T*Hq*n_chunks floats.  Returns a
// cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* btab,
                                     const void* pos, void* out, int B,
                                     int tq, int hq, int hkv, int hd, int bs,
                                     int nb, int window, int dtype, int mode,
                                     const void* rom, float scale,
                                     int n_chunks, int chunk_keys, void* part,
                                     void* cmax, void* stream) {
  if (B <= 0 || B > 65535 || tq <= 0 || hkv <= 0 || hkv > 65535 ||
      hq % hkv != 0 || bs <= 0 || nb <= 0 || n_chunks <= 0 ||
      chunk_keys <= 0 || chunk_keys % kChunkQuantum != 0 ||
      (long long)n_chunks * chunk_keys < (long long)nb * bs ||
      (long long)(tq * (hq / hkv) + 15) / 16 * n_chunks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if ((mode == attn::kBase2 || mode == attn::kPwl) &&
      (rom == nullptr || cmax == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_chunks > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_MODE(MODE)                                                 \
  case MODE:                                                                \
    return (int)dispatch<MODE>(q, kpool, vpool, btab, pos, rom, out, part,  \
                               cmax, B, tq, hq, hkv, hd, bs, nb, window,    \
                               dtype, scale, n_chunks, chunk_keys, s)
  switch (mode) {
    REPRO_PA_MODE(attn::kExact);
    REPRO_PA_MODE(attn::kBase2);
    REPRO_PA_MODE(attn::kPseudo);
    REPRO_PA_MODE(attn::kPwl);
    REPRO_PA_MODE(attn::kMaxOnly);
  }
#undef REPRO_PA_MODE
  return (int)cudaErrorInvalidValue;
}
