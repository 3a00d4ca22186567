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
// combine, on two routes.
//   * query rows: the g = Hq/Hkv query heads of a kv head and the row's T
//     query tokens share each staged K/V tile -- GQA-native, no K/V
//     repeat;
//   * chunks: the kv positions [0, nb*bs) split into n_chunks chunks of
//     chunk_keys positions, one thread block per (query group, chunk, kv
//     head h, batch row b): grid (groups * n_chunks, Hkv, B).  The
//     wrapper fixes chunk_keys per (dtype, head dim), never from B, T or
//     the table width, so chunk edges sit at fixed multiples of absolute
//     position; base2 and pwl always take one chunk: their weight f(s -
//     m) is not multiplicative across a shift of the max, so a chunk's
//     partial could not be rescaled to the row's max;
//   * a block walks the positions of its chunk inside its group's extent
//     [lo, hi] (hi = the group's largest query position, lo = the
//     window's start) in stages that start at multiples of the stage's
//     width in absolute position -- never at lo -- so every stage and
//     32-key slice edge, and so every sum a row takes, depends on that
//     row's own positions only.  Each stage's K and V rows are copied
//     through the table with 16-byte cp.async, double-buffered: the next
//     stage's copies fly while the current one is folded; rows past the
//     chunk's end are zero-filled and never visible;
//   * route by dtype and mode only (the entry's dispatch):
//     bf16 exact, pseudo and maxonly take paged_attention_mma_kernel, the
//     tensor-core tile of flash attention (attn::mma_fold_tile in
//     csrc/attention_tile.cuh): the T*g query rows of a (row, kv head)
//     packed into 16-row m-tiles (rows past T*g masked out), 32-key
//     tiles, S and PV as mma.sync bf16 -> f32, P rounded to bf16 for PV
//     as SDPA does.  T = 1 rides the same tile as T = 32: at decode the
//     kernel is memory-bound, and one route for every T keeps a row's
//     bits independent of T.  f32 (TF32 would miss the f32 checks) and
//     base2 / pwl (a LUT or ROM weight per score) take
//     paged_attention_kernel, one warp per query row carrying the f32
//     online softmax through attn::fold_stage (shared with flash
//     attention's f32 route), which holds the five score modes;
//   * with one chunk the block writes acc / l itself.  Otherwise it
//     writes its rows' f32 partials (m, l, acc[hd]) -- an empty chunk
//     writes m = -inf, l = 0 and no acc -- into scratch the wrapper
//     allocates, and a combine kernel, one warp per query row, merges
//     them in chunk order with no atomics, so the output is the same
//     bits every call: exact rescales chunk c by expf(m_c - M), pseudo by
//     exp2f(m_c - M); a chunk of weight 0 is skipped and the sums start
//     at -0, so one non-empty chunk among empty ones gives exactly the
//     bits of the one-chunk path; maxonly is a comparator merge: the
//     strictly higher m wins, so a tie keeps the earlier chunk and its
//     lower positions.  A row's output is thus the same bits alone and
//     beside any batch-mates, and at any T;
//   * a query with no visible key writes 0 (l is clamped at 1e-30 as the
//     TPU kernel does);
//   * the base2 LUT (256 f32) and the pwl ROM (17 f32) come from the
//     caller and sit in shared memory, loaded once per block: lanes index
//     different entries, which __constant__ memory would serialise.
//     The TPU evaluates the base2/pwl weight at a 16-position pool
//     block's running max, this kernel at a 32-key slice's, so those two
//     modes agree with it to one LUT bin or chord, not to rounding.
// What it leaves on the table: base2 and pwl would split with a max
// pre-pass; the mma route leaves the rows of an m-tile past T*g idle (a
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

// Shared memory for a block of `warps` warps: 2 buffers of (STAGE, LD)
// K and V, each warp's query row in f32, the mode's table, then 2
// stages' pool-block ids (a stage spans at most STAGE + 1 blocks).
template <typename T, int HD, int MODE>
size_t smem_bytes(int warps) {
  return 4 * (size_t)kStage<T, HD> * attn::kLd<T, HD> * sizeof(T) +
         (size_t)warps * HD * sizeof(float) +
         attn::kRomSize<MODE> * sizeof(float) +
         2 * (kStage<T, HD> + 1) * sizeof(int);
}

// The mma route's shared memory: the Q tile of 16 * warps rows, then 2
// buffers of (kMmaKeys, LD) K and V.
template <int HD>
constexpr size_t mma_smem_bytes(int warps) {
  return (size_t)(16 * warps + 4 * kMmaKeys) * attn::kMmaLd<HD> * 2;
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

// q (B, T, Hq, HD); pools (num_blocks, bs, Hkv, HD); btab (B, nb) i32;
// pos (B, T) i32; out (B, T, Hq, HD); rom the mode's f32 table
// (attn::kRomSize<MODE> entries; unused without one).  window <= 0 means
// no window.  With n_chunks > 1, part holds the partials of the
// B*T*Hq query rows R = (b*T + t)*Hq + qh: acc at part[(R*n_chunks +
// c)*HD], then m and then l at [RC*HD + R*n_chunks + c] and [RC*HD + RC
// + ...], RC = B*T*Hq*n_chunks.  Grid (groups * n_chunks, Hkv, B), one
// warp per query row, groups of at most 32 rows.
template <typename T, int HD, int MODE>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ btab,
    const int* __restrict__ pos, const float* __restrict__ rom,
    T* __restrict__ out, float* __restrict__ part, int B, int tq, int hq,
    int hkv, int bs, int nb, int window, float scale, int n_chunks,
    int chunk_keys) {
  constexpr int STAGE = kStage<T, HD>;
  constexpr int LD = attn::kLd<T, HD>;
  constexpr int EPL = attn::kEpl<HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = HD / VEC;        // 16-byte chunks per kv row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (2, STAGE, LD)
  T* vs = ks + 2 * STAGE * LD;         // (2, STAGE, LD)
  float* q_s = reinterpret_cast<float*>(vs + 2 * STAGE * LD);  // (warps, HD)
  float* rom_s = q_s + (blockDim.x >> 5) * HD;
  int* tab_s = reinterpret_cast<int*>(rom_s + attn::kRomSize<MODE>);
  for (int i = threadIdx.x; i < attn::kRomSize<MODE>; i += blockDim.x)
    rom_s[i] = rom[i];

  const int group = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = group * 32;  // this group's first query row
  const int qrow = row0 + warp;
  const int row_end = min(tq * g, row0 + 32);
  const bool active = qrow < row_end;
  const int* prow = pos + (size_t)b * tq;
  const int* trow = btab + (size_t)b * nb;

  const Extent ext = chunk_extent(prow, row0 / g, (row_end - 1) / g, nb, bs,
                                  window, chunk, chunk_keys, STAGE);
  const int lo_c = ext.lo_c, hi_c = ext.hi_c;
  const int nst = hi_c >= lo_c ? (hi_c - lo_c) / STAGE + 1 : 0;

  int my_pos = -1, t = 0, qh = 0;
  float* qs = q_s + warp * HD;
  float acc[EPL] = {};
  float m = -INFINITY, l = 0.f;
  if (active) {
    t = qrow / g;
    qh = h * g + qrow % g;
    my_pos = prow[t];
    attn::stage_query<T, HD>(q + (((size_t)b * tq + t) * hq + qh) * HD, lane,
                             qs);
  }

  // The pool blocks of the stage at p0, one table read each.
  auto load_table = [&](int buf, int p0) {
    const int first = p0 / bs, last = min(p0 + STAGE - 1, hi_c) / bs;
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x)
      tab_s[buf * (STAGE + 1) + i] = trow[first + i];
  };
  // Its K and V rows, one cp.async group; rows past hi_c zero.
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
        off = (((size_t)tab[p / bs - first] * bs + p % bs) * hkv + h) * HD + c;
      attn::cp_async16(kd + j * LD + c, kpool + off, ok);
      attn::cp_async16(vd + j * LD + c, vpool + off, ok);
    }
    attn::cp_async_commit();
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
    attn::fold_stage<T, HD, STAGE, MODE>(
        ks + (s & 1) * STAGE * LD, vs + (s & 1) * STAGE * LD, p0, lane, qs,
        acc, m, l, scale,
        [=](int p) {
          return p <= hi_c && p <= my_pos &&
                 (window <= 0 || p > my_pos - window);
        },
        rom_s);
  }

  if (!active) return;
  const size_t r = ((size_t)b * tq + t) * hq + qh;
  if (n_chunks == 1) {
    attn::store_row<T, HD>(out + r * HD, lane, acc, l);
    return;
  }
  const size_t rc = r * n_chunks + chunk;
  const size_t nrc = (size_t)B * tq * hq * n_chunks;
  if (m > -INFINITY && lane < HD / EPL) {  // the combine skips m = -inf
    attn::Vec<float, EPL> x;
#pragma unroll
    for (int e = 0; e < EPL; ++e) x.v[e] = acc[e];
    *reinterpret_cast<attn::Vec<float, EPL>*>(part + rc * HD + lane * EPL) =
        x;
  }
  if (lane == 0) {
    part[nrc * HD + rc] = m;
    part[nrc * HD + nrc + rc] = l;
  }
}

// The tensor-core route (bf16; MODE exact, pseudo or maxonly): the T*g
// query rows of (b, h) are rows r = t*g + (head in the group), 16 * warps
// of them per block; the block's K/V tiles of kMmaKeys positions, staged
// through the table, feed attn::mma_fold_tile.  Operands, grid and
// partials as paged_attention_kernel's.
template <int HD, int MODE>
__global__ void __launch_bounds__(32 * kMmaWarps) paged_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ kpool,
    const bf16* __restrict__ vpool, const int* __restrict__ btab,
    const int* __restrict__ pos, bf16* __restrict__ out,
    float* __restrict__ part, int B, int tq, int hq, int hkv, int bs, int nb,
    int window, float scale, int n_chunks, int chunk_keys) {
  constexpr int BN = kMmaKeys, LD = attn::kMmaLd<HD>;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x >> 5, rows = 16 * warps;
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (rows, LD)
  bf16* ks = qs + rows * LD;                 // (2, BN, LD)
  bf16* vs = ks + 2 * BN * LD;               // (2, BN, LD)

  const int group = blockIdx.x / n_chunks, chunk = blockIdx.x % n_chunks;
  const int h = blockIdx.y, b = blockIdx.z;
  const int g = hq / hkv, nrows = tq * g;
  const int row0 = group * rows, row_end = min(nrows, row0 + rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int* prow = pos + (size_t)b * tq;
  const int* trow = btab + (size_t)b * nb;

  const Extent ext = chunk_extent(prow, row0 / g, (row_end - 1) / g, nb, bs,
                                  window, chunk, chunk_keys, BN);
  const int lo_c = ext.lo_c, hi_c = ext.hi_c;
  const int ntiles = hi_c >= lo_c ? (hi_c - lo_c) / BN + 1 : 0;
  const size_t nrc = (size_t)B * tq * hq * n_chunks;
  // query row r's index (b*T + t)*Hq + qh
  auto row_index = [&](int r) {
    return ((size_t)b * tq + r / g) * hq + h * g + r % g;
  };

  if (ntiles == 0) {  // no key of this chunk: an empty partial, or zeros
    for (int i = tid; i < (row_end - row0) * (n_chunks == 1 ? HD : 1);
         i += blockDim.x) {
      if (n_chunks == 1) {
        out[row_index(row0 + i / HD) * HD + i % HD] = __float2bfloat16(0.f);
      } else {
        const size_t rc = row_index(row0 + i) * n_chunks + chunk;
        part[nrc * HD + rc] = -INFINITY;
        part[nrc * HD + nrc + rc] = 0.f;
      }
    }
    return;
  }

  // group 0: the Q tile (rows past the group's last zero)
  for (int i = tid; i < rows * CPR; i += blockDim.x) {
    const int rr = i / CPR, c = (i % CPR) * 8, r = row0 + rr;
    const bool ok = r < row_end;
    attn::cp_async16(qs + rr * LD + c, ok ? q + row_index(r) * HD + c : q,
                     ok);
  }
  attn::cp_async_commit();
  // one group per K/V tile, read through the table; rows past hi_c zero
  auto load_kv = [&](int buf, int p0) {
    bf16* kd = ks + buf * BN * LD;
    bf16* vd = vs + buf * BN * LD;
    for (int i = tid; i < BN * CPR; i += blockDim.x) {
      const int j = i / CPR, c = (i % CPR) * 8, p = p0 + j;
      const bool ok = p <= hi_c;
      size_t off = 0;
      if (ok) off = (((size_t)trow[p / bs] * bs + p % bs) * hkv + h) * HD + c;
      attn::cp_async16(kd + j * LD + c, kpool + off, ok);
      attn::cp_async16(vd + j * LD + c, vpool + off, ok);
    }
    attn::cp_async_commit();
  };
  load_kv(0, lo_c);

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
    __syncthreads();
    if (it == 0) attn::mma_query_load(qf);
    attn::mma_fold_tile<HD, BN, MODE, true>(
        c, qf, ks + (it & 1) * BN * LD, vs + (it & 1) * BN * LD, p0, lane,
        scale, false, lo_r, hi_r);
    __syncthreads();  // every warp is done with this buffer
  }
  attn::mma_finish<HD, MODE>(c);

  const int tig = lane & 3;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = x ? rb : ra;
    if (r >= row_end) continue;
    const size_t ri = row_index(r);
    if (n_chunks == 1) {
      attn::mma_store_row<HD>(out + ri * HD, c, x, lane);
      continue;
    }
    const size_t rc = ri * n_chunks + chunk;
    if (c.m[x] > -INFINITY) {  // the combine skips m = -inf
      float* dst = part + rc * HD + tig * 2;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(dst + d * 8) =
            make_float2(c.o[d][2 * x], c.o[d][2 * x + 1]);
    }
    if (tig == 0) {
      part[nrc * HD + rc] = c.m[x];
      part[nrc * HD + nrc + rc] = c.l[x];
    }
  }
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
  if constexpr (MODE == attn::kExact || MODE == attn::kPseudo ||
                MODE == attn::kMaxOnly) {
    const int rows = B * tq * hq;
    paged_combine_kernel<T, HD, MODE><<<(rows + 3) / 4, 128, 0, stream>>>(
        static_cast<const float*>(part), static_cast<T*>(out), rows,
        n_chunks);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;  // unreachable: the entry refuses it
}

template <typename T, int HD, int MODE>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* btab, const void* pos, const void* rom,
                   void* out, void* part, int B, int tq, int hq, int hkv,
                   int bs, int nb, int window, float scale, int n_chunks,
                   int chunk_keys, cudaStream_t stream) {
  const int nq = tq * (hq / hkv);
  const int warps = nq < 4 ? 4 : (nq > 32 ? 32 : nq);
  auto kernel = paged_attention_kernel<T, HD, MODE>;
  static const cudaError_t attr =
      allow_smem(kernel, smem_bytes<T, HD, MODE>(32));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(((nq + 31) / 32) * n_chunks, hkv, B);
  kernel<<<grid, 32 * warps, smem_bytes<T, HD, MODE>(warps), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(btab),
      static_cast<const int*>(pos), static_cast<const float*>(rom),
      static_cast<T*>(out), static_cast<float*>(part), B, tq, hq, hkv, bs,
      nb, window, scale, n_chunks, chunk_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  return combine<T, HD, MODE>(part, out, B, tq, hq, n_chunks, stream);
}

template <int HD, int MODE>
cudaError_t launch_mma(const void* q, const void* kpool, const void* vpool,
                       const void* btab, const void* pos, void* out,
                       void* part, int B, int tq, int hq, int hkv, int bs,
                       int nb, int window, float scale, int n_chunks,
                       int chunk_keys, cudaStream_t stream) {
  const int nq = tq * (hq / hkv);
  const int warps = (nq + 15) / 16 < kMmaWarps ? (nq + 15) / 16 : kMmaWarps;
  auto kernel = paged_attention_mma_kernel<HD, MODE>;
  static const cudaError_t attr =
      allow_smem(kernel, mma_smem_bytes<HD>(kMmaWarps));
  if (attr != cudaSuccess) return attr;
  const int groups = (nq + 16 * warps - 1) / (16 * warps);
  const dim3 grid(groups * n_chunks, hkv, B);
  kernel<<<grid, 32 * warps, mma_smem_bytes<HD>(warps), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), static_cast<const int*>(btab),
      static_cast<const int*>(pos), static_cast<bf16*>(out),
      static_cast<float*>(part), B, tq, hq, hkv, bs, nb, window, scale,
      n_chunks, chunk_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  return combine<bf16, HD, MODE>(part, out, B, tq, hq, n_chunks, stream);
}

template <int MODE>
cudaError_t dispatch(const void* q, const void* kpool, const void* vpool,
                     const void* btab, const void* pos, const void* rom,
                     void* out, void* part, int B, int tq, int hq, int hkv,
                     int hd, int bs, int nb, int window, int dtype,
                     float scale, int n_chunks, int chunk_keys,
                     cudaStream_t s) {
  // the route: dtype and mode only (the header)
  constexpr bool kMma = MODE == attn::kExact || MODE == attn::kPseudo ||
                        MODE == attn::kMaxOnly;
#define REPRO_PA_CASE(TYPE, HD)                                           \
  return launch<TYPE, HD, MODE>(q, kpool, vpool, btab, pos, rom, out,     \
                                part, B, tq, hq, hkv, bs, nb, window,     \
                                scale, n_chunks, chunk_keys, s)
#define REPRO_PA_MMA(HD)                                                    \
  if constexpr (kMma) {                                                     \
    return launch_mma<HD, MODE>(q, kpool, vpool, btab, pos, out, part, B,   \
                                tq, hq, hkv, bs, nb, window, scale,         \
                                n_chunks, chunk_keys, s);                   \
  } else {                                                                  \
    REPRO_PA_CASE(bf16, HD);                                                \
  }
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
      case 16: REPRO_PA_CASE(float, 16);
      case 32: REPRO_PA_CASE(float, 32);
      case 64: REPRO_PA_CASE(float, 64);
      case 128: REPRO_PA_CASE(float, 128);
      case 192: REPRO_PA_CASE(float, 192);
      case 256: REPRO_PA_CASE(float, 256);
    }
  }
#undef REPRO_PA_MMA
#undef REPRO_PA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {16, 32, 64, 128, 192, 256};
// any T * Hq / Hkv; B and Hkv at most 65,535.  mode: 0 exact, 1 base2,
// 2 pseudo, 3 pwl, 4 maxonly; rom: device f32 table of 256 (base2) or 17
// (pwl) entries, ignored by the other modes.  n_chunks chunks of
// chunk_keys positions (a multiple of 64) cover [0, nb * bs); n_chunks >
// 1 needs mode exact, pseudo or maxonly and part, f32 scratch of
// B*T*Hq*n_chunks*(hd + 2) floats.  Returns a cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* btab,
                                     const void* pos, void* out, int B,
                                     int tq, int hq, int hkv, int hd, int bs,
                                     int nb, int window, int dtype, int mode,
                                     const void* rom, float scale,
                                     int n_chunks, int chunk_keys, void* part,
                                     void* stream) {
  if (B <= 0 || B > 65535 || tq <= 0 || hkv <= 0 || hkv > 65535 ||
      hq % hkv != 0 || bs <= 0 || nb <= 0 || n_chunks <= 0 ||
      chunk_keys <= 0 || chunk_keys % kChunkQuantum != 0 ||
      (long long)n_chunks * chunk_keys < (long long)nb * bs ||
      (long long)(tq * (hq / hkv) + 15) / 16 * n_chunks > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if ((mode == attn::kBase2 || mode == attn::kPwl) && rom == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_chunks > 1 && (part == nullptr || mode == attn::kBase2 ||
                       mode == attn::kPwl))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_MODE(MODE)                                                 \
  case MODE:                                                                \
    return (int)dispatch<MODE>(q, kpool, vpool, btab, pos, rom, out, part,  \
                               B, tq, hq, hkv, hd, bs, nb, window, dtype,   \
                               scale, n_chunks, chunk_keys, s)
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
