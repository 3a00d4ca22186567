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
// the 3.35 TB/s of HBM.  What held the unsplit kernel back was latency:
// one block walked its row's whole history in serial stages, so the
// longest row set the time and a batch of 8 rows filled 64 of 132 SMs.
//
// Design: split-KV decode with a deterministic combine.
//   * query rows: the g = Hq/Hkv query heads of a kv head and the row's T
//     query tokens share each staged K/V tile -- GQA-native, no K/V
//     repeat.  One warp per query row, groups of at most 32 rows;
//   * chunks: the kv positions [0, nb*bs) split into n_chunks chunks of
//     chunk_keys positions (a multiple of the stage), one thread block
//     per (batch row b, kv head h, query group, chunk): grid (B, Hkv,
//     groups * n_chunks).  The wrapper picks n_chunks from shapes alone
//     (never from the positions, which would sync the host) so that the
//     grid covers the SMs; base2 and pwl always take one chunk: their
//     weight f(s - m) is not multiplicative across a shift of the max,
//     so a chunk's partial could not be rescaled to the row's max;
//   * a block walks the positions of its chunk inside its group's extent
//     [lo, hi] (hi = the group's largest query position, lo = the
//     window's start) in stages of STAGE positions.  The stage's pool
//     blocks are looked up in the table once each, into shared memory,
//     and its K and V rows copied with 16-byte cp.async, double-buffered:
//     the next stage's copies fly while the current one is folded.  Rows
//     past the chunk's end are zero-filled and never visible;
//   * each warp carries its query row's online softmax (m, l, acc) in f32
//     registers through attn::fold_stage (csrc/attention_tile.cuh, shared
//     with flash_attention.cu), which holds the five score modes;
//   * with one chunk the block writes acc / l itself.  Otherwise it
//     writes its rows' f32 partials (m, l, acc[hd]) -- an empty chunk
//     writes m = -inf, l = 0 -- into scratch the wrapper allocates, and
//     a combine kernel, one warp per query row, merges them in chunk
//     order with no atomics, so the output is the same bits every call:
//     exact rescales chunk c by expf(m_c - M), pseudo by exp2f(m_c - M);
//     maxonly is a comparator merge: the strictly higher m wins, so a tie
//     keeps the earlier chunk and its lower positions;
//   * a query with no visible key writes 0 (l is clamped at 1e-30 as the
//     TPU kernel does);
//   * the base2 LUT (256 f32) and the pwl ROM (17 f32) come from the
//     caller and sit in shared memory, loaded once per block: lanes index
//     different entries, which __constant__ memory would serialise.
//     The TPU evaluates the base2/pwl weight at a 16-position pool
//     block's running max, this kernel at a 32-key slice's, so those two
//     modes agree with it to one LUT bin or chord, not to rounding.
// What it leaves on the table: the inner fold runs on the CUDA cores (a
// lane's f32 dot product per key, a shuffle per key for P.V), not the
// tensor cores; base2 and pwl would split with a max pre-pass.
#include <climits>

#include "attention_tile.cuh"

namespace {

// 64 staged positions when both tiles fit in 32 KB, else 32.
template <typename T, int HD>
constexpr int kStage = (2 * 64 * HD * (int)sizeof(T) <= 32768) ? 64 : 32;

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

// q (B, T, Hq, HD); pools (num_blocks, bs, Hkv, HD); btab (B, nb) i32;
// pos (B, T) i32; out (B, T, Hq, HD); rom the mode's f32 table
// (attn::kRomSize<MODE> entries; unused without one).  window <= 0 means
// no window.  With n_chunks > 1, part holds the partials of the
// B*T*Hq query rows R = (b*T + t)*Hq + qh: acc at part[(R*n_chunks +
// c)*HD], then m and then l at [RC*HD + R*n_chunks + c] and [RC*HD + RC
// + ...], RC = B*T*Hq*n_chunks.
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

  const int b = blockIdx.x, h = blockIdx.y;
  const int group = blockIdx.z / n_chunks, chunk = blockIdx.z % n_chunks;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = group * 32;  // this group's first query row
  const int qrow = row0 + warp;
  const int row_end = min(tq * g, row0 + 32);
  const bool active = qrow < row_end;
  const int* prow = pos + (size_t)b * tq;
  const int* trow = btab + (size_t)b * nb;

  // The group's kv extent: its largest query position caps it (clipped
  // to the table), its smallest one minus the window opens it; then the
  // chunk's share of it.
  int hi = -1, lo_q = INT_MAX;
  for (int t = row0 / g; t <= (row_end - 1) / g; ++t) {
    hi = max(hi, prow[t]);
    lo_q = min(lo_q, prow[t]);
  }
  hi = min(hi, nb * bs - 1);
  const int lo = window > 0 ? max(0, lo_q - window + 1) : 0;
  const int c0 = chunk * chunk_keys;
  const int lo_c = max(lo, c0), hi_c = min(hi, c0 + chunk_keys - 1);
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
  if (lane < HD / EPL) {
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

// Merge the n_chunks partials of each query row in chunk order: one warp
// per row, nothing atomic.  The lanes read 32 chunks' (m, l) at a time and
// weigh them; the sums then run over the chunks in order.
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
  float acc[EPL] = {}, l = 0.f;
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
        l = fmaf(__shfl_sync(attn::kFull, l_mine, j), w, l);
        float x[EPL] = {};
        if (lane_on) attn::load_floats<float, EPL>(pacc + (c0 + j) * HD, x);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = fmaf(x[e], w, acc[e]);
      }
    }
  }
  attn::store_row<T, HD>(out + (size_t)r * HD, lane, acc, l);
}

template <typename T, int HD, int MODE>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* btab, const void* pos, const void* rom,
                   void* out, void* part, int B, int tq, int hq, int hkv,
                   int bs, int nb, int window, float scale, int n_chunks,
                   int chunk_keys, cudaStream_t stream) {
  const int nq = tq * (hq / hkv);
  const int warps = nq < 4 ? 4 : (nq > 32 ? 32 : nq);
  const size_t smem = smem_bytes<T, HD, MODE>(warps);
  auto kernel = paged_attention_kernel<T, HD, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, hkv, ((nq + 31) / 32) * n_chunks);
  const dim3 block(32 * warps);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(btab),
      static_cast<const int*>(pos), static_cast<const float*>(rom),
      static_cast<T*>(out), static_cast<float*>(part), B, tq, hq, hkv, bs,
      nb, window, scale, n_chunks, chunk_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
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

template <int MODE>
cudaError_t dispatch(const void* q, const void* kpool, const void* vpool,
                     const void* btab, const void* pos, const void* rom,
                     void* out, void* part, int B, int tq, int hq, int hkv,
                     int hd, int bs, int nb, int window, int dtype,
                     float scale, int n_chunks, int chunk_keys,
                     cudaStream_t s) {
#define REPRO_PA_CASE(TYPE, HD)                                           \
  return launch<TYPE, HD, MODE>(q, kpool, vpool, btab, pos, rom, out,     \
                                part, B, tq, hq, hkv, bs, nb, window,     \
                                scale, n_chunks, chunk_keys, s)
  if (dtype == 1) {
    switch (hd) {
      case 16: REPRO_PA_CASE(__nv_bfloat16, 16);
      case 32: REPRO_PA_CASE(__nv_bfloat16, 32);
      case 64: REPRO_PA_CASE(__nv_bfloat16, 64);
      case 128: REPRO_PA_CASE(__nv_bfloat16, 128);
      case 256: REPRO_PA_CASE(__nv_bfloat16, 256);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_PA_CASE(float, 16);
      case 32: REPRO_PA_CASE(float, 32);
      case 64: REPRO_PA_CASE(float, 64);
      case 128: REPRO_PA_CASE(float, 128);
      case 256: REPRO_PA_CASE(float, 256);
    }
  }
#undef REPRO_PA_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {16, 32, 64, 128, 256}; any
// T * Hq / Hkv (groups of 32 query rows per block).  mode: 0 exact,
// 1 base2, 2 pseudo, 3 pwl, 4 maxonly; rom: device f32 table of 256
// (base2) or 17 (pwl) entries, ignored by the other modes.  n_chunks
// chunks of chunk_keys positions (a multiple of 64) cover [0, nb * bs);
// n_chunks > 1 needs mode exact, pseudo or maxonly and part, f32 scratch
// of B*T*Hq*n_chunks*(hd + 2) floats.  Returns a cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* btab,
                                     const void* pos, void* out, int B,
                                     int tq, int hq, int hkv, int hd, int bs,
                                     int nb, int window, int dtype, int mode,
                                     const void* rom, float scale,
                                     int n_chunks, int chunk_keys, void* part,
                                     void* stream) {
  if (B <= 0 || tq <= 0 || hkv <= 0 || hq % hkv != 0 || bs <= 0 ||
      nb <= 0 || n_chunks <= 0 || chunk_keys <= 0 || chunk_keys % 64 != 0 ||
      (long long)n_chunks * chunk_keys < (long long)nb * bs ||
      (long long)(tq * (hq / hkv) + 31) / 32 * n_chunks > 65535)
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
