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
// the 3.35 TB/s of HBM.
//
// Design, right and simple first:
//   * one thread block per (batch row b, kv head h): the g = Hq/Hkv query
//     heads of the group and the row's T query tokens share each staged
//     K/V tile -- GQA-native, no K/V repeat, each K/V byte leaves HBM once
//     per row;
//   * the block walks kv positions [lo, hi] of its row in stages of STAGE
//     positions (hi = the row's largest query position, lo = the window's
//     start), looking each position's pool block up in the table, and
//     stages the (STAGE, hd) K and V tiles in shared memory with 16-byte
//     loads.  Padded table columns sit past hi and are never read;
//   * each warp owns one of the row's T*g query rows and carries the online
//     softmax (m, l, acc) in f32 registers, hd/32 accumulators per lane.
//     A block holds at most 32 warps, so T*g > 32 query rows (a wide
//     speculative window, or g = 8 heads per group) split into groups of
//     32 consecutive rows, one thread block each (grid.z): every group
//     still shares each staged K/V tile among its rows, and walks only the
//     kv extent of its own queries;
//     masked positions score -inf, a stage with nothing valid leaves the
//     carry untouched, and a query with no valid key writes 0 (l is
//     clamped at 1e-30 as the TPU kernel does).  That inner loop lives in
//     csrc/attention_tile.cuh, shared with flash_attention.cu, and holds
//     the five score modes;
//   * the base2 LUT (256 f32) and the pwl ROM (17 f32) come from the
//     caller and sit in shared memory, loaded once per block: lanes index
//     different entries, which __constant__ memory would serialise.
//     The TPU evaluates the base2/pwl weight at a 16-position pool
//     block's running max, this kernel at a 32-key slice's, so those two
//     modes agree with it to one LUT bin or chord, not to rounding.
// What it leaves on the table: a (row, head) block is one CTA, so short
// batches fill few SMs, and stages are not double-buffered.  Splitting
// long rows across CTAs (flash-decoding) and cp.async/TMA pipelining are
// the next steps.
#include <climits>

#include "attention_tile.cuh"

namespace {

// q (B, T, Hq, HD); pools (num_blocks, bs, Hkv, HD); btab (B, nb) i32;
// pos (B, T) i32; out (B, T, Hq, HD); rom the mode's f32 table
// (attn::kRomSize<MODE> entries; unused without one).  window <= 0 means
// no window.
template <typename T, int HD, int STAGE, int MODE>
__global__ void __launch_bounds__(1024) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kpool,
    const T* __restrict__ vpool, const int* __restrict__ btab,
    const int* __restrict__ pos, const float* __restrict__ rom,
    T* __restrict__ out, int tq, int hq, int hkv, int bs, int nb,
    int window, float scale) {
  constexpr int EPL = attn::kEpl<HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // 16-byte chunks per kv row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (STAGE, HD)
  T* vs = ks + STAGE * HD;             // (STAGE, HD)
  float* rom_s = reinterpret_cast<float*>(vs + STAGE * HD);
  // the first stage's __syncthreads() publishes the table
  for (int i = threadIdx.x; i < attn::kRomSize<MODE>; i += blockDim.x)
    rom_s[i] = rom[i];

  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.z * 32;  // this group's first query row
  const int qrow = row0 + warp;
  const int row_end = min(tq * g, row0 + 32);
  const bool active = qrow < row_end;
  const int* prow = pos + (size_t)b * tq;
  const int* trow = btab + (size_t)b * nb;

  // The group's kv extent: its largest query position caps it (clipped
  // to the table), its smallest one minus the window opens it.
  int hi = -1, lo_q = INT_MAX;
  for (int t = row0 / g; t <= (row_end - 1) / g; ++t) {
    hi = max(hi, prow[t]);
    lo_q = min(lo_q, prow[t]);
  }
  hi = min(hi, nb * bs - 1);
  const int lo = window > 0 ? max(0, lo_q - window + 1) : 0;

  int my_pos = -1, t = 0, qh = 0;
  float qv[EPL] = {}, acc[EPL] = {};
  float m = -INFINITY, l = 0.f;
  if (active) {
    t = qrow / g;
    qh = h * g + qrow % g;
    my_pos = prow[t];
    attn::load_query<T, HD>(q + (((size_t)b * tq + t) * hq + qh) * HD, lane,
                            qv);
  }

  for (int p0 = lo; p0 <= hi; p0 += STAGE) {
    __syncthreads();  // every warp is done with the previous stage
    for (int i = threadIdx.x; i < STAGE * CPR; i += blockDim.x) {
      const int j = i / CPR, c = (i % CPR) * VEC;
      const int p = p0 + j;
      uint4 k4 = make_uint4(0, 0, 0, 0), v4 = k4;
      if (p <= hi) {
        const int blk = trow[p / bs];
        const size_t off = (((size_t)blk * bs + p % bs) * hkv + h) * HD + c;
        k4 = *reinterpret_cast<const uint4*>(kpool + off);
        v4 = *reinterpret_cast<const uint4*>(vpool + off);
      }
      // rows past hi are zero: p * v must stay finite where p == 0
      *reinterpret_cast<uint4*>(ks + j * HD + c) = k4;
      *reinterpret_cast<uint4*>(vs + j * HD + c) = v4;
    }
    __syncthreads();
    if (!active) continue;
    attn::fold_stage<T, HD, STAGE, MODE>(
        ks, vs, p0, lane, qv, acc, m, l, scale,
        [=](int p) {
          return p <= my_pos && (window <= 0 || p > my_pos - window);
        },
        rom_s);
  }

  if (active)
    attn::store_row<T, HD>(out + (((size_t)b * tq + t) * hq + qh) * HD,
                           lane, acc, l);
}

template <typename T, int HD, int MODE>
cudaError_t launch(const void* q, const void* kpool, const void* vpool,
                   const void* btab, const void* pos, const void* rom,
                   void* out, int B, int tq, int hq, int hkv, int bs, int nb,
                   int window, float scale, cudaStream_t stream) {
  // 64 staged positions when both tiles fit in 32 KB, else 32
  constexpr int STAGE = (2 * 64 * HD * (int)sizeof(T) <= 32768) ? 64 : 32;
  const size_t smem = 2 * (size_t)STAGE * HD * sizeof(T) +
                      attn::kRomSize<MODE> * sizeof(float);
  auto kernel = paged_attention_kernel<T, HD, STAGE, MODE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nq = tq * (hq / hkv);
  const dim3 grid(B, hkv, (nq + 31) / 32);
  const dim3 block(32 * (nq < 4 ? 4 : (nq > 32 ? 32 : nq)));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int*>(btab),
      static_cast<const int*>(pos), static_cast<const float*>(rom),
      static_cast<T*>(out), tq, hq, hkv, bs, nb, window, scale);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t dispatch(const void* q, const void* kpool, const void* vpool,
                     const void* btab, const void* pos, const void* rom,
                     void* out, int B, int tq, int hq, int hkv, int hd,
                     int bs, int nb, int window, int dtype, float scale,
                     cudaStream_t s) {
#define REPRO_PA_CASE(TYPE, HD)                                              \
  return launch<TYPE, HD, MODE>(q, kpool, vpool, btab, pos, rom, out, B, tq, \
                                hq, hkv, bs, nb, window, scale, s)
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
// (base2) or 17 (pwl) entries, ignored by the other modes.  Returns a
// cudaError_t.
extern "C" int repro_paged_attention(const void* q, const void* kpool,
                                     const void* vpool, const void* btab,
                                     const void* pos, void* out, int B,
                                     int tq, int hq, int hkv, int hd, int bs,
                                     int nb, int window, int dtype, int mode,
                                     const void* rom, float scale,
                                     void* stream) {
  if (B <= 0 || tq <= 0 || hkv <= 0 || hq % hkv != 0 || bs <= 0 ||
      nb <= 0 || (tq * (hq / hkv) + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  if ((mode == attn::kBase2 || mode == attn::kPwl) && rom == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_PA_MODE(MODE)                                                 \
  case MODE:                                                                \
    return (int)dispatch<MODE>(q, kpool, vpool, btab, pos, rom, out, B, tq, \
                               hq, hkv, hd, bs, nb, window, dtype, scale, s)
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
