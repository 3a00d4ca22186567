// Flash attention for Hopper (sm_90a): causal / sliding-window / GQA
// attention of a prompt over its own keys, the scores never stored.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention at :76, body _kernel at :29, pallas_call at :100).
//
// Contract: q (B, Hq, T, HD), k and v (B, Hkv, S, HD), any strides with
// the head dim innermost; out (B, Hq, T, HD) in q's dtype, with its own
// strides.  Query and key indices both count from 0 (as the TPU kernel's
// iotas do, which matters when T != S): key p is visible to query t when
// causal => p <= t, and window > 0 => p > t - window.  Query head qh
// reads kv head qh / g (g = Hq / Hkv), with no K/V repeat.  Math in f32
// from bf16 or f32 operands, scale 1/sqrt(HD); a query with no visible
// key writes 0.
//
// Bound on the H100: at the prompt lengths served here (T = S <= 1024)
// memory -- q, k, v and out once each is ~2 * (Hq + Hkv) * T * HD bytes
// in bf16, and the 4 * HD flops per visible (query, key) pair and query
// head stay under the card's ~295 bf16 tensor-core flops per byte.  The
// work still has to reach the tensor cores to get there: on the CUDA
// cores its time follows query rows x keys.
//
// Query rows: the rows of (b, h) are the pairs (t, head of the group), g
// consecutive rows per query position, so the g heads that share a kv
// head sit in one block and every staged K/V byte serves all of them.
// Blocks launch last query tile first, so the longest causal rows start
// first.  Each block walks keys [lo, hi] of its query tile: a causal tile
// stops at its last query (hi = min(t_last, S - 1)), a windowed tile
// starts at its first query's first visible key (lo = t_first - window +
// 1), so no wholly masked key tile is visited.
//
// Two routes, by dtype (the entry's dispatch below):
//   * bf16, every HD (16..256): flash_attention_mma_kernel, on the
//     tensor cores (a profiler trace names it).  A block of 4 warps
//     owns 64 query rows, 16 per warp, and folds each K/V tile with
//     attn::mma_fold_tile (csrc/attention_tile.cuh, shared with paged
//     attention): S = Q K^T and O += P V as mma.sync.m16n8k16 bf16 x
//     bf16 -> f32 (bf16 products are exact in f32, so S matches the TPU
//     kernel's f32 scores up to summation order), the online softmax in
//     the log2 domain (scores scaled by log2 e / sqrt(HD), weights
//     exp2f) in registers; tiles wholly visible to every row of the
//     block skip the mask.  P is rounded to bf16 for the PV product (a
//     weight moves by at most 2^-9 relative, as in SDPA; the plain
//     version keeps it in f32).  64-key K and V tiles (32 above HD 128)
//     are staged with 16-byte cp.async.cg, double-buffered: the next
//     tile's copies fly while the current one is folded.  Q's A
//     fragments are loaded once into registers up to HD 128; at HD 192
//     and 256 they would take 48 or 64 more registers beside O's 96 or
//     128, so Q stays in shared memory and is re-read by ldmatrix per
//     key tile.
//   * f32: flash_attention_kernel, on the CUDA cores.  One warp per
//     query row carries the online softmax (m, l, acc) in f32 registers
//     over K/V tiles in shared memory, one lane per key scoring -- paged
//     attention's inner loop, shared through csrc/attention_tile.cuh.
//     Tensor cores would take f32 only as TF32 (10-bit mantissa), which
//     breaks the card tests' f32 tolerance of 1e-4, so f32 stays here.
// What it leaves for later PRs: a 64-row warpgroup wgmma with a TMA
// producer warp (mma.sync peaks well under wgmma's rate, which the
// served shapes do not need yet).
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Element strides (batch, head, position) of one (B, H, L, HD) operand.
struct Strides {
  long long b, h, t;
};

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles (attn::mma_fold_tile, csrc/attention_tile.cuh)
// ---------------------------------------------------------------------------
constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kThreads = 128;  // 4 warps

template <int HD>
constexpr int kKeys = HD > 128 ? 32 : 64;  // keys per staged tile
template <int HD>
constexpr size_t kMmaSmem =
    (size_t)(kRows + 4 * kKeys<HD>) * attn::kMmaLd<HD> * 2;

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Strides sq,
    Strides sk, Strides sv, Strides so, int tq, int s_len, int hq, int hkv,
    int causal, int window, float scale_log2) {
  constexpr int BN = kKeys<HD>, LD = attn::kMmaLd<HD>;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (kRows, LD)
  bf16* ks = qs + kRows * LD;                // (2, BN, LD)
  bf16* vs = ks + 2 * BN * LD;               // (2, BN, LD)

  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv, nrows = tq * g;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // last tile first
  const int row_end = min(nrows, row0 + kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2;

  // The tile's key extent from its first and last query position.
  const int t_first = row0 / g, t_last = (row_end - 1) / g;
  const int hi = causal ? min(t_last, s_len - 1) : s_len - 1;
  const int lo = window > 0 ? max(0, t_first - window + 1) : 0;
  const int ntiles = hi >= lo ? (hi - lo) / BN + 1 : 0;

  const bf16* kb = k + b * sk.b + h * sk.h;
  const bf16* vb = v + b * sv.b + h * sv.h;

  // group 0: the Q tile (rows past the last one zero)
  for (int i = tid; i < kRows * CPR; i += kThreads) {
    const int rr = i / CPR, c = (i % CPR) * 8, r = row0 + rr;
    const bool ok = r < nrows;
    const bf16* src = q;
    if (ok) src = q + b * sq.b + (h * g + r % g) * sq.h + (r / g) * sq.t + c;
    attn::cp_async16(qs + rr * LD + c, src, ok);
  }
  attn::cp_async_commit();
  // one group per K/V tile; rows past hi zero (0 * v stays finite)
  auto load_kv = [&](int buf, int p0) {
    bf16* kd = ks + buf * BN * LD;
    bf16* vd = vs + buf * BN * LD;
    for (int i = tid; i < BN * CPR; i += kThreads) {
      const int j = i / CPR, c = (i % CPR) * 8, p = p0 + j;
      const bool ok = p <= hi;
      attn::cp_async16(kd + j * LD + c, ok ? kb + p * sk.t + c : k, ok);
      attn::cp_async16(vd + j * LD + c, ok ? vb + p * sv.t + c : v, ok);
    }
    attn::cp_async_commit();
  };
  if (ntiles > 0) load_kv(0, lo);

  // This thread's two query rows (gid and gid + 8 of the warp's 16) and
  // the keys each sees: lo < p <= hi.
  const int ra = row0 + warp * 16 + gid, rb = ra + 8;
  const int ta = ra / g, tb = rb / g;
  const int lo_r[2] = {window > 0 ? ta - window : -1,
                       window > 0 ? tb - window : -1};
  const int hi_r[2] = {causal ? min(ta, s_len - 1) : s_len - 1,
                       causal ? min(tb, s_len - 1) : s_len - 1};
  attn::MmaCarry<HD> c;
  attn::mma_carry_init(c);
  attn::MmaQuery<HD> qf;
  attn::mma_query_init(qf, qs, warp, lane);

  for (int it = 0; it < ntiles; ++it) {
    const int p0 = lo + it * BN;
    if (it + 1 < ntiles) {
      load_kv((it + 1) & 1, p0 + BN);
      attn::cp_async_wait<1>();  // Q and tile it have landed
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) attn::mma_query_load(qf);
    // a tile every row of the block sees whole skips the mask
    const bool whole = p0 + BN - 1 <= s_len - 1 &&
                       (!causal || p0 + BN - 1 <= t_first) &&
                       (window <= 0 || p0 > t_last - window);
    attn::mma_fold_tile<HD, BN, attn::kPseudo, false>(
        c, qf, ks + (it & 1) * BN * LD, vs + (it & 1) * BN * LD, p0, lane,
        scale_log2, whole, lo_r, hi_r);
    __syncthreads();  // every warp is done with this buffer
  }
  attn::cp_async_wait<0>();  // no copy outlives the block (ntiles == 0)

  attn::mma_finish<HD, attn::kPseudo>(c);
  if (ra < nrows)
    attn::mma_store_row<HD>(
        out + b * so.b + (h * g + ra % g) * so.h + ta * so.t, c, 0, lane);
  if (rb < nrows)
    attn::mma_store_row<HD>(
        out + b * so.b + (h * g + rb % g) * so.h + tb * so.t, c, 1, lane);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, Strides sq, Strides sk, Strides sv,
                       Strides so, int B, int tq, int s_len, int hq, int hkv,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = kMmaSmem<HD>;
  auto kernel = flash_attention_mma_kernel<HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nq = tq * (hq / hkv);
  const dim3 grid(B, hkv, (nq + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), sq, sk, sv, so,
      tq, s_len, hq, hkv, causal, window, scale * attn::kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: one warp per query row on the CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int HD, int STAGE>
__global__ void __launch_bounds__(1024) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides sq, Strides sk,
    Strides sv, Strides so, int tq, int s_len, int hq, int hkv, int causal,
    int window, float scale) {
  constexpr int EPL = attn::kEpl<HD>;
  constexpr int LD = attn::kLd<T, HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (STAGE, LD)
  T* vs = ks + STAGE * LD;             // (STAGE, LD)
  float* qs = reinterpret_cast<float*>(vs + STAGE * LD) +
              (threadIdx.x >> 5) * HD;  // this warp's query row

  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * 32;  // last group first
  const int qrow = row0 + warp;
  const int row_end = min(tq * g, row0 + 32);
  const bool active = qrow < row_end;

  // The group's key extent from its first and last query position.
  const int t_first = row0 / g, t_last = (row_end - 1) / g;
  const int hi = causal ? min(t_last, s_len - 1) : s_len - 1;
  const int lo = window > 0 ? max(0, t_first - window + 1) : 0;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  int t = 0, qh = 0;
  float acc[EPL] = {};
  float m = -INFINITY, l = 0.f;
  if (active) {
    t = qrow / g;
    qh = h * g + qrow % g;
    attn::stage_query<T, HD>(q + b * sq.b + qh * sq.h + t * sq.t, lane, qs);
  }

  for (int p0 = lo; p0 <= hi; p0 += STAGE) {
    __syncthreads();  // every warp is done with the previous stage
    for (int i = threadIdx.x; i < STAGE * CPR; i += blockDim.x) {
      const int j = i / CPR, c = (i % CPR) * VEC;
      const int p = p0 + j;
      uint4 k4 = make_uint4(0, 0, 0, 0), v4 = k4;
      if (p <= hi) {
        k4 = *reinterpret_cast<const uint4*>(kb + p * sk.t + c);
        v4 = *reinterpret_cast<const uint4*>(vb + p * sv.t + c);
      }
      // rows past hi are zero: p * v must stay finite where p == 0
      *reinterpret_cast<uint4*>(ks + j * LD + c) = k4;
      *reinterpret_cast<uint4*>(vs + j * LD + c) = v4;
    }
    __syncthreads();
    if (!active) continue;
    attn::fold_stage<T, HD, STAGE>(
        ks, vs, p0, lane, qs, acc, m, l, scale, [=](int p) {
          return p <= hi && (!causal || p <= t) &&
                 (window <= 0 || p > t - window);
        });
  }

  if (active)
    attn::store_row<T, HD>(out + b * so.b + qh * so.h + t * so.t, lane, acc,
                           l);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int tq, int s_len, int hq, int hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  // 64 staged keys when both tiles fit in 32 KB, else 32
  constexpr int STAGE = (2 * 64 * HD * (int)sizeof(T) <= 32768) ? 64 : 32;
  const int nq = tq * (hq / hkv);
  const int warps = nq < 4 ? 4 : (nq > 32 ? 32 : nq);
  // the K and V tiles, then each warp's query row in f32
  const size_t smem = 2 * (size_t)STAGE * attn::kLd<T, HD> * sizeof(T) +
                      (size_t)warps * HD * sizeof(float);
  auto kernel = flash_attention_kernel<T, HD, STAGE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, hkv, (nq + 31) / 32);
  const dim3 block(32 * warps);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, tq,
      s_len, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {16, 32, 64, 128, 192, 256}.
// strides: 12 element strides, (batch, head, position) of q, k, v and
// out in that order; the head dim is contiguous and every row starts on
// 16 bytes.  window <= 0 means no window.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out,
                                     const long long* strides, int B, int tq,
                                     int s_len, int hq, int hkv, int hd,
                                     int causal, int window, int dtype,
                                     float scale, void* stream) {
  if (B <= 0 || tq <= 0 || s_len <= 0 || hkv <= 0 || hq % hkv != 0 ||
      hkv > 65535 || ((long long)tq * (hq / hkv) + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_FA_MMA(HD)                                                  \
  return (int)launch_mma<HD>(q, k, v, out, sq, sk, sv, so, B, tq, s_len, \
                             hq, hkv, causal, window, scale, s)
#define REPRO_FA_F32(HD)                                                     \
  return (int)launch<float, HD>(q, k, v, out, sq, sk, sv, so, B, tq, s_len, \
                                hq, hkv, causal, window, scale, s)
  if (dtype == 1) {
    switch (hd) {
      case 16: REPRO_FA_MMA(16);
      case 32: REPRO_FA_MMA(32);
      case 64: REPRO_FA_MMA(64);
      case 128: REPRO_FA_MMA(128);
      case 192: REPRO_FA_MMA(192);
      case 256: REPRO_FA_MMA(256);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_FA_F32(16);
      case 32: REPRO_FA_F32(32);
      case 64: REPRO_FA_F32(64);
      case 128: REPRO_FA_F32(128);
      case 192: REPRO_FA_F32(192);
      case 256: REPRO_FA_F32(256);
    }
  }
#undef REPRO_FA_MMA
#undef REPRO_FA_F32
  return (int)cudaErrorInvalidValue;
}
