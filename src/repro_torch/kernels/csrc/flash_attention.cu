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
// head stay under the card's ~295 bf16 tensor-core flops per byte.
//
// Design, right and simple first (the TPU's sequential ns grid axis with
// its VMEM (m, l, acc) carry becomes a loop over K/V stages inside one
// thread block):
//   * one thread block per (batch row b, kv head h, group of 32 query
//     rows): the query rows of (b, h) are the pairs (t, head of the
//     group), g consecutive rows per query position, so the g heads that
//     share a kv head sit in one block and every staged K/V byte serves
//     all of them;
//   * the block walks keys [lo, hi]: a causal block stops at its last
//     query (hi = min(t_last, S - 1)), a windowed block starts at its
//     first query's first visible key (lo = t_first - window + 1); the
//     (STAGE, HD) K and V tiles go to shared memory with 16-byte loads
//     through the operands' strides, rows past hi zero;
//   * each warp owns one query row and carries the online softmax (m, l,
//     acc) in f32 registers, HD/32 accumulators per lane: a score is a
//     warp-wide dot product, a masked key scores -inf, and a 32-key slice
//     with no visible key leaves the carry alone -- the paged-attention
//     kernel's inner loop, shared through csrc/attention_tile.cuh;
//   * groups are launched last query first, so the longest causal rows
//     start first.
// What it leaves for later PRs: the scores and the PV product run on the
// CUDA cores in f32 (no mma.sync / wgmma tensor-core tiles), K/V stages
// are not double-buffered (no cp.async / TMA producer-consumer pipeline),
// and at g = 1 a K/V byte is read once per 32 query positions.
#include "attention_tile.cuh"

namespace {

// Element strides (batch, head, position) of one (B, H, L, HD) operand.
struct Strides {
  long long b, h, t;
};

template <typename T, int HD, int STAGE>
__global__ void __launch_bounds__(1024) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, Strides sq, Strides sk,
    Strides sv, Strides so, int tq, int s_len, int hq, int hkv, int causal,
    int window, float scale) {
  constexpr int EPL = attn::kEpl<HD>;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int CPR = HD / VEC;        // 16-byte chunks per key row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);  // (STAGE, HD)
  T* vs = ks + STAGE * HD;             // (STAGE, HD)

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
  float qv[EPL] = {}, acc[EPL] = {};
  float m = -INFINITY, l = 0.f;
  if (active) {
    t = qrow / g;
    qh = h * g + qrow % g;
    attn::load_query<T, HD>(q + b * sq.b + qh * sq.h + t * sq.t, lane, qv);
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
      *reinterpret_cast<uint4*>(ks + j * HD + c) = k4;
      *reinterpret_cast<uint4*>(vs + j * HD + c) = v4;
    }
    __syncthreads();
    if (!active) continue;
    attn::fold_stage<T, HD, STAGE>(
        ks, vs, p0, lane, qv, acc, m, l, scale, [=](int p) {
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
  const size_t smem = 2 * (size_t)STAGE * HD * sizeof(T);
  auto kernel = flash_attention_kernel<T, HD, STAGE>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int nq = tq * (hq / hkv);
  const dim3 grid(B, hkv, (nq + 31) / 32);
  const dim3 block(32 * (nq < 4 ? 4 : (nq > 32 ? 32 : nq)));
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, sv, so, tq,
      s_len, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd in {16, 32, 64, 128, 256}.
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
#define REPRO_FA_CASE(TYPE, HD)                                              \
  return (int)launch<TYPE, HD>(q, k, v, out, sq, sk, sv, so, B, tq, s_len,   \
                                hq, hkv, causal, window, scale, s)
  if (dtype == 1) {
    switch (hd) {
      case 16: REPRO_FA_CASE(__nv_bfloat16, 16);
      case 32: REPRO_FA_CASE(__nv_bfloat16, 32);
      case 64: REPRO_FA_CASE(__nv_bfloat16, 64);
      case 128: REPRO_FA_CASE(__nv_bfloat16, 128);
      case 256: REPRO_FA_CASE(__nv_bfloat16, 256);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_FA_CASE(float, 16);
      case 32: REPRO_FA_CASE(float, 32);
      case 64: REPRO_FA_CASE(float, 64);
      case 128: REPRO_FA_CASE(float, 128);
      case 256: REPRO_FA_CASE(float, 256);
    }
  }
#undef REPRO_FA_CASE
  return (int)cudaErrorInvalidValue;
}
