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
//     owns 64 query rows, 16 per warp.  S = Q K^T and O += P V run as
//     mma.sync.m16n8k16 bf16 x bf16 -> f32; bf16 products are exact in
//     f32, so S matches the TPU kernel's f32 scores up to summation
//     order.  The online softmax (m, l) of a thread's 2 rows lives in
//     registers, the row max and sum reduced over the quad with 2
//     shuffles; tiles wholly visible to every row of the block skip the
//     mask.  P goes from the S accumulators to bf16 A fragments in
//     registers (rounding a weight by at most 2^-9 relative, as SDPA
//     does; the plain version keeps it in f32), and V's B fragments come
//     from ldmatrix.trans.  64-key K and V tiles (32 at HD 256) are
//     staged with 16-byte cp.async.cg, double-buffered: the next tile's
//     copies fly while the current one is folded.  Shared rows are
//     padded by 16 bytes, so the 8 row addresses of an ldmatrix land in
//     8 different bank groups.  Q's A fragments are loaded once into
//     registers by ldmatrix at HD <= 128; at HD 256 they would take 64
//     more registers beside O's 128, so Q stays in shared memory and is
//     re-read by ldmatrix per key tile.
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
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and register i holds row lane/4, columns 2*(lane%4) + {0, 1}
// of matrix i (of its transpose with .trans).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 row-major bf16) * b (16x8 col-major bf16), f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 -> one register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kRows = 64;      // query rows per block, 16 per warp
constexpr int kThreads = 128;  // 4 warps

template <int HD>
constexpr int kKeys = HD > 128 ? 32 : 64;  // keys per staged tile
template <int HD>
constexpr bool kQInRegs = HD <= 128;
template <int HD>
constexpr int kMmaLd = HD + 8;  // padded shared row, elements
template <int HD>
constexpr size_t kMmaSmem = (size_t)(kRows + 4 * kKeys<HD>) * kMmaLd<HD> * 2;

template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, Strides sq,
    Strides sk, Strides sv, Strides so, int tq, int s_len, int hq, int hkv,
    int causal, int window, float scale_log2) {
  constexpr int BN = kKeys<HD>, LD = kMmaLd<HD>;
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  constexpr int DT = HD / 8;   // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);  // (kRows, LD)
  bf16* ks = qs + kRows * LD;                // (2, BN, LD)
  bf16* vs = ks + 2 * BN * LD;               // (2, BN, LD)

  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv, nrows = tq * g;
  const int row0 = (gridDim.z - 1 - blockIdx.z) * kRows;  // last tile first
  const int row_end = min(nrows, row0 + kRows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

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

  // This thread's two query rows: gid and gid + 8 of the warp's 16.
  const int ra = row0 + warp * 16 + gid, rb = ra + 8;
  const int ta = ra / g, tb = rb / g;
  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;
  uint32_t qf[kQInRegs<HD> ? KS : 1][4];
  // ldmatrix row addresses: A (16 rows x 16) and B (16 keys x 16)
  const bf16* qrow = qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  const int krow = (lane & 7) + ((lane >> 4) << 3), kcol = ((lane >> 3) & 1) * 8;
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3), vcol = (lane >> 4) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int p0 = lo + it * BN;
    if (it + 1 < ntiles) {
      load_kv((it + 1) & 1, p0 + BN);
      attn::cp_async_wait<1>();  // Q and tile it have landed
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQInRegs<HD>) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], qrow + kk * 16);
      }
    }
    const bf16* kt = ks + (it & 1) * BN * LD;
    const bf16* vt = vs + (it & 1) * BN * LD;

    // S = Q K^T, f32 (16 rows x BN keys per warp)
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs<HD>) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, qrow + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kt + (np * 16 + krow) * LD + kk * 16 + kcol);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Scale into the log2 domain; mask only a tile some row cannot see
    // whole.
    const bool whole = p0 + BN - 1 <= s_len - 1 &&
                       (!causal || p0 + BN - 1 <= t_first) &&
                       (window <= 0 || p0 > t_last - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!whole) {
          const int p = p0 + j * 8 + tig * 2 + (e & 1);
          const int t = e < 2 ? ta : tb;
          const bool vis = p < s_len && (!causal || p <= t) &&
                           (window <= 0 || p > t - window);
          if (!vis) x = -INFINITY;
        }
        s[j][e] = x;
      }
    }

    // Online softmax: the new running max of each row over the quad.
    float xa = ma, xb = mb;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      xa = fmaxf(xa, fmaxf(s[j][0], s[j][1]));
      xb = fmaxf(xb, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      xa = fmaxf(xa, __shfl_xor_sync(attn::kFull, xa, off));
      xb = fmaxf(xb, __shfl_xor_sync(attn::kFull, xb, off));
    }
    const float alpha_a = ma == -INFINITY ? 0.f : exp2f(ma - xa);
    const float alpha_b = mb == -INFINITY ? 0.f : exp2f(mb - xb);
    // a row with no visible key so far keeps -inf; its p are all 0
    const float base_a = xa == -INFINITY ? 0.f : xa;
    const float base_b = xb == -INFINITY ? 0.f : xb;
    ma = xa;
    mb = xb;
    la *= alpha_a;
    lb *= alpha_b;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= alpha_a;
      o[d][1] *= alpha_a;
      o[d][2] *= alpha_b;
      o[d][3] *= alpha_b;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - base_a);
      s[j][1] = exp2f(s[j][1] - base_a);
      s[j][2] = exp2f(s[j][2] - base_b);
      s[j][3] = exp2f(s[j][3] - base_b);
      la += s[j][0] + s[j][1];  // this thread's columns; quad-summed last
      lb += s[j][2] + s[j][3];
    }

    // O += P V: P's accumulators are the A fragments of the next mma.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + vrow) * LD + dp * 16 + vcol);
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }
  attn::cp_async_wait<0>();  // no copy outlives the block (ntiles == 0)

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    la += __shfl_xor_sync(attn::kFull, la, off);
    lb += __shfl_xor_sync(attn::kFull, lb, off);
  }
  const float inv_a = 1.f / fmaxf(la, 1e-30f);
  const float inv_b = 1.f / fmaxf(lb, 1e-30f);
  if (ra < nrows) {
    bf16* dst = out + b * so.b + (h * g + ra % g) * so.h + ta * so.t + tig * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          pack_bf16(o[d][0] * inv_a, o[d][1] * inv_a);
  }
  if (rb < nrows) {
    bf16* dst = out + b * so.b + (h * g + rb % g) * so.h + tb * so.t + tig * 2;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(dst + d * 8) =
          pack_bf16(o[d][2] * inv_b, o[d][3] * inv_b);
  }
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
      case 256: REPRO_FA_MMA(256);
    }
  } else if (dtype == 0) {
    switch (hd) {
      case 16: REPRO_FA_F32(16);
      case 32: REPRO_FA_F32(32);
      case 64: REPRO_FA_F32(64);
      case 128: REPRO_FA_F32(128);
      case 256: REPRO_FA_F32(256);
    }
  }
#undef REPRO_FA_MMA
#undef REPRO_FA_F32
  return (int)cudaErrorInvalidValue;
}
