// Shared inner loops of the attention kernels (paged_attention.cu,
// flash_attention.cu).  The CUDA-core fold (f32): one warp per query row
// carries the online softmax (m, l, acc) in f32 registers over K/V tiles
// staged in shared memory.
//
// The warp's query row sits in shared memory as f32 (stage_query).  Over
// each 32-key slice of a staged tile, lane jj computes the whole score
// of key jj (key_score): a dot product over the head dim in f32, the
// key's row read 16 bytes at a time and the query broadcast.  Staged
// rows are padded by 16 bytes (row stride LD = HD + 16 / sizeof(T)
// elements), so the 8 lanes of each quarter-warp read 8 different bank
// groups.  A key the caller's `visible` rejects scores -inf, and a slice
// with no visible key leaves the carry alone (the test is warp-uniform).
// For P.V, lane l
// holds head-dim elements [l * EPL, (l + 1) * EPL) of acc (below HD = 32
// only the first HD lanes hold any) and takes each key's weight by a
// shuffle.  A query with no visible key at all writes 0: l is clamped at
// 1e-30, as the TPU kernels do.
//
// The score function is a compile-time mode (the attn_approx catalog of
// core/attn_approx.py): the exact online softmax, or one of the four
// exp-free datapaths of paged attention.  With d = s - m_new <= 0 and
// m_new the running max after the slice (for base2 and pwl, paged
// attention seeds the carry with the row's max, so m_new is that max and
// the carry is never rescaled), a visible key weighs
//   kExact    expf(d)                              carry expf(m - m_new)
//   kPseudo   exp2f(d)                             carry exp2f(m - m_new)
//   kBase2    2^n * LUT[clamp(rint(v * 256))]      carry expf(m - m_new)
//   kPwl      2^n * chord of ROM over 16 segments  carry expf(m - m_new)
// (y = d * log2 e = n + v, n = floor(y)); masked keys weigh 0, never
// f(-inf).  kMaxOnly is a comparator carry: a slice whose best visible
// score beats the carry's strictly resets acc to the V row of its first
// such key and l to 1, so ties keep the earlier, lower position.  The
// LUT (256 entries) and the ROM (17) are f32 tables in shared memory,
// built by the caller from core.softmax_variants.base2_frac_lut and
// core.attn_approx.pwl_lut.
//
// The header also holds the 16-byte cp.async helpers with which the
// kernels stage their K/V tiles, double-buffered, and the tensor-core
// tile of the bf16 routes (mma_fold_tile, below): flash attention's fold
// and paged attention's in all five modes.  Each fold's scores come from
// one routine (key_score, mma_scores), which paged attention's row-max
// pre-pass calls too, so the pre-pass sees the fold's scores bit for
// bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr unsigned kFull = 0xffffffffu;

// Score modes, as the C entry of paged_attention.cu numbers them.
constexpr int kExact = 0, kBase2 = 1, kPseudo = 2, kPwl = 3, kMaxOnly = 4;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBase2Lut = 256;     // 2^8 entries: BASE2_PRECISION_BITS
constexpr int kPwlSegments = 16;   // PWL_SEGMENTS; the ROM has 17 entries

// f32 entries of the mode's table (0: none).
template <int MODE>
constexpr int kRomSize =
    MODE == kBase2 ? kBase2Lut : (MODE == kPwl ? kPwlSegments + 1 : 0);

// The mode's weight of d = s - m_new (finite, <= 0), rounding where the
// plain version rounds: the products are explicit so that nvcc fuses
// none of them into an FMA.
template <int MODE>
__device__ __forceinline__ float weight_exp(float d, const float* rom) {
  if constexpr (MODE == kExact) {
    return expf(d);
  } else if constexpr (MODE == kPseudo) {
    return exp2f(d);
  } else {
    const float y = __fmul_rn(d, kLog2e);
    const float n = floorf(y);
    const float v = y - n;  // in [0, 1)
    if constexpr (MODE == kBase2) {
      // round half to even, as jnp.round and torch.round do
      const int i = min(max((int)rintf(v * kBase2Lut), 0), kBase2Lut - 1);
      return __fmul_rn(exp2f(n), rom[i]);
    } else {
      const float pos = v * kPwlSegments;
      const int i = min(max((int)floorf(pos), 0), kPwlSegments - 1);
      const float t = pos - (float)i;
      const float lo = rom[i], hi = rom[i + 1];
      return __fmul_rn(exp2f(n), __fadd_rn(lo, __fmul_rn(hi - lo, t)));
    }
  }
}

// d = s - m, the argument of weight_exp.  The table modes round it on
// its own (no FMA with the product that scaled s), so that a score equal
// to m gives d = 0 exactly and d is the plain version's f32 difference.
template <int MODE>
__device__ __forceinline__ float score_gap(float s, float m) {
  if constexpr (kRomSize<MODE> > 0) return __fsub_rn(s, m);
  return s - m;
}

// The carry's rescale for a running-max bump dm = m - m_new <= 0.
template <int MODE>
__device__ __forceinline__ float carry_scale(float dm) {
  if constexpr (MODE == kPseudo) return exp2f(dm);
  return expf(dm);
}

// Head-dim elements per lane.
template <int HD>
constexpr int kEpl = HD >= 32 ? HD / 32 : 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// The largest power of two that divides `bytes`, at most 16: N elements
// at lane * N (N = 6 at head dim 192) stay aligned to it.
constexpr int vec_align(int bytes) {
  return (bytes & -bytes) > 16 ? 16 : (bytes & -bytes);
}

template <typename T, int N>
struct alignas(vec_align(sizeof(T) * N)) Vec {
  T v[N];
};

// N consecutive elements -> f32 registers, one vector load.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_float(x.v[i]);
}

// 16-byte asynchronous copy global -> shared (cp.async.cg, through L2
// only); with pred false it reads nothing and zero-fills the 16 bytes.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Elements of a staged K/V row, padded by 16 bytes (see the header).
template <typename T, int HD>
constexpr int kLd = HD + 16 / (int)sizeof(T);

// The warp's query row -> qs (HD f32 in shared memory, 16-byte aligned);
// every lane of the warp calls it.
template <typename T, int HD>
__device__ __forceinline__ void stage_query(const T* row, int lane,
                                            float* qs) {
  for (int d = lane; d < HD; d += 32) qs[d] = to_float(row[d]);
  __syncwarp();
}

// The score of key p, staged as row kr, for the query row qs
// (stage_query): (q . k) * scale in f32, q . k an fmaf chain over the
// head dim in order; -inf where the key is not visible.
template <typename T, int HD>
__device__ __forceinline__ float key_score(const T* kr, const float* qs,
                                           float scale, bool visible) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte read
  float dot = 0.f;
#pragma unroll
  for (int d = 0; d < HD; d += VEC) {
    float kf[VEC], qf[VEC];
    load_floats<T, VEC>(kr + d, kf);
    load_floats<float, VEC>(qs + d, qf);
#pragma unroll
    for (int e = 0; e < VEC; ++e) dot = fmaf(qf[e], kf[e], dot);
  }
  return visible ? dot * scale : -INFINITY;
}

// Fold keys p0 .. p0 + STAGE - 1, staged as the (STAGE, LD) tiles ks and
// vs (LD = kLd<T, HD>), into the carry (m, l, acc) of the query row qs
// (stage_query) under score mode MODE; visible(p) says whether key p
// counts, rom is the mode's table in shared memory (kRomSize<MODE>
// entries).  Every lane of the warp calls it.
template <typename T, int HD, int STAGE, int MODE = kExact,
          typename Visible>
__device__ __forceinline__ void fold_stage(const T* ks, const T* vs, int p0,
                                           int lane, const float* qs,
                                           float (&acc)[kEpl<HD>], float& m,
                                           float& l, float scale,
                                           Visible visible,
                                           const float* rom = nullptr) {
  constexpr int EPL = kEpl<HD>;
  constexpr int LD = kLd<T, HD>;
  const bool lane_on = lane < HD / EPL;
  for (int j0 = 0; j0 < STAGE; j0 += 32) {
    // lane jj scores key p0 + j0 + jj
    const float s_mine = key_score<T, HD>(ks + (j0 + lane) * LD, qs, scale,
                                          visible(p0 + j0 + lane));
    const float smax = warp_max(s_mine);
    if (smax == -INFINITY) continue;  // warp-uniform: no visible key here
    if constexpr (MODE == kMaxOnly) {
      if (smax > m) {  // warp-uniform; a tie keeps the earlier winner
        // the first visible key at smax (invisible lanes hold -inf)
        const int jw = __ffs(__ballot_sync(kFull, s_mine == smax)) - 1;
        float vr[EPL] = {};
        if (lane_on) load_floats<T, EPL>(vs + (j0 + jw) * LD + lane * EPL, vr);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[e] = vr[e];
        l = 1.f;
        m = smax;
      }
      continue;
    }
    const float m_new = fmaxf(m, smax);
    const float alpha = (m == -INFINITY) ? 0.f : carry_scale<MODE>(m - m_new);
    const float p_mine =
        (s_mine == -INFINITY) ? 0.f : weight_exp<MODE>(score_gap<MODE>(
                                          s_mine, m_new), rom);
    l = l * alpha + warp_sum(p_mine);
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      const float pj = __shfl_sync(kFull, p_mine, jj);
      float vr[EPL] = {};
      if (lane_on) load_floats<T, EPL>(vs + (j0 + jj) * LD + lane * EPL, vr);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pj, vr[e], acc[e]);
    }
    m = m_new;
  }
}

// out_row[lane's slice] = acc / l in T.
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* out_row, int lane,
                                          const float (&acc)[kEpl<HD>],
                                          float l) {
  constexpr int EPL = kEpl<HD>;
  if (lane >= HD / EPL) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    store_from_float(out_row + lane * EPL + e, acc[e] * inv);
}

// ---------------------------------------------------------------------------
// The tensor-core tile (bf16 operands, f32 sums): a warp's 16 query rows
// ---------------------------------------------------------------------------
// Shared by flash_attention_mma_kernel and paged_attention_mma_kernel.  A
// warp owns 16 query rows of the block's staged Q tile; S = Q K^T and O +=
// P V run as mma.sync.m16n8k16 bf16 x bf16 -> f32 (bf16 products are exact
// in f32), over K and V tiles of BN keys staged in shared memory with rows
// padded to kMmaLd elements (16 bytes over HD, so the 8 row addresses of
// an ldmatrix land in 8 different bank groups).  Thread lane holds rows
// gid = lane / 4 and gid + 8, columns 2 * (lane % 4) + {0, 1} of every
// 8-wide tile; a row's max and sum are reduced over its quad of threads.
// P goes from the S accumulators to bf16 A fragments in registers, and
// V's B fragments come from ldmatrix.trans.  Every sum a row's output
// takes depends on that row's own scores and on the key tiles' positions
// only, never on the other rows of the tile.
using bf16 = __nv_bfloat16;

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

template <int HD>
constexpr int kMmaLd = HD + 8;  // padded shared row, elements
// Q's A fragments stay in registers up to HD 128; above, they would take
// HD / 4 registers beside O's HD / 2, so Q is re-read from shared memory
// by ldmatrix per key tile.
template <int HD>
constexpr bool kQInRegs = HD <= 128;

// A warp's 16 rows of Q: the A fragments (kQInRegs) or the ldmatrix row
// address in the staged Q tile.
template <int HD>
struct MmaQuery {
  uint32_t f[kQInRegs<HD> ? HD / 16 : 1][4];
  const bf16* row;
};

// `qs` is the block's staged Q tile, warp `warp`'s rows at 16 * warp.
template <int HD>
__device__ __forceinline__ void mma_query_init(MmaQuery<HD>& q,
                                               const bf16* qs, int warp,
                                               int lane) {
  q.row = qs + (warp * 16 + (lane & 15)) * kMmaLd<HD> + (lane >> 4) * 8;
}

// After the staged Q tile has landed: its fragments into registers.
template <int HD>
__device__ __forceinline__ void mma_query_load(MmaQuery<HD>& q) {
  if constexpr (kQInRegs<HD>) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(q.f[kk], q.row + kk * 16);
  }
}

// The online-softmax carry of the thread's two rows (index 0: gid, 1:
// gid + 8): o[d][2 * r + c] is row r's column d * 8 + 2 * (lane % 4) + c;
// l is the thread's share of the row's sum until mma_finish.
template <int HD>
struct MmaCarry {
  float o[HD / 8][4];
  float m[2], l[2];
};

template <int HD>
__device__ __forceinline__ void mma_carry_init(MmaCarry<HD>& c) {
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    c.o[d][0] = c.o[d][1] = c.o[d][2] = c.o[d][3] = 0.f;
  c.m[0] = c.m[1] = -INFINITY;
  c.l[0] = c.l[1] = 0.f;
}

// S = Q K^T of the warp's 16 rows over keys p0 .. p0 + BN - 1, staged as
// the (BN, kMmaLd) tile kt: s[j][e] is row (e >> 1 ? gid + 8 : gid), key
// p0 + 8 j + 2 (lane % 4) + (e & 1), scored (q . k) * scale in f32.  Key
// p counts for the thread's row r (0 or 1) when lo[r] < p <= hi[r], else
// it scores -inf; `whole` says that every key of the tile counts for
// every row of the block (the mask is skipped).  Every lane of the warp
// calls it.
template <int HD, int BN>
__device__ __forceinline__ void mma_scores(float (&s)[BN / 8][4],
                                           const MmaQuery<HD>& q,
                                           const bf16* kt, int p0, int lane,
                                           float scale, bool whole,
                                           const int (&lo)[2],
                                           const int (&hi)[2]) {
  constexpr int LD = kMmaLd<HD>;
  constexpr int KS = HD / 16;  // k-steps of Q K^T
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  const int tig = lane & 3;
  // ldmatrix row addresses: K (16 keys x 16)
  const int krow = (lane & 7) + ((lane >> 4) << 3);
  const int kcol = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t a[4];
    if constexpr (kQInRegs<HD>) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = q.f[kk][e];
    } else {
      ldmatrix_x4(a, q.row + kk * 16);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bk[4];
      ldmatrix_x4(bk, kt + (np * 16 + krow) * LD + kk * 16 + kcol);
      mma_bf16(s[2 * np], a, bk[0], bk[1]);
      mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
    }
  }

  // Scale; mask unless every key counts for every row.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + j * 8 + tig * 2 + (e & 1);
      const float x = s[j][e] * scale;
      s[j][e] = whole || (p > lo[e >> 1] && p <= hi[e >> 1]) ? x : -INFINITY;
    }
  }
}

// Fold keys p0 .. p0 + BN - 1, staged as the (BN, kMmaLd) tiles kt and vt,
// into the carry under score mode MODE, the scores and mask of
// mma_scores.  kExact, kPseudo, kBase2 and kPwl weigh a visible key by
// weight_exp<MODE>(s - m_new) and rescale the carry by carry_scale<MODE>
// (flash attention passes scale * log2 e with kPseudo: its softmax in the
// log2 domain); a masked key weighs 0, never f(-inf) (the tables' weight
// of -inf is NaN); rom is the mode's table in shared memory.  kMaxOnly
// keeps the comparator carry: a tile whose best visible score beats the
// row's max strictly resets o to that key's V row and l to 1, the lowest
// position winning a tie inside the tile.  P enters the PV product in
// bf16 (as SDPA does; flash attention), or with SPLIT_P as bf16(P) plus
// the bf16 remainder, two products (paged attention, whose bf16 checks
// hold the output to one bf16 step of an f32 P).  Every lane of the warp
// calls it.
template <int HD, int BN, int MODE, bool SPLIT_P>
__device__ __forceinline__ void mma_fold_tile(MmaCarry<HD>& c,
                                              const MmaQuery<HD>& q,
                                              const bf16* kt, const bf16* vt,
                                              int p0, int lane, float scale,
                                              bool whole, const int (&lo)[2],
                                              const int (&hi)[2],
                                              const float* rom = nullptr) {
  constexpr int LD = kMmaLd<HD>;
  constexpr int NT = BN / 8;   // 8-key column tiles of S
  constexpr int DT = HD / 8;   // 8-wide column tiles of O
  const int tig = lane & 3;
  // ldmatrix row addresses: V^T (16 keys x 16)
  const int vrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int vcol = (lane >> 4) * 8;

  float s[NT][4];
  mma_scores<HD, BN>(s, q, kt, p0, lane, scale, whole, lo, hi);

  if constexpr (MODE == kMaxOnly) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the thread's best column in position order (a tie keeps the
      // earlier), then the quad's by (value desc, position asc)
      float bv = -INFINITY;
      int bp = p0 + BN;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (s[j][2 * r + e] > bv) {
            bv = s[j][2 * r + e];
            bp = p0 + j * 8 + tig * 2 + e;
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int op = __shfl_xor_sync(kFull, bp, off);
        if (ov > bv || (ov == bv && op < bp)) {
          bv = ov;
          bp = op;
        }
      }
      if (bv > c.m[r]) {  // quad-uniform; -inf never beats the carry
        const bf16* vr = vt + (bp - p0) * LD + tig * 2;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          c.o[d][2 * r] = __bfloat162float(vr[d * 8]);
          c.o[d][2 * r + 1] = __bfloat162float(vr[d * 8 + 1]);
        }
        c.l[r] = 1.f;
        c.m[r] = bv;
      }
    }
    return;
  } else {
    // Online softmax: each row's new running max over the quad.
    float x0 = c.m[0], x1 = c.m[1];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      x0 = fmaxf(x0, fmaxf(s[j][0], s[j][1]));
      x1 = fmaxf(x1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      x0 = fmaxf(x0, __shfl_xor_sync(kFull, x0, off));
      x1 = fmaxf(x1, __shfl_xor_sync(kFull, x1, off));
    }
    const float alpha0 =
        c.m[0] == -INFINITY ? 0.f : carry_scale<MODE>(c.m[0] - x0);
    const float alpha1 =
        c.m[1] == -INFINITY ? 0.f : carry_scale<MODE>(c.m[1] - x1);
    // a row with no visible key so far keeps -inf; its weights are all 0
    const float base0 = x0 == -INFINITY ? 0.f : x0;
    const float base1 = x1 == -INFINITY ? 0.f : x1;
    c.m[0] = x0;
    c.m[1] = x1;
    c.l[0] *= alpha0;
    c.l[1] *= alpha1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      c.o[d][0] *= alpha0;
      c.o[d][1] *= alpha0;
      c.o[d][2] *= alpha1;
      c.o[d][3] *= alpha1;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (kRomSize<MODE> > 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = s[j][e] == -INFINITY
                        ? 0.f
                        : weight_exp<MODE>(score_gap<MODE>(
                                               s[j][e], e < 2 ? base0 : base1),
                                           rom);
      } else {
        s[j][0] = weight_exp<MODE>(s[j][0] - base0, nullptr);
        s[j][1] = weight_exp<MODE>(s[j][1] - base0, nullptr);
        s[j][2] = weight_exp<MODE>(s[j][2] - base1, nullptr);
        s[j][3] = weight_exp<MODE>(s[j][3] - base1, nullptr);
      }
      c.l[0] += s[j][0] + s[j][1];  // this thread's columns
      c.l[1] += s[j][2] + s[j][3];
    }

    // O += P V: P's accumulators are the A fragments of the next mma,
    // in bf16; with SPLIT_P also the bf16 remainder P - bf16(P), a second
    // product, so P carries ~16 bits and O matches an f32 P to ~2^-17.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const float w[8] = {s[2 * kk][0],     s[2 * kk][1],
                          s[2 * kk][2],     s[2 * kk][3],
                          s[2 * kk + 1][0], s[2 * kk + 1][1],
                          s[2 * kk + 1][2], s[2 * kk + 1][3]};
      uint32_t a[4], r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[e] = pack_bf16(w[2 * e], w[2 * e + 1]);
        if constexpr (SPLIT_P)
          r[e] = pack_bf16(w[2 * e] - __uint_as_float(a[e] << 16),
                           w[2 * e + 1] - __uint_as_float(a[e] & 0xffff0000u));
      }
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + vrow) * LD + dp * 16 + vcol);
        mma_bf16(c.o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(c.o[2 * dp + 1], a, bv[2], bv[3]);
        if constexpr (SPLIT_P) {
          mma_bf16(c.o[2 * dp], r, bv[0], bv[1]);
          mma_bf16(c.o[2 * dp + 1], r, bv[2], bv[3]);
        }
      }
    }
  }
}

// After the last tile: each row's sum over its quad (kMaxOnly's l is
// already the row's: 0 or 1 in every thread of the quad).
template <int HD, int MODE>
__device__ __forceinline__ void mma_finish(MmaCarry<HD>& c) {
  if constexpr (MODE != kMaxOnly) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      c.l[0] += __shfl_xor_sync(kFull, c.l[0], off);
      c.l[1] += __shfl_xor_sync(kFull, c.l[1], off);
    }
  }
}

// Row r's columns of the carry as o / l in bf16 into out_row (the row's
// HD outputs), the same floats store_row writes.
template <int HD>
__device__ __forceinline__ void mma_store_row(bf16* out_row,
                                              const MmaCarry<HD>& c, int r,
                                              int lane) {
  const float inv = 1.f / fmaxf(c.l[r], 1e-30f);
  bf16* dst = out_row + (lane & 3) * 2;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d)
    *reinterpret_cast<uint32_t*>(dst + d * 8) =
        pack_bf16(c.o[d][2 * r] * inv, c.o[d][2 * r + 1] * inv);
}

}  // namespace attn
