// The full softmax unit for Hopper (sm_90a): the paper's baseline, in
// the two phases of the TPU kernels, plus the cross-entropy head that
// shares phase 1's kernel template.
//
// Replaces the TPU kernels
//   src/repro/kernels/online_softmax.py  softmax_stats (:69, pallas_call
//     :82, body _stats_kernel :26) -- per-row (m, l) = (max, sum exp(x -
//     max)) by one online pass;
//   src/repro/kernels/online_softmax.py  online_softmax (:106,
//     pallas_call :121, body _normalize_kernel :53) -- exp(x - m) / l;
//   src/repro/kernels/fused_xent.py      fused_xent (:59, pallas_call
//     :75, body _xent_kernel :24) -- m + log l - x[label] per row.
//
// Bound on the H100: memory.  softmax_stats reads x once; online_softmax
// reads x and writes the (B, V) f32 probabilities once; both do a few
// flops and one exp per element, far below the card's flops per byte.
// At the decode batch sizes the unit meets (B 12, V 151936: 7 MB of f32)
// the bound is a few microseconds, so launches and the gaps between them
// are what cost, and the design spends as few as it can:
//
//   * A row splits into chunks of kChunk = 4,096 elements at absolute
//     multiples of the chunk (16-byte boundaries), one block per (chunk,
//     row): the split follows V alone, never B, so a row's bits do not
//     depend on its batch-mates.  Each thread loads its 16 elements with
//     all its 16-byte loads issued together (four in f32, two in bf16 /
//     f16; scalar loads of the same elements where a row start is not
//     16-byte aligned), then folds the chunk in two steps on those
//     registers: the max, then sum exp(x - max) -- one expf per element,
//     no per-element branch or rescale -- in one fixed order
//     (`fold_chunk`).  A row's chunk partials merge in one fixed order
//     with one routine (`merge_partials`): their max, then sum l_i
//     exp(m_i - max), one expf per partial (a chain of pairwise merges,
//     two expf each, cost ~1 us more; scripts/unit_stream_probe.cu).
//   * softmax_stats is one launch at any B (`unit_stats_kernel`): each
//     block writes its partial, then takes a per-row arrival ticket (one
//     atom.add.acq_rel.gpu: it releases the partial and acquires the
//     others'); the block that arrives last merges
//     the row's partials, writes m and l and puts the ticket back to 0,
//     so the ticket buffer is all zeros between launches and needs no
//     clearing launch.  The launches of one stream run in order; the
//     wrappers keep one ticket buffer per (device, stream), so launches
//     on two streams never share a ticket.
//   * online_softmax, where B * nsplit blocks fit on the card at once, is
//     one cooperative launch that reads x once (`unit_one_pass_kernel`):
//     each block folds its chunk as above, writes its partial, waits at a
//     grid-wide barrier, merges its row's partials and writes exp(x - m)
//     / l from the registers it already holds.  Elsewhere (many rows) it
//     runs softmax_stats' launch, then `normalize_kernel`, which reads x
//     a second time.  Both routes give the same bits: the same fold, the
//     same merge, the same expression for the probabilities.
//   * The cross-entropy is softmax_stats' launch with another head
//     (`stats_block`, the same fold, split and merge; `unit_xent_kernel`):
//     every block reads its row's label once, the thread that folded
//     x[label] writes it from its register (no dependent load in the
//     tail) and the block's ticket publishes it with the partial, and
//     the row's last block writes (m + log l) - x[label].  So a row's
//     loss, like its stats, is the same bits alone or in any batch.  At a
//     training
//     batch's rows (4,096 x 151,936 bf16) this per-chunk grid streams
//     faster than a persistent walk over the chunks with the next chunk's
//     loads in registers or in a cp.async.bulk ring
//     (scripts/unit_stream_probe.cu): the blocks of the stats kernels
//     sit on grid.y and grid.z, one chunk each, with no row loop.
//   * Rows past grid.y's 65,535 go to grid.z in the stats kernels and
//     stride over grid.y in phase 2, so any row count takes one launch,
//     as the TPU kernels' row tiling does.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;                 // elements a thread folds
constexpr int kChunk = kThreads * kPerThread;  // elements a block folds
constexpr int kMinBlocksPerSM = 4;  // the one-pass kernel's stated occupancy
// The stats kernels' occupancy: 8 blocks of 256 threads fill an SM, in 32
// registers a thread.  At 4,096 x 151,936 bf16 the stats launch streams
// x in 0.51 ms this way, 0.59 at the 5 blocks its 47 registers gave
// (scripts/unit_stream_probe.cu, "(a) at8" / "at4").
constexpr int kStatsBlocksPerSM = 8;
constexpr int kMaxGridY = 65535;    // grid.y's limit (and grid.z's)

int grid_rows(int B) { return B < kMaxGridY ? B : kMaxGridY; }

// The stats kernels' grid: (nsplit, B) with rows past grid.y's limit on
// grid.z, row = z * gridDim.y + y.
dim3 chunk_grid(int nsplit, int B) {
  return dim3(nsplit, grid_rows(B), (B + kMaxGridY - 1) / kMaxGridY);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One warp merges a row's nsplit partials (pm, pl): m = their max, then
// l = sum l_i exp(m_i - m) (from 0 where m is -inf), lane j summing
// partials j, j + 32, ... in that order, the lanes meeting in the xor
// tree; every lane returns the same pair.  A lane holds its first kHeld
// partials in registers, so up to 64 (V up to 262,144) take one trip to
// L2.  The partials may come from other blocks of the same launch, so
// they are read from L2 (__ldcg), past this SM's L1.  The products are
// rounded before the sum (__fmul_rn: no FMA), as the plain model does.
__device__ __forceinline__ void merge_partials(const float* pm,
                                               const float* pl, int nsplit,
                                               int lane, float& m, float& l) {
  constexpr int kHeld = 2;
  float hm[kHeld], hl[kHeld];
  m = -INFINITY;
#pragma unroll
  for (int i = 0; i < kHeld; ++i) {
    const int s = lane + 32 * i;
    hm[i] = s < nsplit ? __ldcg(pm + s) : -INFINITY;
    hl[i] = s < nsplit ? __ldcg(pl + s) : 0.f;
    m = fmaxf(m, hm[i]);
  }
  for (int s = lane + 32 * kHeld; s < nsplit; s += 32)
    m = fmaxf(m, __ldcg(pm + s));
  m = warp_max(m);
  const float base = m == -INFINITY ? 0.f : m;
  l = 0.f;  // an empty partial is (-inf, 0): it adds 0 * 0
#pragma unroll
  for (int i = 0; i < kHeld; ++i) l += __fmul_rn(hl[i], expf(hm[i] - base));
  for (int s = lane + 32 * kHeld; s < nsplit; s += 32)
    l += __fmul_rn(__ldcg(pl + s), expf(__ldcg(pm + s) - base));
  l = warp_sum(l);
}

// A per-row arrival ticket: one atomic add that releases this thread's
// earlier writes and acquires those of the threads that added before.
__device__ __forceinline__ unsigned take_ticket(unsigned* t) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(t), "r"(1u)
               : "memory");
  return old;
}

// Thread t of a block holds elements (j * kThreads + t) * VEC + e of its
// chunk, j < kPerThread / VEC, e < VEC, VEC = 16 / sizeof(T), as v[j *
// VEC + e]; elements at or past `end` are -inf.  ALIGNED (every row
// start on 16 bytes): one 16-byte load per j, all issued before any is
// used; else scalar loads of the same elements, so the fold's order
// depends on the dtype alone.
template <typename T, bool ALIGNED>
__device__ __forceinline__ void load_chunk(const T* __restrict__ xr,
                                           int begin, int end,
                                           float (&v)[kPerThread]) {
  constexpr int VEC = 16 / (int)sizeof(T), NV = kPerThread / VEC;
  if constexpr (ALIGNED) {
    Vec<T, VEC> c[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int at = begin + (j * kThreads + threadIdx.x) * VEC;
      if (at < end) c[j] = *reinterpret_cast<const Vec<T, VEC>*>(xr + at);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const bool in = begin + (j * kThreads + threadIdx.x) * VEC < end;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[j * VEC + e] = in ? to_float(c[j].v[e]) : -INFINITY;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int at =
          begin + ((k / VEC) * kThreads + threadIdx.x) * VEC + k % VEC;
      v[k] = at < end ? to_float(xr[at]) : -INFINITY;
    }
  }
}

// The chunk's partial (m, l): its max, then sum exp(x - m) (from 0 where
// the chunk is all -inf, which gives (-inf, 0)).  Each thread runs over
// its v[0..15] in order, the lanes of a warp meet in the xor tree, and
// the 8 warps' values are taken in warp order.  Every thread returns the
// same pair.  sh: 2 * kWarps floats of shared memory; the caller syncs
// before it writes sh again.
__device__ __forceinline__ void fold_chunk(const float (&v)[kPerThread],
                                           float* sh, float& m, float& l) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float t = v[0];
#pragma unroll
  for (int k = 1; k < kPerThread; ++k) t = fmaxf(t, v[k]);
  t = warp_max(t);
  if (lane == 0) sh[warp] = t;
  __syncthreads();
  m = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sh[w]);
  const float base = m == -INFINITY ? 0.f : m;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) s += expf(v[k] - base);
  s = warp_sum(s);
  if (lane == 0) sh[kWarps + warp] = s;
  __syncthreads();
  l = sh[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += sh[kWarps + w];
}

// What the last block of a row writes: softmax_stats' (m, l), or the
// cross-entropy's (m + log l) - x[label].
enum class Head { kStats, kXent };

// A stats launch's rows and scratch: x (B, V) in nsplit chunks, the
// partials pm, pl (B, nsplit), the row tickets and softmax_stats' m, l
// (B,).  The kernels take it as one struct: passed as separate
// parameters, ptxas spilled 20 bytes of the cross-entropy kernel's
// aligned forms at 32 registers.
struct Rows {
  float *pm, *pl, *m, *l;
  unsigned* tickets;
  int B, V, nsplit;
};

// The cross-entropy's operands: labels (B,) and two (B,) f32 outputs --
// the label logits (scratch: the thread that holds a row's label logit
// writes it before its block's ticket, the row's last block reads it)
// and the loss.
struct XentOut {
  const long long* labels;
  float* xl;
  float* loss;
};

// The element of a chunk at offset p (0 <= p < kChunk) is held by thread
// (p / VEC) % kThreads in its slot (p / (kThreads * VEC)) * VEC + p %
// VEC (load_chunk's mapping); the slot is picked by compares, so v stays
// in registers.
template <typename T>
__device__ __forceinline__ bool holds(int p, float (&v)[kPerThread],
                                      float& got) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if ((p / VEC) % kThreads != (int)threadIdx.x) return false;
  const int slot = (p / (kThreads * VEC)) * VEC + p % VEC;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k)
    if (k == slot) got = v[k];
  return true;
}

// One block's work in softmax_stats and the cross-entropy: block (split,
// row) folds its chunk, writes its partial and takes the row's ticket;
// the last of the row's nsplit blocks merges the partials, writes the
// row's result and resets the ticket to 0.  Rows sit on grid.y and
// grid.z (row = z * gridDim.y + y), so any B takes one launch with no
// row loop.  For the cross-entropy, every block reads its row's label
// once; in the block whose chunk holds it, the thread that folded
// x[row, label] takes it from its register and writes it to xo.xl[row]
// before the ticket, whose release publishes it with the partial.
template <Head HEAD, typename T, bool ALIGNED>
__device__ __forceinline__ void stats_block(const T* __restrict__ x,
                                            const Rows& r, XentOut xo) {
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= r.B) return;
  const int begin = split * kChunk, end = min(r.V, begin + kChunk);
  float v[kPerThread];
  load_chunk<T, ALIGNED>(x + (size_t)row * r.V, begin, end, v);
  // The thread that holds x[row, label] writes it to the row's slot
  // itself: fold_chunk's barriers order that write before thread 0's
  // ticket, whose release covers it with the partial.  A label outside
  // [0, V) gets NaN there from the row's first block.  So nothing of the
  // label outlives the load, and at the stats kernels' 32 registers only
  // the f32 aligned form spills (20 bytes).  Handing the logit to thread 0
  // through shared memory was slower at 4,096 bf16 rows
  // (scripts/unit_stream_probe.cu "xent-sm 8" against "xent at8").
  if constexpr (HEAD == Head::kXent) {
    const long long label = xo.labels[row];
    float got;
    if (label < 0 || label >= r.V) {
      if (split == 0) xo.xl[row] = NAN;
    } else if (label / kChunk == split &&
               holds<T>((int)(label % kChunk), v, got)) {
      xo.xl[row] = got;
    }
  }
  float m, l;
  fold_chunk(v, sh, m, l);
  const size_t p = (size_t)row * r.nsplit;
  if (threadIdx.x == 0) {
    r.pm[p + split] = m;
    r.pl[p + split] = l;
    last = take_ticket(r.tickets + row) == (unsigned)(r.nsplit - 1);
  }
  __syncthreads();  // thread 0's acquire covers its block's reads below
  if (last && threadIdx.x < 32) {
    merge_partials(r.pm + p, r.pl + p, r.nsplit, threadIdx.x, m, l);
    if (threadIdx.x == 0) {
      if constexpr (HEAD == Head::kXent) {
        xo.loss[row] = m + logf(l) - __ldcg(xo.xl + row);
      } else {
        r.m[row] = m;
        r.l[row] = l;
      }
      r.tickets[row] = 0;  // every block of the row has taken its ticket
    }
  }
}

// softmax_stats, one launch: (m, l) per row.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSM)
    unit_stats_kernel(const T* __restrict__ x, Rows r) {
  stats_block<Head::kStats, T, ALIGNED>(x, r, XentOut{});
}

// The cross-entropy, one launch: (m + log l) - x[row, labels[row]] per
// row, NaN where the label lies outside [0, V).
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, kStatsBlocksPerSM)
    unit_xent_kernel(const T* __restrict__ x, Rows r, XentOut xo) {
  stats_block<Head::kXent, T, ALIGNED>(x, r, xo);
}

// online_softmax in one cooperative launch, grid (nsplit, B), every
// block resident: fold the chunk, write the partial, grid barrier, merge
// the row's partials, write exp(x - m) / l from the registers.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    unit_one_pass_kernel(const T* __restrict__ x, float* __restrict__ pm,
                         float* __restrict__ pl, float* __restrict__ out,
                         int B, int V, int nsplit) {
  constexpr int VEC = 16 / (int)sizeof(T), NV = kPerThread / VEC;
  __shared__ float sh[2 * kWarps];
  __shared__ float row_ml[2];
  const int split = blockIdx.x, row = blockIdx.y;
  const int begin = split * kChunk, end = min(V, begin + kChunk);
  float v[kPerThread];
  load_chunk<T, ALIGNED>(x + (size_t)row * V, begin, end, v);
  float m, l;
  fold_chunk(v, sh, m, l);
  const size_t p = (size_t)row * nsplit;
  if (threadIdx.x == 0) {
    pm[p + split] = m;
    pl[p + split] = l;
  }
  cg::this_grid().sync();  // a fence and a barrier: every partial is out
  if (threadIdx.x < 32) {
    merge_partials(pm + p, pl + p, nsplit, threadIdx.x, m, l);
    if (threadIdx.x == 0) {
      row_ml[0] = m;
      row_ml[1] = l;
    }
  }
  __syncthreads();
  m = row_ml[0];
  l = row_ml[1];
  float* orow = out + (size_t)row * V;
  if constexpr (ALIGNED) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int at = begin + (j * kThreads + threadIdx.x) * VEC;
      if (at >= end) continue;
#pragma unroll
      for (int e = 0; e < VEC; e += 4) {  // 16-byte stores
        Vec<float, 4> q;
#pragma unroll
        for (int i = 0; i < 4; ++i) q.v[i] = expf(v[j * VEC + e + i] - m) / l;
        *reinterpret_cast<Vec<float, 4>*>(orow + at + e) = q;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int at =
          begin + ((k / VEC) * kThreads + threadIdx.x) * VEC + k % VEC;
      if (at < end) orow[at] = expf(v[k] - m) / l;
    }
  }
}

// Phase 2: out[row, j] = exp(x[row, j] - m[row]) / l[row], f32 -- the
// one-pass kernel's expression, so both routes give the same bits.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) normalize_kernel(
    const T* __restrict__ x, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ out, int B, int V) {
  constexpr int SV = VEC < 4 ? VEC : 4;  // f32 elements per store
  const int nvec = V / VEC;
  for (int row = blockIdx.y; row < B; row += gridDim.y) {
    const float m = m_in[row], l = l_in[row];
    const T* xr = x + (size_t)row * V;
    float* orow = out + (size_t)row * V;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < nvec;
         i += gridDim.x * kThreads) {
      const Vec<T, VEC> c =
          *reinterpret_cast<const Vec<T, VEC>*>(xr + i * VEC);
      Vec<float, VEC> o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.v[e] = expf(to_float(c.v[e]) - m) / l;
#pragma unroll
      for (int e = 0; e < VEC; e += SV)  // 16-byte stores
        *reinterpret_cast<Vec<float, SV>*>(orow + i * VEC + e) =
            *reinterpret_cast<const Vec<float, SV>*>(o.v + e);
    }
    for (int j = nvec * VEC + blockIdx.x * kThreads + threadIdx.x; j < V;
         j += gridDim.x * kThreads)
      orow[j] = expf(to_float(xr[j]) - m) / l;
  }
}

// True when every row start of x (B, V) lies on 16 bytes.
template <typename T>
bool aligned(const void* x, int V) {
  return V % (16 / (int)sizeof(T)) == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Vector width in elements of phase 2's loads: 16 bytes where every row
// start is aligned, else 1.
template <typename T>
int vec_of(const void* x, int V) {
  return aligned<T>(x, V) ? 16 / (int)sizeof(T) : 1;
}

// The scratch of softmax_stats and online_softmax, one f32 buffer:
// m (B) | l (B) | pm (B, nsplit) | pl (B, nsplit).
struct Scratch {
  float *m, *l, *pm, *pl;
  Scratch(void* buf, int B, int nsplit) {
    m = static_cast<float*>(buf);
    l = m + B;
    pm = l + B;
    pl = pm + (size_t)B * nsplit;
  }
};

template <typename T>
cudaError_t stats(const void* x, const Scratch& s, unsigned* tickets, int B,
                  int V, int nsplit, cudaStream_t st) {
  const dim3 grid = chunk_grid(nsplit, B);
  const T* xp = static_cast<const T*>(x);
  const Rows r{s.pm, s.pl, s.m, s.l, tickets, B, V, nsplit};
  if (aligned<T>(x, V))
    unit_stats_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, r);
  else
    unit_stats_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, r);
  return cudaGetLastError();
}

// The cross-entropy's scratch, one f32 buffer: loss (B) | pm (B, nsplit)
// | pl (B, nsplit) | the label logits (B).
template <typename T>
cudaError_t xent(const void* x, const long long* labels, void* buf,
                 unsigned* tickets, int B, int V, int nsplit,
                 cudaStream_t st) {
  float* loss = static_cast<float*>(buf);
  float* pm = loss + B;
  float* pl = pm + (size_t)B * nsplit;
  const Rows r{pm, pl, nullptr, nullptr, tickets, B, V, nsplit};
  const XentOut xo{labels, pl + (size_t)B * nsplit, loss};
  const dim3 grid = chunk_grid(nsplit, B);
  const T* xp = static_cast<const T*>(x);
  if (aligned<T>(x, V))
    unit_xent_kernel<T, true><<<grid, kThreads, 0, st>>>(xp, r, xo);
  else
    unit_xent_kernel<T, false><<<grid, kThreads, 0, st>>>(xp, r, xo);
  return cudaGetLastError();
}

template <typename T>
cudaError_t one_pass(const void* x, const Scratch& s, float* out, int B,
                     int V, int nsplit, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  float *pm = s.pm, *pl = s.pl;
  void* args[] = {&xp, &pm, &pl, &out, &B, &V, &nsplit};
  const void* kern =
      aligned<T>(x, V) ? reinterpret_cast<const void*>(
                             &unit_one_pass_kernel<T, true>)
                       : reinterpret_cast<const void*>(
                             &unit_one_pass_kernel<T, false>);
  const cudaError_t err = cudaLaunchCooperativeKernel(
      kern, dim3(nsplit, B), dim3(kThreads), args, 0, st);
  if (err != cudaSuccess) cudaGetLastError();  // leave no error behind
  return err;
}

template <typename T>
cudaError_t normalize(const void* x, const float* m, const float* l,
                      float* out, int B, int V, cudaStream_t s) {
  const int vec = vec_of<T>(x, V);
  const int per_block = kThreads * vec * 4;  // four loads per thread
  const dim3 grid((V + per_block - 1) / per_block, grid_rows(B));
  if (vec > 1)
    normalize_kernel<T, (int)(16 / sizeof(T))><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), m, l, out, B, V);
  else
    normalize_kernel<T, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), m, l, out, B, V);
  return cudaGetLastError();
}

template <typename T>
int blocks_per_sm() {
  int a = 0, b = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, unit_one_pass_kernel<T, true>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b, unit_one_pass_kernel<T, false>, kThreads, 0);
  return err != cudaSuccess ? -(int)err : (a < b ? a : b);
}

bool bad_rows(int B, int V) { return B <= 0 || V <= 0; }

// The chunk split of the unit's own kernels: nsplit must be ceil(V /
// kChunk), the plan's.
bool bad_split(int B, int V, int nsplit) {
  return B <= 0 || V <= 0 || nsplit != (V + kChunk - 1) / kChunk;
}

}  // namespace

// (threads per block, elements per thread, chunk, stated blocks per SM)
// as built; the wrappers' plan must agree.
extern "C" void repro_unit_geometry(int* out) {
  out[0] = kThreads;
  out[1] = kPerThread;
  out[2] = kChunk;
  out[3] = kMinBlocksPerSM;
}

// Blocks of the one-pass kernel one SM of the current device holds at
// once, the least over its aligned and scalar forms, for dtype 0 =
// float32, 1 = bfloat16, 2 = float16; a negative cudaError_t on failure.
extern "C" int repro_unit_blocks_per_sm(int dtype) {
  return dtype == 0   ? blocks_per_sm<float>()
         : dtype == 1 ? blocks_per_sm<__nv_bfloat16>()
         : dtype == 2 ? blocks_per_sm<__half>()
                      : -(int)cudaErrorInvalidValue;
}

// x (B, V) row-major of dtype 0 = float32, 1 = bfloat16, 2 = float16;
// buf: the f32 scratch m (B) | l (B) | pm (B, nsplit) | pl (B, nsplit),
// with m and l the result; tickets: B zeros (uint32), zeros again when
// the launch ends; nsplit = ceil(V / 4096).  One launch.  Returns a
// cudaError_t.
extern "C" int repro_softmax_stats(const void* x, void* buf, void* tickets,
                                   int B, int V, int nsplit, int dtype,
                                   void* stream) {
  if (bad_split(B, V, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc(buf, B, nsplit);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaError_t err = dtype == 0   ? stats<float>(x, sc, t, B, V, nsplit, s)
                    : dtype == 1 ? stats<__nv_bfloat16>(x, sc, t, B, V, nsplit, s)
                    : dtype == 2 ? stats<__half>(x, sc, t, B, V, nsplit, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// Softmax of x (B, V) as above into out (B, V) f32 by one cooperative
// launch; buf as for repro_softmax_stats (its pm and pl used).  The
// B * nsplit blocks must fit on the card at once, or the launch fails
// (cudaErrorCooperativeLaunchTooLarge).  Returns a cudaError_t.
extern "C" int repro_softmax_one_pass(const void* x, void* buf, void* out,
                                      int B, int V, int nsplit, int dtype,
                                      void* stream) {
  if (bad_split(B, V, nsplit) || B > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Scratch sc(buf, B, nsplit);
  float* o = static_cast<float*>(out);
  cudaError_t err = dtype == 0   ? one_pass<float>(x, sc, o, B, V, nsplit, s)
                    : dtype == 1 ? one_pass<__nv_bfloat16>(x, sc, o, B, V, nsplit, s)
                    : dtype == 2 ? one_pass<__half>(x, sc, o, B, V, nsplit, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// Phase 2 over x (B, V) as above with its row stats m, l (B,) f32;
// out (B, V) f32.  Returns a cudaError_t.
extern "C" int repro_softmax_normalize(const void* x, const void* m,
                                       const void* l, void* out, int B, int V,
                                       int dtype, void* stream) {
  if (bad_rows(B, V)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fm = static_cast<const float*>(m),
              *fl = static_cast<const float*>(l);
  float* fo = static_cast<float*>(out);
  cudaError_t err = dtype == 0   ? normalize<float>(x, fm, fl, fo, B, V, s)
                    : dtype == 1 ? normalize<__nv_bfloat16>(x, fm, fl, fo, B, V, s)
                    : dtype == 2 ? normalize<__half>(x, fm, fl, fo, B, V, s)
                                 : cudaErrorInvalidValue;
  return (int)err;
}

// Cross-entropy per row: loss (B,) f32 = (m + log l) - x[row, lab[row]],
// NaN where lab[row] lies outside [0, V); lab (B,) int64.  x, tickets and
// nsplit as for repro_softmax_stats; buf: the f32 scratch loss (B) | pm
// (B, nsplit) | pl (B, nsplit) | label logits (B), with loss the result.
// One launch.  Returns a cudaError_t.
extern "C" int repro_fused_xent(const void* x, const void* lab, void* buf,
                                void* tickets, int B, int V, int nsplit,
                                int dtype, void* stream) {
  if (bad_split(B, V, nsplit)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* lb = static_cast<const long long*>(lab);
  unsigned* t = static_cast<unsigned*>(tickets);
  cudaError_t err =
      dtype == 0   ? xent<float>(x, lb, buf, t, B, V, nsplit, s)
      : dtype == 1 ? xent<__nv_bfloat16>(x, lb, buf, t, B, V, nsplit, s)
      : dtype == 2 ? xent<__half>(x, lb, buf, t, B, V, nsplit, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}
