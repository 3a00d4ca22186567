// Where the softmax unit's time goes on the card, and which stats design
// streams a training batch's rows fastest.  Every time is on
// chip_smoke.py's device ruler (the card spins while the host enqueues,
// the L2 is flushed before each run; mean of 20).
//
// Part 1, the unit path's shape (12 rows of 151,936 f32, 7.29 MB, uniform
// in [-8, 8)): each variant below is one launch of the unit's chunk
// geometry (one block per (chunk, row), 256 threads, PT elements a
// thread, all its 16-byte loads issued together):
//
//   empty      a launch that does nothing (the ruler's floor);
//   read       the loads alone, nothing written but a never-taken store;
//   fold       read + the chunk's max, then sum exp(x - max), partial out
//              (csrc/online_softmax.cu fold_chunk);
//   stats      fold + the per-row ticket (__threadfence, then atomicAdd;
//              __threadfence again in the last block) and the last
//              block's merge (merge/warp_merge: 2 expf per step);
//   stats-ar   the same with one atom.add.acq_rel.gpu in place of the
//              two fences;
//   stats-ar2  stats-ar with a two-step merge (the partials' max, then
//              sum l_i exp(m_i - max): one expf per partial);
//   copy       read + exp(x - m) / l written back, no barrier;
//   grid       fold + grid barrier (cooperative_groups) + merge + write,
//              a cooperative launch;
//   grid2      grid with the two-step merge;
//   row        a barrier per row in place of the grid's: each of the
//              row's blocks adds to the row's counter by one
//              atom.add.acq_rel.gpu (split 0 adds 2^31 - (nsplit - 1),
//              the others 1, so the top bit flips at the last arrival
//              and the low bits come back to 0), then spins until the
//              bit flips; a cooperative launch;
//   row2       row with the two-step merge;
//   unit-stats, unit-one-pass   the repository's kernels themselves
//              (csrc/online_softmax.cu, included here), through their C
//              entries repro_softmax_stats and repro_softmax_one_pass.
//
// Part 2, many rows (512 and 4,096 rows of 151,936 bf16 -- 4,096 is one
// 4k-token training sequence of qwen3-0.6b -- and 12 and 64 rows of f32):
// three
// designs of the stats kernel, each built from the repository's own
// load_chunk / fold_chunk / take_ticket / merge_partials, so all three
// fold a chunk and merge a row in the same order and give the same bits:
//
//   (a) per-chunk   one block per (chunk, row), grid (nsplit, B) -- the
//                   small-B design of csrc/online_softmax.cu, with
//                   __launch_bounds__ asking 4 blocks per SM (its 47
//                   registers fit 5); "at N" the
//                   same with __launch_bounds__ asking N blocks per SM and
//                   rows on grid.y and grid.z (no row loop), "raw N" also
//                   keeping each thread's elements as loaded (two bf16 to a
//                   register) and widening each where the fold reads it;
//   (b) regs        a persistent grid (the occupancy's blocks per SM times
//                   the SMs) walking the B * nsplit (chunk, row) items in
//                   row-major order, block i taking items i, i + grid, ...;
//                   each thread issues the next item's 16-byte loads into
//                   registers before it folds the current one;
//   (c) bulk-S      the same walk, thread 0 streaming items into an
//                   S-stage shared-memory ring by cp.async.bulk (one 1-D
//                   bulk copy of the chunk's bytes per item, completion on
//                   an mbarrier per stage), S items ahead; aligned rows.
//
// "stats at8" and "xent at N" are the repository's own block body
// (csrc/online_softmax.cu stats_block, labels (row * 7919) % V) with its
// stats head and its cross-entropy head, under launch bounds asking N
// blocks per SM.  Two other cross-entropy heads at N blocks per SM:
// "xent-sm N" hands the label logit from the thread that holds it to
// thread 0 through shared memory, and thread 0 writes it out before its
// ticket; "xent-ld N" has thread 0 load the label logit beside the
// chunk's loads.  Both losses are compared bitwise with stats_block's.
//
// Each is timed at three depths: "read" (the loads alone), "fold" (read +
// the chunk fold and its partial written) and "full" (fold + ticket + the
// last block's merge: the stats kernel).  "unit-stats" and "unit-xent"
// are the repository's repro_softmax_stats and repro_fused_xent at the
// same shape, and each full
// variant's (m, l) is compared bitwise with (a)'s.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o unit_stream_probe scripts/unit_stream_probe.cu
//   ./unit_stream_probe        # one GPU; prints device ms per variant
#include "../src/repro_torch/kernels/csrc/online_softmax.cu"

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <utility>

namespace probe {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}
__global__ void empty() {}

template <int PT>
__device__ __forceinline__ void load(const float* __restrict__ xr, int begin,
                                     int end, float (&v)[PT]) {
  constexpr int NV = PT / 4;
  float4 c[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int at = begin + (j * kThreads + threadIdx.x) * 4;
    if (at < end) c[j] = *reinterpret_cast<const float4*>(xr + at);
  }
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool in = begin + (j * kThreads + threadIdx.x) * 4 < end;
    v[4 * j] = in ? c[j].x : -INFINITY;
    v[4 * j + 1] = in ? c[j].y : -INFINITY;
    v[4 * j + 2] = in ? c[j].z : -INFINITY;
    v[4 * j + 3] = in ? c[j].w : -INFINITY;
  }
}

__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  l = (m == -INFINITY ? 0.f : l * expf(m - mn)) +
      (m2 == -INFINITY ? 0.f : l2 * expf(m2 - mn));
  m = mn;
}

__device__ __forceinline__ void merge_partials(const float* pm, const float* pl,
                                               int n, int lane, float& m,
                                               float& l) {
  m = -INFINITY;
  l = 0.f;
  for (int s = lane; s < n; s += 32) merge(m, l, __ldcg(pm + s), __ldcg(pl + s));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, o);
    const float l2 = __shfl_xor_sync(kFull, l, o);
    merge(m, l, m2, l2);
  }
}

// The two-step merge of n <= 64 partials: every lane holds two.
__device__ __forceinline__ void merge_partials2(const float* pm,
                                                const float* pl, int n,
                                                int lane, float& m, float& l) {
  const bool a = lane < n, b = lane + 32 < n;
  const float m0 = a ? __ldcg(pm + lane) : -INFINITY;
  const float m1 = b ? __ldcg(pm + lane + 32) : -INFINITY;
  const float l0 = a ? __ldcg(pl + lane) : 0.f;
  const float l1 = b ? __ldcg(pl + lane + 32) : 0.f;
  m = fmaxf(m0, m1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const float base = m == -INFINITY ? 0.f : m;
  l = (m0 == -INFINITY ? 0.f : l0 * expf(m0 - base)) +
      (m1 == -INFINITY ? 0.f : l1 * expf(m1 - base));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
}

template <int PT>
__device__ __forceinline__ void fold(const float (&v)[PT], float* sh, float& m,
                                     float& l) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float t = v[0];
#pragma unroll
  for (int k = 1; k < PT; ++k) t = fmaxf(t, v[k]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(kFull, t, o));
  if (lane == 0) sh[warp] = t;
  __syncthreads();
  m = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sh[w]);
  const float base = m == -INFINITY ? 0.f : m;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < PT; ++k) s += expf(v[k] - base);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) sh[kWarps + warp] = s;
  __syncthreads();
  l = sh[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += sh[kWarps + w];
}

enum Mode {
  kRead, kFold, kStats, kStatsAR, kStatsAR2, kCopy, kGrid, kGrid2, kRow,
  kRow2, kModes
};
const char* kNames[] = {"read", "fold", "stats", "stats-ar", "stats-ar2",
                        "copy", "grid", "grid2", "row", "row2"};
__host__ __device__ constexpr bool two_step(int mode) {
  return mode == kStatsAR2 || mode == kGrid2 || mode == kRow2;
}
__host__ __device__ constexpr bool cooperative(int mode) {
  return mode >= kGrid;
}

__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], %2;"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ unsigned load_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

template <int PT, int MODE>
__global__ void __launch_bounds__(kThreads, 4)
    variant(const float* __restrict__ x, float* pm, float* pl,
            unsigned* tickets, float* mo, float* out, int V, int nsplit) {
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.y;
  const int begin = split * kThreads * PT, end = min(V, begin + kThreads * PT);
  float v[PT];
  load<PT>(x + (size_t)row * V, begin, end, v);
  if (MODE == kRead) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < PT; ++k) s += v[k];
    if (s == 1234.5f) out[0] = s;  // never taken: keeps the loads
    return;
  }
  float m, l;
  if (MODE == kCopy) {
    m = 0.f;
    l = 1.f;
  } else {
    fold<PT>(v, sh, m, l);
  }
  const size_t p = (size_t)row * nsplit;
  if (MODE != kCopy && threadIdx.x == 0) {
    pm[p + split] = m;
    pl[p + split] = l;
    unsigned* count = tickets + 2 * row;
    if (MODE == kStats) {
      __threadfence();
      last = atomicAdd(count, 1u) == (unsigned)(nsplit - 1);
    } else if (MODE == kStatsAR || MODE == kStatsAR2) {
      last = add_acq_rel(count, 1u) == (unsigned)(nsplit - 1);
    } else if (MODE == kRow || MODE == kRow2) {
      unsigned* bar = count + 1;
      const unsigned old =
          add_acq_rel(bar, split == 0 ? 0x80000000u - (nsplit - 1) : 1u);
      while (((old ^ load_relaxed(bar)) & 0x80000000u) == 0) {
      }
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
    }
  }
  if (MODE == kFold) return;
  if (MODE == kStats || MODE == kStatsAR || MODE == kStatsAR2) {
    __syncthreads();
    if (last && threadIdx.x < 32) {
      if (MODE == kStats) __threadfence();
      if (two_step(MODE))
        merge_partials2(pm + p, pl + p, nsplit, threadIdx.x, m, l);
      else
        merge_partials(pm + p, pl + p, nsplit, threadIdx.x, m, l);
      if (threadIdx.x == 0) {
        mo[row] = m;
        mo[gridDim.y + row] = l;
        tickets[2 * row] = 0;
      }
    }
    return;
  }
  if (cooperative(MODE)) {
    __shared__ float ml[2];
    if (MODE == kGrid || MODE == kGrid2) cg::this_grid().sync();
    else __syncthreads();
    if (threadIdx.x < 32) {
      if (two_step(MODE))
        merge_partials2(pm + p, pl + p, nsplit, threadIdx.x, m, l);
      else
        merge_partials(pm + p, pl + p, nsplit, threadIdx.x, m, l);
      if (threadIdx.x == 0) {
        ml[0] = m;
        ml[1] = l;
      }
    }
    __syncthreads();
    m = ml[0];
    l = ml[1];
  }
  float* orow = out + (size_t)row * V;
#pragma unroll
  for (int j = 0; j < PT / 4; ++j) {
    const int at = begin + (j * kThreads + threadIdx.x) * 4;
    if (at >= end) continue;
    float4 q;
    q.x = expf(v[4 * j] - m) / l;
    q.y = expf(v[4 * j + 1] - m) / l;
    q.z = expf(v[4 * j + 2] - m) / l;
    q.w = expf(v[4 * j + 3] - m) / l;
    *reinterpret_cast<float4*>(orow + at) = q;
  }
}

struct Bufs {
  float *x, *pm, *pl, *mo, *out;
  unsigned* tickets;
  void* flush;
  int B, V;
};

// Mean device ms of `launch` over 20 runs: the L2 flushed, the card
// spinning ~0.5 ms while the host records the start event and enqueues.
template <typename F>
float timed(const Bufs& b, F launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 3; ++i) launch();
  float total = 0.f;
  for (int i = 0; i < 20; ++i) {
    cudaMemsetAsync(b.flush, i, 128 << 20);
    spin<<<1, 1>>>(1000000);
    cudaEventRecord(e0);
    launch();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    total += ms;
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error %s\n", cudaGetErrorString(err));
    return -1.f;
  }
  return total / 20;
}

template <int PT, int MODE>
float time_mode(const Bufs& b, int nsplit, int fit) {
  const dim3 grid(nsplit, b.B);
  if (!cooperative(MODE))
    return timed(b, [&] {
      variant<PT, MODE><<<grid, kThreads>>>(b.x, b.pm, b.pl, b.tickets, b.mo,
                                            b.out, b.V, nsplit);
    });
  if (nsplit * b.B > fit) return -1.f;
  const float* xp = b.x;
  float *pm = b.pm, *pl = b.pl, *mo = b.mo, *out = b.out;
  unsigned* t = b.tickets;
  int V = b.V, ns = nsplit;
  void* args[] = {&xp, &pm, &pl, &t, &mo, &out, &V, &ns};
  return timed(b, [&] {
    cudaLaunchCooperativeKernel((const void*)variant<PT, MODE>, grid,
                                dim3(kThreads), args, 0, 0);
  });
}

template <int PT, int... M>
void run_modes(const Bufs& b, std::integer_sequence<int, M...>) {
  const int nsplit = (b.V + kThreads * PT - 1) / (kThreads * PT);
  int occ = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, variant<PT, kGrid>,
                                                kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const float ms[] = {time_mode<PT, M>(b, nsplit, occ * sms)...};
  const double mb = (double)b.B * b.V * 4 / 1e6;
  for (int i = 0; i < kModes; ++i)
    printf("PT %2d (%3d blocks, %d per SM fit): %-9s %.4f ms (%.0f GB/s of "
           "x read)\n", PT, nsplit * b.B, occ, kNames[i], ms[i],
           ms[i] > 0 ? mb / ms[i] : 0.0);
}

__global__ void fill(float* x, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)i * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    x[i] = (h >> 8) * (16.f / 16777216.f) - 8.f;
  }
}

}  // namespace probe

namespace big {

using probe::Bufs;
using probe::timed;

enum Depth { kRd, kFd, kAll, kDepths };
const char* kDepthNames[] = {"read", "fold", "full"};

struct Args {
  float *pm, *pl, *mo, *lo, *sink;
  unsigned* tickets;
  int B, V, nsplit;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// After a chunk's fold: its partial out (kFd), then the ticket and the
// last block's merge (kAll, = unit_stats_kernel's tail).
template <int DEPTH>
__device__ __forceinline__ void tail(float m, float l, bool* last,
                                     const Args& a, int row, int split) {
  const size_t p = (size_t)row * a.nsplit;
  if (threadIdx.x == 0) {
    a.pm[p + split] = m;
    a.pl[p + split] = l;
    if (DEPTH == kAll)
      *last = take_ticket(a.tickets + row) == (unsigned)(a.nsplit - 1);
  }
  if (DEPTH == kAll) {
    __syncthreads();
    if (*last && threadIdx.x < 32) {
      merge_partials(a.pm + p, a.pl + p, a.nsplit, threadIdx.x, m, l);
      if (threadIdx.x == 0) {
        a.mo[row] = m;
        a.lo[row] = l;
        a.tickets[row] = 0;
      }
    }
  }
  __syncthreads();  // sh and *last are free for the next item
}

// What a block does with one (chunk, row) item once its elements are in
// v: nothing (kRd), the fold and its partial (kFd), or the fold, the
// ticket and the last block's merge (kAll).
template <int DEPTH>
__device__ __forceinline__ void finish(const float (&v)[kPerThread],
                                       float* sh, bool* last,
                                       const Args& a, int row, int split) {
  if (DEPTH == kRd) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) s += v[k];
    if (s == 1234.5f) a.sink[0] = s;  // never taken: keeps the loads
    return;
  }
  float m, l;
  fold_chunk(v, sh, m, l);
  tail<DEPTH>(m, l, last, a, row, split);
}

// (a) one block per (chunk, row)
template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    per_chunk(const T* __restrict__ x, Args a) {
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.y;
  const int begin = split * kChunk, end = min(a.V, begin + kChunk);
  float v[kPerThread];
  load_chunk<T, true>(x + (size_t)row * a.V, begin, end, v);
  finish<DEPTH>(v, sh, &last, a, row, split);
}

// (b) a persistent walk, the next item's loads in registers
template <typename T>
struct Raw {
  static constexpr int VEC = 16 / (int)sizeof(T), NV = kPerThread / VEC;
  Vec<T, VEC> c[NV];
};

template <typename T>
__device__ __forceinline__ void issue(const T* __restrict__ x, const Args& a,
                                      long long item, long long items,
                                      Raw<T>& r) {
  constexpr int VEC = Raw<T>::VEC;
  if (item >= items) return;
  const int row = (int)(item / a.nsplit);
  const int begin = (int)(item - (long long)row * a.nsplit) * kChunk;
  const int end = min(a.V, begin + kChunk);
  const T* xr = x + (size_t)row * a.V;
#pragma unroll
  for (int j = 0; j < Raw<T>::NV; ++j) {
    const int at = begin + (j * kThreads + threadIdx.x) * VEC;
    if (at < end) r.c[j] = *reinterpret_cast<const Vec<T, VEC>*>(xr + at);
  }
}

template <typename T, int DEPTH>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
    persist_regs(const T* __restrict__ x, Args a) {
  constexpr int VEC = Raw<T>::VEC;
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const long long items = (long long)a.B * a.nsplit;
  Raw<T> r;
  long long item = blockIdx.x;
  issue(x, a, item, items, r);
  for (; item < items; item += gridDim.x) {
    const int row = (int)(item / a.nsplit);
    const int split = (int)(item - (long long)row * a.nsplit);
    const int begin = split * kChunk, end = min(a.V, begin + kChunk);
    float v[kPerThread];
#pragma unroll
    for (int j = 0; j < Raw<T>::NV; ++j) {
      const bool in = begin + (j * kThreads + threadIdx.x) * VEC < end;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        v[j * VEC + e] = in ? to_float(r.c[j].v[e]) : -INFINITY;
    }
    issue(x, a, item + gridDim.x, items, r);
    finish<DEPTH>(v, sh, &last, a, row, split);
  }
}

// (a) at a stated occupancy (at least MINB blocks per SM), rows on grid.y
// and grid.z (no row loop)
template <typename T, int DEPTH, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    per_chunk_at(const T* __restrict__ x, Args a) {
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= a.B) return;
  const int begin = split * kChunk, end = min(a.V, begin + kChunk);
  float v[kPerThread];
  load_chunk<T, true>(x + (size_t)row * a.V, begin, end, v);
  finish<DEPTH>(v, sh, &last, a, row, split);
}

// (a) with each thread's elements kept as loaded (bf16 packed two to a
// register) and widened where the fold reads them: the same values in the
// same order, in half the registers for bf16
template <typename T>
__device__ __forceinline__ float at_k(const Raw<T>& r,
                                      const bool (&in)[Raw<T>::NV], int k) {
  constexpr int VEC = Raw<T>::VEC;
  return in[k / VEC] ? to_float(r.c[k / VEC].v[k % VEC]) : -INFINITY;
}

template <typename T>
__device__ __forceinline__ void fold_raw(const Raw<T>& r,
                                         const bool (&in)[Raw<T>::NV],
                                         float* sh, float& m, float& l) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float t = at_k(r, in, 0);
#pragma unroll
  for (int k = 1; k < kPerThread; ++k) t = fmaxf(t, at_k(r, in, k));
  t = warp_max(t);
  if (lane == 0) sh[warp] = t;
  __syncthreads();
  m = sh[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, sh[w]);
  const float base = m == -INFINITY ? 0.f : m;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) s += expf(at_k(r, in, k) - base);
  s = warp_sum(s);
  if (lane == 0) sh[kWarps + warp] = s;
  __syncthreads();
  l = sh[kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) l += sh[kWarps + w];
}

template <typename T, int DEPTH, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    per_chunk_raw(const T* __restrict__ x, Args a) {
  constexpr int VEC = Raw<T>::VEC;
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= a.B) return;
  const int begin = split * kChunk, end = min(a.V, begin + kChunk);
  const T* xr = x + (size_t)row * a.V;
  Raw<T> r;
  bool in[Raw<T>::NV];
#pragma unroll
  for (int j = 0; j < Raw<T>::NV; ++j) {
    const int at = begin + (j * kThreads + threadIdx.x) * VEC;
    in[j] = at < end;
    if (in[j]) r.c[j] = *reinterpret_cast<const Vec<T, VEC>*>(xr + at);
  }
  if (DEPTH == kRd) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) s += at_k(r, in, k);
    if (s == 1234.5f) a.sink[0] = s;  // never taken: keeps the loads
    return;
  }
  float m, l;
  fold_raw(r, in, sh, m, l);
  tail<DEPTH>(m, l, &last, a, row, split);
}

// (c) a persistent walk, items streamed into an S-stage shared ring
template <typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ x, const Args& a,
                                      long long item, long long items,
                                      T* stage, unsigned long long* bar) {
  if (item >= items) return;
  const int row = (int)(item / a.nsplit);
  const int begin = (int)(item - (long long)row * a.nsplit) * kChunk;
  const unsigned bytes =
      (unsigned)((min(a.V, begin + kChunk) - begin) * (int)sizeof(T));
  const T* src = x + (size_t)row * a.V + begin;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(stage)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wait_parity(unsigned long long* bar,
                                            unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2; selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

template <typename T, int S, int DEPTH>
__global__ void __launch_bounds__(kThreads)
    persist_bulk(const T* __restrict__ x, Args a) {
  extern __shared__ __align__(128) unsigned char ring_raw[];
  T* ring = reinterpret_cast<T*>(ring_raw);
  __shared__ __align__(8) unsigned long long full[S];
  __shared__ float sh[2 * kWarps];
  __shared__ bool last;
  const long long items = (long long)a.B * a.nsplit;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_u32(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < S; ++s)
      fetch(x, a, blockIdx.x + (long long)s * gridDim.x, items,
            ring + s * kChunk, full + s);
  }
  __syncthreads();
  int k = 0;
  for (long long item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int s = k % S;
    wait_parity(full + s, (unsigned)(k / S) & 1u);
    const int row = (int)(item / a.nsplit);
    const int split = (int)(item - (long long)row * a.nsplit);
    const int begin = split * kChunk, end = min(a.V, begin + kChunk);
    float v[kPerThread];
    load_chunk<T, true>(ring + s * kChunk, 0, end - begin, v);
    __syncthreads();  // every thread holds its elements: stage s is free
    if (threadIdx.x == 0)
      fetch(x, a, item + (long long)S * gridDim.x, items, ring + s * kChunk,
            full + s);
    finish<DEPTH>(v, sh, &last, a, row, split);
  }
}

// The repository's own block body (csrc/online_softmax.cu stats_block)
// under other launch bounds: its stats head and its cross-entropy head at
// N blocks per SM
template <Head HEAD, typename T, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    head_at(const T* __restrict__ x, Args a, XentOut xo) {
  stats_block<HEAD, T, true>(
      x, Rows{a.pm, a.pl, a.mo, a.lo, a.tickets, a.B, a.V, a.nsplit}, xo);
}

// The cross-entropy head with the label logit loaded by thread 0 beside
// the chunk's own loads (a second read of one element, not in the tail)
// in place of stats_block's pick from the register that holds it
template <typename T, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    xent_ld(const T* __restrict__ x, Args a, XentOut xo) {
  __shared__ float sh[2 * kWarps];
  __shared__ float label_x;
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= a.B) return;
  const int begin = split * kChunk, end = min(a.V, begin + kChunk);
  const T* xr = x + (size_t)row * a.V;
  float v[kPerThread];
  load_chunk<T, true>(xr, begin, end, v);
  if (threadIdx.x == 0) {
    const long long label = xo.labels[row];
    if (label >= begin && label < end) label_x = to_float(xr[label]);
  }
  float m, l;
  fold_chunk(v, sh, m, l);
  const size_t p = (size_t)row * a.nsplit;
  if (threadIdx.x == 0) {
    a.pm[p + split] = m;
    a.pl[p + split] = l;
    const long long label = xo.labels[row];
    if (label < 0 || label >= a.V) {
      if (split == 0) xo.xl[row] = NAN;
    } else if (label / kChunk == split) {
      xo.xl[row] = label_x;
    }
    last = take_ticket(a.tickets + row) == (unsigned)(a.nsplit - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    merge_partials(a.pm + p, a.pl + p, a.nsplit, threadIdx.x, m, l);
    if (threadIdx.x == 0) {
      xo.loss[row] = m + logf(l) - __ldcg(xo.xl + row);
      a.tickets[row] = 0;
    }
  }
}

// The cross-entropy head handing the label logit to thread 0 through
// shared memory: the thread that holds it stores it there, and thread 0
// (reading the label again) writes it to the scratch slot before its
// ticket, in place of stats_block's write by the holding thread
template <typename T, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    xent_sm(const T* __restrict__ x, Args a, XentOut xo) {
  __shared__ float sh[2 * kWarps];
  __shared__ float label_x;
  __shared__ bool last;
  const int split = blockIdx.x, row = blockIdx.z * gridDim.y + blockIdx.y;
  if (row >= a.B) return;
  const int begin = split * kChunk, end = min(a.V, begin + kChunk);
  float v[kPerThread];
  load_chunk<T, true>(x + (size_t)row * a.V, begin, end, v);
  {
    const long long label = xo.labels[row];
    float got;
    if (label >= 0 && label < a.V && label / kChunk == split &&
        holds<T>((int)(label % kChunk), v, got))
      label_x = got;
  }
  float m, l;
  fold_chunk(v, sh, m, l);
  const size_t p = (size_t)row * a.nsplit;
  if (threadIdx.x == 0) {
    a.pm[p + split] = m;
    a.pl[p + split] = l;
    const long long label = xo.labels[row];
    if (label < 0 || label >= a.V) {
      if (split == 0) xo.xl[row] = NAN;
    } else if (label / kChunk == split) {
      xo.xl[row] = label_x;
    }
    last = take_ticket(a.tickets + row) == (unsigned)(a.nsplit - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    merge_partials(a.pm + p, a.pl + p, a.nsplit, threadIdx.x, m, l);
    if (threadIdx.x == 0) {
      xo.loss[row] = m + logf(l) - __ldcg(xo.xl + row);
      a.tickets[row] = 0;
    }
  }
}

template <typename K>
int resident(K kern, size_t smem) {
  int occ = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, kThreads, smem);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  return occ * sms;
}

// (c) at one ring depth: its grid, ms at each depth, and a copy of the
// (m, l) its full run wrote
struct Timing {
  int grid;
  float ms[kDepths];
  float* ml;
};

template <typename T, int S>
Timing time_bulk(const Bufs& b, const T* x, const Args& a, long long items) {
  const size_t smem = (size_t)S * kChunk * sizeof(T);
  cudaFuncSetAttribute(persist_bulk<T, S, kRd>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(persist_bulk<T, S, kFd>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncSetAttribute(persist_bulk<T, S, kAll>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  Timing t;
  t.grid = (int)std::min<long long>(
      items, resident(persist_bulk<T, S, kAll>, smem));
  const int g = t.grid;
  t.ms[kRd] = timed(
      b, [&] { persist_bulk<T, S, kRd><<<g, kThreads, smem>>>(x, a); });
  t.ms[kFd] = timed(
      b, [&] { persist_bulk<T, S, kFd><<<g, kThreads, smem>>>(x, a); });
  t.ms[kAll] = timed(
      b, [&] { persist_bulk<T, S, kAll><<<g, kThreads, smem>>>(x, a); });
  cudaMalloc(&t.ml, 2 * (size_t)a.B * sizeof(float));
  cudaMemcpy(t.ml, a.mo, 2 * (size_t)a.B * sizeof(float),
             cudaMemcpyDeviceToDevice);
  return t;
}

// One shape: every variant at every depth, then the repository's stats.
template <typename T>
void run_shape(const Bufs& b, const T* x, const Args& base, float* ref_ml,
               float* got_ml, const long long* labels, float* xl,
               float* loss) {
  const int nsplit = base.nsplit;
  const long long items = (long long)base.B * nsplit;
  const double mb = (double)base.B * base.V * sizeof(T) / 1e6;
  const double bound = mb / 3.35e6 * 1e3;  // ms at 3.35 TB/s
  printf("  bound %.4f ms (%.1f MB of x at 3.35 TB/s), %lld items\n", bound,
         mb, items);
  auto show = [&](const char* name, const char* depth, int grid, float ms) {
    printf("  %-10s %-4s grid %6d: %.4f ms (%.0f GB/s, %.2fx bound)\n", name,
           depth, grid, ms, ms > 0 ? mb / ms : 0.0, ms / bound);
  };
  auto same = [&](const char* name) {
    const size_t n = 2 * (size_t)base.B * sizeof(float);
    cudaMemcpy(got_ml, base.mo, n, cudaMemcpyDeviceToDevice);
    float* h = new float[4 * base.B];
    cudaMemcpy(h, ref_ml, n, cudaMemcpyDeviceToHost);
    cudaMemcpy(h + 2 * base.B, got_ml, n, cudaMemcpyDeviceToHost);
    const bool eq = memcmp(h, h + 2 * base.B, n) == 0;
    delete[] h;
    printf("  %-10s (m, l) bitwise equal to (a)'s: %s\n", name,
           eq ? "yes" : "NO");
  };
  Args a = base;
  a.lo = a.mo + base.B;
  // (a)
  {
    const dim3 grid(nsplit, base.B);
    const float ms[] = {
        timed(b, [&] { per_chunk<T, kRd><<<grid, kThreads>>>(x, a); }),
        timed(b, [&] { per_chunk<T, kFd><<<grid, kThreads>>>(x, a); }),
        timed(b, [&] { per_chunk<T, kAll><<<grid, kThreads>>>(x, a); })};
    for (int d = 0; d < kDepths; ++d)
      show("(a) chunk", kDepthNames[d], (int)items, ms[d]);
    cudaMemcpy(ref_ml, a.mo, 2 * (size_t)base.B * sizeof(float),
               cudaMemcpyDeviceToDevice);
  }
  // (a) at 4, 6 and 8 blocks per SM, elements widened or kept packed
  {
    const dim3 grid(nsplit, std::min(base.B, 65535),
                    (base.B + 65534) / 65535);
    const char* names[] = {"(a) at4", "(a) at6", "(a) at8",
                           "(a) raw4", "(a) raw6", "(a) raw8"};
    const int blocks[] = {resident(per_chunk_at<T, kAll, 4>, 0),
                          resident(per_chunk_at<T, kAll, 6>, 0),
                          resident(per_chunk_at<T, kAll, 8>, 0),
                          resident(per_chunk_raw<T, kAll, 4>, 0),
                          resident(per_chunk_raw<T, kAll, 6>, 0),
                          resident(per_chunk_raw<T, kAll, 8>, 0)};
#define PROBE_AT(K, D, N) \
  timed(b, [&] { K<T, D, N><<<grid, kThreads>>>(x, a); })
#define PROBE_DEPTHS(K, N) \
  { PROBE_AT(K, kRd, N), PROBE_AT(K, kFd, N), PROBE_AT(K, kAll, N) }
    const float ms[][kDepths] = {
        PROBE_DEPTHS(per_chunk_at, 4),  PROBE_DEPTHS(per_chunk_at, 6),
        PROBE_DEPTHS(per_chunk_at, 8),  PROBE_DEPTHS(per_chunk_raw, 4),
        PROBE_DEPTHS(per_chunk_raw, 6), PROBE_DEPTHS(per_chunk_raw, 8)};
#undef PROBE_DEPTHS
#undef PROBE_AT
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
    for (int i = 0; i < 6; ++i) {
      printf("  %-10s fits %d blocks per SM\n", names[i], blocks[i] / sms);
      for (int d = 0; d < kDepths; ++d)
        show(names[i], kDepthNames[d], (int)items, ms[i][d]);
    }
    per_chunk_raw<T, kAll, 8><<<grid, kThreads>>>(x, a);
    same("(a) raw8");
    per_chunk_at<T, kAll, 8><<<grid, kThreads>>>(x, a);
    same("(a) at8");
  }
  // the repository's stats_block: stats and cross-entropy heads
  {
    const dim3 grid(nsplit, std::min(base.B, 65535),
                    (base.B + 65534) / 65535);
    const XentOut xo{labels, xl, loss};
    const char* names[] = {"stats at8", "xent at8", "xent at6", "xent at5"};
    const float ms[] = {
        timed(b, [&] {
          head_at<Head::kStats, T, 8><<<grid, kThreads>>>(x, a, xo);
        }),
        timed(b, [&] {
          head_at<Head::kXent, T, 8><<<grid, kThreads>>>(x, a, xo);
        }),
        timed(b, [&] {
          head_at<Head::kXent, T, 6><<<grid, kThreads>>>(x, a, xo);
        }),
        timed(b, [&] {
          head_at<Head::kXent, T, 5><<<grid, kThreads>>>(x, a, xo);
        })};
    for (int i = 0; i < 4; ++i) show(names[i], "full", (int)items, ms[i]);
    // stats_block's loss (xent at5 ran last), then each other head's
    float* h = new float[2 * base.B];
    cudaMemcpy(h, loss, (size_t)base.B * sizeof(float),
               cudaMemcpyDeviceToHost);
    auto same_loss = [&](const char* name) {
      cudaMemcpy(h + base.B, loss, (size_t)base.B * sizeof(float),
                 cudaMemcpyDeviceToHost);
      printf("  %-10s loss bitwise equal to stats_block's: %s\n", name,
             memcmp(h, h + base.B, (size_t)base.B * sizeof(float)) == 0
                 ? "yes" : "NO");
    };
    const float ld[] = {
        timed(b, [&] { xent_ld<T, 8><<<grid, kThreads>>>(x, a, xo); }),
        timed(b, [&] { xent_ld<T, 6><<<grid, kThreads>>>(x, a, xo); })};
    show("xent-ld 8", "full", (int)items, ld[0]);
    show("xent-ld 6", "full", (int)items, ld[1]);
    same_loss("xent-ld 6");
    const float sm[] = {
        timed(b, [&] { xent_sm<T, 8><<<grid, kThreads>>>(x, a, xo); }),
        timed(b, [&] { xent_sm<T, 6><<<grid, kThreads>>>(x, a, xo); })};
    show("xent-sm 8", "full", (int)items, sm[0]);
    show("xent-sm 6", "full", (int)items, sm[1]);
    same_loss("xent-sm 6");
    delete[] h;
  }
  // (b)
  {
    const int g = (int)std::min<long long>(
        items, resident(persist_regs<T, kAll>, 0));
    const float ms[] = {
        timed(b, [&] { persist_regs<T, kRd><<<g, kThreads>>>(x, a); }),
        timed(b, [&] { persist_regs<T, kFd><<<g, kThreads>>>(x, a); }),
        timed(b, [&] { persist_regs<T, kAll><<<g, kThreads>>>(x, a); })};
    for (int d = 0; d < kDepths; ++d)
      show("(b) regs", kDepthNames[d], g, ms[d]);
    same("(b) regs");
  }
  // (c), S = 2, 3, 4
  const char* bulk_names[] = {"(c) bulk-2", "(c) bulk-3", "(c) bulk-4"};
  Timing t[] = {time_bulk<T, 2>(b, x, a, items),
                time_bulk<T, 3>(b, x, a, items),
                time_bulk<T, 4>(b, x, a, items)};
  for (int i = 0; i < 3; ++i) {
    for (int d = 0; d < kDepths; ++d)
      show(bulk_names[i], kDepthNames[d], t[i].grid, t[i].ms[d]);
    cudaMemcpy(a.mo, t[i].ml, 2 * (size_t)base.B * sizeof(float),
               cudaMemcpyDeviceToDevice);
    cudaFree(t[i].ml);
    same(bulk_names[i]);
  }
  // the repository's stats entry
  const int dtype = sizeof(T) == 4 ? 0 : 1;
  float* scratch;
  cudaMalloc(&scratch, 2 * (size_t)base.B * (nsplit + 1) * sizeof(float));
  const float ms = timed(b, [&] {
    repro_softmax_stats(x, scratch, a.tickets, base.B, base.V, nsplit, dtype,
                        nullptr);
  });
  show("unit-stats", "full", -1, ms);
  cudaMemcpy(a.mo, scratch, 2 * (size_t)base.B * sizeof(float),
             cudaMemcpyDeviceToDevice);
  same("unit-stats");
  const float xms = timed(b, [&] {
    repro_fused_xent(x, labels, scratch, a.tickets, base.B, base.V, nsplit,
                     dtype, nullptr);
  });
  show("unit-xent", "full", -1, xms);
  cudaFree(scratch);
}

template <typename T>
__global__ void fill(T* x, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)i * 2654435761u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    x[i] = (T)((h >> 8) * (16.f / 16777216.f) - 8.f);
  }
}

template <typename T>
void run(const Bufs& b, int B, int V, const char* dtype) {
  const size_t n = (size_t)B * V;
  T* x;
  cudaMalloc(&x, n * sizeof(T));
  fill<<<4096, 256>>>(x, n);
  Args a{};
  a.B = B;
  a.V = V;
  a.nsplit = (V + kChunk - 1) / kChunk;
  const size_t parts = (size_t)B * a.nsplit;
  cudaMalloc(&a.pm, parts * sizeof(float));
  cudaMalloc(&a.pl, parts * sizeof(float));
  cudaMalloc(&a.mo, 2 * (size_t)B * sizeof(float));
  cudaMalloc(&a.sink, sizeof(float));
  cudaMalloc(&a.tickets, (size_t)B * sizeof(unsigned));
  cudaMemset(a.tickets, 0, (size_t)B * sizeof(unsigned));
  float *ref_ml, *got_ml;
  cudaMalloc(&ref_ml, 2 * (size_t)B * sizeof(float));
  cudaMalloc(&got_ml, 2 * (size_t)B * sizeof(float));
  // labels spread over the row: (row * 7919) % V
  long long* labels;
  float *xl, *loss;
  cudaMalloc(&labels, (size_t)B * sizeof(long long));
  cudaMalloc(&xl, (size_t)B * sizeof(float));
  cudaMalloc(&loss, (size_t)B * sizeof(float));
  long long* h = new long long[B];
  for (int r = 0; r < B; ++r) h[r] = (long long)r * 7919 % V;
  cudaMemcpy(labels, h, (size_t)B * sizeof(long long),
             cudaMemcpyHostToDevice);
  delete[] h;
  printf("x (%d, %d) %s:\n", B, V, dtype);
  run_shape<T>(b, x, a, ref_ml, got_ml, labels, xl, loss);
  cudaFree(labels);
  cudaFree(xl);
  cudaFree(loss);
  cudaFree(x);
  cudaFree(a.pm);
  cudaFree(a.pl);
  cudaFree(a.mo);
  cudaFree(a.sink);
  cudaFree(a.tickets);
  cudaFree(ref_ml);
  cudaFree(got_ml);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) printf("CUDA error %s\n", cudaGetErrorString(err));
}

}  // namespace big

int main() {
  using namespace probe;
  Bufs b;
  b.B = 12;
  b.V = 151936;
  const size_t n = (size_t)b.B * b.V;
  cudaMalloc(&b.x, n * 4);
  cudaMalloc(&b.out, n * 4);
  cudaMalloc(&b.pm, 1 << 20);
  cudaMalloc(&b.pl, 1 << 20);
  cudaMalloc(&b.mo, 1 << 20);
  cudaMalloc(&b.tickets, 1 << 20);
  cudaMalloc(&b.flush, 128 << 20);
  fill<<<1024, 256>>>(b.x, n);
  cudaMemset(b.tickets, 0, 1 << 20);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs; x (%d, %d) f32, %.3f MB\n", prop.name,
         prop.multiProcessorCount, b.B, b.V, n * 4 / 1e6);
  printf("empty launch: %.4f ms\n", timed(b, [&] { empty<<<1, 1>>>(); }));
  run_modes<16>(b, std::make_integer_sequence<int, kModes>{});
  run_modes<32>(b, std::make_integer_sequence<int, kModes>{});
  const int nsplit = (b.V + 4095) / 4096;
  float* scratch;
  cudaMalloc(&scratch, 2 * b.B * (nsplit + 1) * sizeof(float));
  const float stats = timed(b, [&] {
    repro_softmax_stats(b.x, scratch, b.tickets, b.B, b.V, nsplit, 0,
                        nullptr);
  });
  const float one = timed(b, [&] {
    repro_softmax_one_pass(b.x, scratch, b.out, b.B, b.V, nsplit, 0,
                           nullptr);
  });
  printf("unit-stats     %.4f ms\nunit-one-pass  %.4f ms\n", stats, one);
  big::run<float>(b, 12, 151936, "f32");
  big::run<__nv_bfloat16>(b, 512, 151936, "bf16");
  big::run<__nv_bfloat16>(b, 4096, 151936, "bf16");
  big::run<float>(b, 64, 151936, "f32");
  return 0;
}
