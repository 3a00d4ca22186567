// Where the softmax unit's time goes on the card, at the unit path's shape
// (12 rows of 151,936 f32, 7.29 MB, uniform in [-8, 8)): each variant
// below is one launch of the unit's chunk geometry (one block per (chunk,
// row), 256 threads, PT elements a thread, all its 16-byte loads issued
// together), timed on chip_smoke.py's device ruler (the card spins while
// the host enqueues, the L2 is flushed before each run; mean of 20):
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
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o unit_stream_probe scripts/unit_stream_probe.cu
//   ./unit_stream_probe        # one GPU; prints device ms per variant
#include "../src/repro_torch/kernels/csrc/online_softmax.cu"

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <cstdio>
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
  return 0;
}
