// The streaming floor of the argmax head on the card: how fast a ring of
// 16-byte cp.async copies reads the (V, D) bf16 head weight when the
// block does no math at all, per shape of the staged tile (VT rows x KS
// columns, ST stages, TH threads; one persistent block per SM, the
// argmax head's plan).  csrc/fused_argmax_head.cu's tensor-core tile
// streams W this way, so its time can be read against this floor.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o head_stream_probe scripts/head_stream_probe.cu
//   ./head_stream_probe        # one GPU; prints ms and GB/s per shape
//
// Shapes: qwen3-0.6b's head (V 151936, D 1024) and nemotron-4-340b's
// (V 256000, D 18432).  Means over 20 launches, 256 MB written before
// each so that W is read from HBM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdio>
#include <cstdint>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(pred ? 16 : 0) : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wait_g() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <int VT, int KS, int ST, int TH>
__global__ void __launch_bounds__(TH, 1) stream(const __nv_bfloat16* w, int V, int D, int tpr, unsigned* out) {
  extern __shared__ __align__(16) unsigned char sm[];
  __nv_bfloat16* ring = (__nv_bfloat16*)sm;
  constexpr int LD = KS + 8, SE = VT * LD;
  const int ntiles = (V + VT - 1) / VT;
  const int t0 = blockIdx.x * tpr, t1 = min(ntiles, t0 + tpr);
  const int nslab = (D + KS - 1) / KS;
  const int n = max(0, t1 - t0) * nslab;
  int lt = t0, ls = 0, slot = 0;
  auto load = [&]() {
    __nv_bfloat16* ws = ring + slot * SE;
    const int v0 = lt * VT, k0 = ls * KS;
#pragma unroll
    for (int q = 0; q < VT * KS / 8 / TH; ++q) {
      const int c = threadIdx.x + q * TH;
      const int row = c / (KS / 8), cc = c % (KS / 8), col = k0 + cc * 8;
      const bool ok = v0 + row < V && col < D;
      cp_async16(ws + row * LD + cc * 8, w + (ok ? (size_t)(v0 + row) * D + col : 0), ok);
    }
    if (++ls == nslab) { ls = 0; ++lt; }
    slot = slot + 1 == ST ? 0 : slot + 1;
  };
  for (int s = 0; s < ST - 1; ++s) { if (s < n) load(); commit(); }
  unsigned acc = 0;
  int rs = 0;
  for (int it = 0; it < n; ++it) {
    wait_g<ST - 2>();
    __syncthreads();
    if (it + ST - 1 < n) load();
    commit();
    acc ^= *(const unsigned*)(ring + rs * SE + (threadIdx.x % VT) * LD + (threadIdx.x / VT) * 2 % KS);
    rs = rs + 1 == ST ? 0 : rs + 1;
  }
  wait_g<0>();
  if (acc == 0x12345678u) out[0] = acc;
}

template <int VT, int KS, int ST, int TH>
void run(const __nv_bfloat16* w, int V, int D, int sms, unsigned* out, const char* name) {
  const size_t smem = (size_t)ST * VT * (KS + 8) * 2;
  auto k = stream<VT, KS, ST, TH>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess) { printf("%s: attr fail\n", name); return; }
  const int ntiles = (V + VT - 1) / VT;
  const int tpr = (ntiles + sms - 1) / sms;
  const int grid = (ntiles + tpr - 1) / tpr;
  void* flush; cudaMalloc(&flush, 256 << 20);
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  float best = 1e9, tot = 0; const int iters = 20;
  for (int i = 0; i < iters + 2; ++i) {
    cudaMemsetAsync(flush, i, 256 << 20);
    cudaEventRecord(a);
    k<<<grid, TH, smem>>>(w, V, D, tpr, out);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms; cudaEventElapsedTime(&ms, a, b);
    if (i >= 2) { tot += ms; best = ms < best ? ms : best; }
  }
  cudaError_t e = cudaGetLastError();
  const double bytes = (double)V * D * 2;
  printf("%-28s V %d D %d grid %d smem %zu: mean %.4f ms (%.0f GB/s), best %.4f ms (%.0f GB/s) %s\n", name, V, D, grid, smem,
         tot / iters, bytes / (tot / iters) / 1e6, best, bytes / best / 1e6, e ? cudaGetErrorString(e) : "");
  cudaFree(flush);
}

int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  unsigned* out; cudaMalloc(&out, 4);
  for (int shape = 0; shape < 2; ++shape) {
    const int V = shape ? 256000 : 151936, D = shape ? 18432 : 1024;
    __nv_bfloat16* w; cudaMalloc(&w, (size_t)V * D * 2); cudaMemset(w, 1, (size_t)V * D * 2);
    run<128, 64, 5, 256>(w, V, D, sms, out, "VT128 KS64 S5 T256");
    run<128, 64, 5, 128>(w, V, D, sms, out, "VT128 KS64 S5 T128");
    run<128, 64, 8, 256>(w, V, D, sms, out, "VT128 KS64 S8 T256");
    run<64, 128, 5, 256>(w, V, D, sms, out, "VT64 KS128 S5 T256");
    run<64, 128, 8, 256>(w, V, D, sms, out, "VT64 KS128 S8 T256");
    run<32, 256, 5, 256>(w, V, D, sms, out, "VT32 KS256 S5 T256");
    run<32, 256, 8, 256>(w, V, D, sms, out, "VT32 KS256 S8 T256");
    run<16, 512, 6, 256>(w, V, D, sms, out, "VT16 KS512 S6 T256");
    run<128, 128, 4, 256>(w, V, D, sms, out, "VT128 KS128 S4 T256");
    run<128, 32, 8, 256>(w, V, D, sms, out, "VT128 KS32 S8 T256");
    cudaFree(w);
  }
  return 0;
}
