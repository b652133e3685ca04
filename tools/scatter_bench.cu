// Device times of the memory patterns a count-sketch placement can use, at
// the bert_100m uplink's size (n = 132,008,448 records of 32 bytes, b =
// 2,640,275 slots): integer atomics with and without a returned value, a
// coalesced copy of the records, and 32-byte records scattered over the
// whole 4.2 GB buffer or within ranges of 16 MB, 4 MB and 128 KB.
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o build/scatter_bench \
//       tools/scatter_bench.cu && build/scatter_bench
//
// Needs one CUDA card with ~10 GB free; prints three timings (CUDA events)
// of each pattern.
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352dU; x ^= x >> 15; x *= 0x846ca68bU; x ^= x >> 16;
  return x;
}
__global__ void red_hist(const int* h, long long n, int* cnt) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i < n) atomicAdd(cnt + h[i], 1);
}
__global__ void atom_ret(const int* h, long long n, int* cnt, int* got) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i < n) got[i] = atomicAdd(cnt + h[i], 1);
}
__global__ void copy32(const int4* src, long long n, int4* dst) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  dst[2 * i] = src[2 * i];
  dst[2 * i + 1] = src[2 * i + 1];
}
// record i to a pseudo-random place inside its range of `span` records
__global__ void scatter32(const int4* src, long long n, long long span, int4* dst) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= n) return;
  long long p = i / span * span + mix((unsigned)i) % span;
  if (p >= n) p = i;
  dst[2 * p] = src[2 * i];
  dst[2 * p + 1] = src[2 * i + 1];
}

int main() {
  const long long n = 132008448;
  const int b = 2640275;
  int *h, *cnt, *got;
  int4 *a, *c;
  if (cudaMalloc(&h, n * 4) || cudaMalloc(&cnt, b * 4LL) || cudaMalloc(&got, n * 4) ||
      cudaMalloc(&a, n * 32) || cudaMalloc(&c, n * 32)) {
    fprintf(stderr, "scatter_bench: out of device memory\n");
    return 1;
  }
  int* hh = (int*)malloc(n * 4);
  for (long long i = 0; i < n; ++i) {
    unsigned x = (unsigned)i * 2654435761u;
    x ^= x >> 13; x *= 0x5bd1e995; x ^= x >> 15;
    hh[i] = x % b;
  }
  cudaMemcpy(h, hh, n * 4, cudaMemcpyHostToDevice);
  free(hh);
  cudaMemset(a, 1, n * 32);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const unsigned grid = (unsigned)((n + 255) / 256);
  auto time = [&](const char* name, auto launch) {
    for (int r = 0; r < 3; ++r) {
      cudaMemset(cnt, 0, b * 4LL);
      cudaEventRecord(e0);
      launch();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      printf("%-22s %8.3f ms  (%s)\n", name, ms, cudaGetErrorString(cudaGetLastError()));
    }
  };
  time("atomics, no return", [&] { red_hist<<<grid, 256>>>(h, n, cnt); });
  time("atomics, returned", [&] { atom_ret<<<grid, 256>>>(h, n, cnt, got); });
  time("copy, coalesced", [&] { copy32<<<grid, 256>>>(a, n, c); });
  time("scatter, 4.2 GB", [&] { scatter32<<<grid, 256>>>(a, n, n, c); });
  time("scatter, 16 MB ranges", [&] { scatter32<<<grid, 256>>>(a, n, 524288, c); });
  time("scatter, 4 MB ranges", [&] { scatter32<<<grid, 256>>>(a, n, 131072, c); });
  time("scatter, 128 KB ranges", [&] { scatter32<<<grid, 256>>>(a, n, 4096, c); });
  return 0;
}
