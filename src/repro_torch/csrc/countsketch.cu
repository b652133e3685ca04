// Batched count-sketch segment sum for Hopper (sm_90a).
//
//   out[g, j] = sum over i with h[i] == j of x[g, i]      (g < G, j < b)
//
// Replaces the Pallas kernel src/repro/kernels/countsketch.py
// (_countsketch_kernel, launched by countsketch_clients_pallas).  That
// kernel builds a (TILE_N, b_block) one-hot matrix and runs it through the
// MXU, because the TPU has no fast scatter: n * b multiply-adds.  Hopper
// gathers and scatters at memory speed, so this kernel keeps the function
// and drops the method.
//
// Design.  The hash h is shared by all G rows (one sketch operator per
// round), so the wrapper buckets it once per call into CSR form with
// PyTorch's integer primitives: perm = argsort(h) by torch.sort(stable=True)
// and off = cumsum(bincount(h)).  Slot j then owns perm[off[j]:off[j+1]],
// the indices i with h[i] == j in ascending order.  This kernel gives each
// slot one thread, which walks its segment once and sums x[g, perm[k]] for
// up to CS_ROWS rows at a time in registers.  Every (g, j) sum is taken in
// ascending i with no atomics, so the result is deterministic and equal to
// a sequential left-to-right segment sum.
//
// Bound on this card.  The kernel must read x (G * n floats) and the
// indices (n int32) once and write out (G * b floats): it is bound by
// device-memory bytes (3.35 TB/s on an H100 SXM); the G * n additions are
// negligible.  Gathering x[g, perm[k]] touches a 32-byte sector for each
// 4-byte value, so this first version moves several times the bytes of the
// bound; the bucketing sort adds passes over n of its own.
#include <cuda_runtime.h>

#define CS_ROWS 8

__global__ void countsketch_segsum_kernel(const float* __restrict__ x,
                                          const int* __restrict__ perm,
                                          const int* __restrict__ off,
                                          float* __restrict__ out,
                                          int G, long long n, long long b) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  const int start = off[j];
  const int end = off[j + 1];
  for (int g0 = 0; g0 < G; g0 += CS_ROWS) {
    const int rows = min(CS_ROWS, G - g0);
    float acc[CS_ROWS];
#pragma unroll
    for (int r = 0; r < CS_ROWS; ++r) acc[r] = 0.0f;
    for (int k = start; k < end; ++k) {
      const long long i = perm[k];
#pragma unroll
      for (int r = 0; r < CS_ROWS; ++r) {
        if (r < rows) acc[r] += __ldg(x + (long long)(g0 + r) * n + i);
      }
    }
#pragma unroll
    for (int r = 0; r < CS_ROWS; ++r) {
      if (r < rows) out[(long long)(g0 + r) * b + j] = acc[r];
    }
  }
}

// x: (G, n) float32; perm: (n,) int32; off: (b + 1,) int32; out: (G, b).
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int countsketch_segsum(const float* x, const int* perm,
                                  const int* off, float* out, int G,
                                  long long n, long long b, void* stream) {
  if (b == 0 || G == 0) return 0;
  const int threads = 256;
  const long long blocks = (b + threads - 1) / threads;
  countsketch_segsum_kernel<<<(unsigned)blocks, threads, 0,
                              (cudaStream_t)stream>>>(x, perm, off, out, G,
                                                      n, b);
  return (int)cudaGetLastError();
}
