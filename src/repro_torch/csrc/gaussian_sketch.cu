// On-the-fly Gaussian sketch for Hopper (sm_90a): sk and desk of Lemma A.2
// with the b x n matrix R never stored.
//
//   sk:   out[j] = sum_i x[i] * R^T[i, j] / sqrt(b)      (j < b)
//   desk: out[i] = sum_j R^T[i, j] * s[j] / sqrt(b)      (i < n)
//
// Replaces the Pallas kernels of src/repro/kernels/gaussian_sketch.py:
// _sk_kernel (:55, launched by gaussian_sk_pallas) and _desk_kernel (:67,
// launched by gaussian_desk_pallas).  Both regenerate R^T in (TILE_N, b)
// tiles from a counter-based generator and contract each tile on the MXU;
// the TPU carries sk's sum across its sequential grid in VMEM.  This file
// computes exactly their R: for row r of tile t (global row t * TILE_N + r)
// and column c,
//
//   ctr = seed * 0x9E3779B1 + t * 0x85EBCA77 + r * 2b + c * 2   (uint32)
//   u1  = ((splitmix32(ctr)     >> 8) + 1) * 2^-24
//   u2  = ((splitmix32(ctr + 1) >> 8) + 1) * 2^-24
//   R^T[t * TILE_N + r, c] = sqrtf(-2 logf(u1)) * cosf(2 pi u2)
//
// Bound on this card.  Each element of R needs 22 integer operations (one
// add to step the counter, ctr + 1, two 9-operation splitmix32 mixes, two
// >> 8), 12 float operations, and 5 operations on the 16-lane pipe of
// special functions and conversions (log, sqrt, cos, two uint32 -> float),
// and moves no bytes: x, s and the outputs are read and written once.  The
// work is a GEMV, so the tensor cores do not help.  On an H100 the integer
// pipe (64 lanes per SM, half the float32 rate) is the bound, the 16-lane
// pipe close behind it (5/16 against 22/64).  Built without -use_fast_math,
// so logf, sqrtf and cosf are the accurate library versions, which run
// more float instructions than the 12 counted.
//
// Design.
// - sk: a 2-D grid of column blocks x row splits.  Each thread owns one
//   column; each split is a whole number of tiles.  The block stages each
//   tile's slice of x in shared memory, and each thread walks the tile's
//   rows, stepping its counter by 2b per row.  Hopper has no sequential
//   grid, so each block writes its partial sums to partials[split, :] and a
//   second launch sums the splits in order and divides by sqrt(b).  No
//   float atomics: the result is deterministic.
// - desk: a warp per output row.  Lanes stride over the columns and a warp
//   shuffle sums them in a fixed order.  s reaches 70,779 floats (283 KB,
//   more than a block's 227 KB of shared memory), so the block stages it in
//   pieces of DESK_PIECE floats that all its warps share.
#include <cuda_runtime.h>
#include <stdint.h>

#define TILE_N 512
#define SK_THREADS 256
#define DESK_WARPS 8
#define DESK_PIECE 4096

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x += 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ float uniform01(uint32_t bits) {
  // the top 24 bits -> (0, 1]; never 0, so logf is finite
  return ((float)(bits >> 8) + 1.0f) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float gauss(uint32_t ctr) {
  const float u1 = uniform01(splitmix32(ctr));
  const float u2 = uniform01(splitmix32(ctr + 1u));
  // 6.2831855f is float32(2 pi), the constant the reference multiplies by
  return sqrtf(-2.0f * logf(u1)) * cosf(6.2831855f * u2);
}

__global__ void __launch_bounds__(SK_THREADS)
gaussian_sk_partials_kernel(uint32_t seed, const float* __restrict__ x,
                            long long n, int b, int tiles_per_split,
                            float* __restrict__ partials) {
  __shared__ float xs[TILE_N];
  const int j = blockIdx.x * SK_THREADS + threadIdx.x;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  const long long t0 = (long long)blockIdx.y * tiles_per_split;
  const long long t1 = min(t0 + tiles_per_split, n_tiles);
  const uint32_t stride = 2u * (uint32_t)b;
  const uint32_t col_base = seed * 0x9E3779B1u + 2u * (uint32_t)j;
  float acc = 0.0f;
  for (long long t = t0; t < t1; ++t) {
    const long long row0 = t * TILE_N;
    const int rows = (int)min((long long)TILE_N, n - row0);
    __syncthreads();  // the previous tile's reads are done
    for (int r = threadIdx.x; r < rows; r += SK_THREADS) xs[r] = x[row0 + r];
    __syncthreads();
    if (j < b) {
      uint32_t ctr = col_base + (uint32_t)t * 0x85EBCA77u;
      for (int r = 0; r < rows; ++r) {
        acc = fmaf(xs[r], gauss(ctr), acc);
        ctr += stride;
      }
    }
  }
  if (j < b) partials[(long long)blockIdx.y * b + j] = acc;
}

__global__ void gaussian_sk_reduce_kernel(const float* __restrict__ partials,
                                          int splits, int b,
                                          float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partials[(long long)s * b + j];
  out[j] = acc / sqrtf((float)b);
}

__global__ void __launch_bounds__(DESK_WARPS * 32)
gaussian_desk_kernel(uint32_t seed, const float* __restrict__ s, int b,
                     long long n, float* __restrict__ out) {
  __shared__ float ss[DESK_PIECE];
  const int lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * DESK_WARPS + (threadIdx.x >> 5);
  const bool live = i < n;
  const uint32_t stride = 2u * (uint32_t)b;
  const uint32_t row_base = seed * 0x9E3779B1u
                            + (uint32_t)(i / TILE_N) * 0x85EBCA77u
                            + (uint32_t)(i % TILE_N) * stride;
  float acc = 0.0f;
  for (int p0 = 0; p0 < b; p0 += DESK_PIECE) {
    const int len = min(DESK_PIECE, b - p0);
    __syncthreads();  // the previous piece's reads are done
    for (int k = threadIdx.x; k < len; k += DESK_WARPS * 32) ss[k] = s[p0 + k];
    __syncthreads();
    if (live) {
      for (int k = lane; k < len; k += 32) {
        acc = fmaf(gauss(row_base + 2u * (uint32_t)(p0 + k)), ss[k], acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (live && lane == 0) out[i] = acc / sqrtf((float)b);
}

// x: (n,) float32; partials: (splits, b) float32, splits * tiles_per_split
// tiles covering the ceil(n / TILE_N) tiles.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int gaussian_sk_partials(uint32_t seed, const float* x, long long n,
                                    int b, int splits, int tiles_per_split,
                                    float* partials, void* stream) {
  const dim3 grid((unsigned)((b + SK_THREADS - 1) / SK_THREADS),
                  (unsigned)splits);
  gaussian_sk_partials_kernel<<<grid, SK_THREADS, 0, (cudaStream_t)stream>>>(
      seed, x, n, b, tiles_per_split, partials);
  return (int)cudaGetLastError();
}

// out[j] = sum over splits of partials[s, j], in order of s, / sqrt(b).
extern "C" int gaussian_sk_reduce(const float* partials, int splits, int b,
                                  float* out, void* stream) {
  const int threads = 256;
  gaussian_sk_reduce_kernel<<<(unsigned)((b + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(partials, splits, b,
                                                         out);
  return (int)cudaGetLastError();
}

// s: (b,) float32; out: (n,) float32.
extern "C" int gaussian_desk(uint32_t seed, const float* s, int b, long long n,
                             float* out, void* stream) {
  const long long blocks = (n + DESK_WARPS - 1) / DESK_WARPS;
  gaussian_desk_kernel<<<(unsigned)blocks, DESK_WARPS * 32, 0,
                         (cudaStream_t)stream>>>(seed, s, b, n, out);
  return (int)cudaGetLastError();
}
