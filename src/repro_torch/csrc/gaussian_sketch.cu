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
// computes their R: for row r of tile t (global row t * TILE_N + r) and
// column c,
//
//   ctr = seed * 0x9E3779B1 + t * 0x85EBCA77 + r * 2b + c * 2   (uint32)
//   u1  = ((splitmix32(ctr)     >> 8) + 1) * 2^-24
//   u2  = ((splitmix32(ctr + 1) >> 8) + 1) * 2^-24
//   R^T[t * TILE_N + r, c] = sqrt(-2 log u1) * cos(2 pi u2)
//
// Bound on this card.  A GEMV whose cost is making R: the tensor cores do
// not help and no bytes bound it (x, s and the outputs are read and
// written once).  Each element of R needs at least 18 integer operations
// (two counters, two splitmix32 mixes less their first add; no >> 8, see
// below), 4 float32 operations, 3 on the 16-lane pipe (log, sqrt, cos) and
// 27 instructions in all.  At one warp instruction per scheduler per clock
// (128 lanes an SM) issuing those 27 is the bound, above the 16-lane pipe
// (3/16 against 27/128) and the integer pipes (18 over the ALU and the
// FMA-heavy pipe, 128 lanes).  chip_smoke.py's GAUSS_TERMS holds each term.
//
// Design.  PERF.md has the SASS counts and the variants
// (tools/gauss_profile.py --variants) that chose it.  Issue and the integer
// ALU (SHF, LOP3, I2FP, IADD: 64 lanes an SM) bind; the loops issue ~30
// instructions an element, ~14 of them on the ALU.
// - The generator, gauss(), is one device function for both kernels, so sk
//   and desk make the same R bit for bit.  Its counter carries splitmix32's
//   first add (x = ctr + 0x9E3779B9, stepped by one add an element); the
//   second stream's x is x + 1.  Both adds are IMADs by an opaque 1 (ONE),
//   so they issue on the FMA-heavy pipe and leave the ALU to the mix.
// - u1 and u2 are exact.  The last xor of the mix also clears the low 8
//   bits (one LOP3), and I2FP converts the result, 256 k for the top 24
//   bits k, exactly (24 significant bits): no >> 8.  (k + 1) 2^-24 and
//   u2 - 1/2 are then each one exact FFMA.
// - R is written as -sqrt(2 ln 2) * sqrt(|log2 u1|) * cos(2 pi (u2 - 1/2)),
//   and -sqrt(2 ln 2) / sqrt(b) scales the finished sums.  lg2, sqrt and
//   cos are the PTX approximations (MUFU.LG2, MUFU.SQRT, MUFU.COS), not the
//   accurate library versions, which put ~130 more instructions an element
//   in the same loop (a polynomial log, cosf's range reduction and its
//   slow path) and made the kernels 2.9x slower.  cos's argument stays in
//   [-pi, pi], where cos.approx is accurate to ~2^-21 absolute; sqrt takes
//   |log2 u1|, so a rounding of lg2 above 0 near u1 = 1 gives no NaN.  Measured on
//   the card over 2^24 elements against the plain version's accurate log,
//   sqrt and cos: mean |error of R| 2.1e-7, at most 2.1e-4, where u1 is
//   within a few ulp of 1 and R ~ 3e-4 (lg2's absolute error, under
//   sqrt); sums of many elements hold 1e-5 of their largest.
// - sk: each thread owns SK_COLS adjacent columns and walks the rows of its
//   split, reading x four rows at a time (a float4 that every thread of the
//   warp reads, served once by L1), so each step holds 4 x SK_COLS
//   independent elements.  A 2-D grid of column blocks x row splits, each
//   split a run of whole tiles, sized by the wrapper to whole waves of the
//   blocks the card holds at once (gaussian_sk_slots).  Each block writes
//   its partial sums to partials[split, :]; a second launch sums the splits
//   in order and scales.  No float atomics: the result is deterministic.
// - desk: the transpose.  Each thread owns DESK_ROWS rows (grid-strided, so
//   stores coalesce) and walks all b columns, reading s four columns at a
//   time the same way; the rows left when fewer than DESK_ROWS remain go
//   as one smaller group.  One wave of blocks, from the card's occupancy.
//   Each row's sum runs over the columns in order.  One launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TILE_N 512
#define SK_THREADS 256
#define SK_COLS 2
#define DESK_THREADS 256
#define DESK_ROWS 2

#define SEED_MUL 0x9E3779B1u
#define TILE_MUL 0x85EBCA77u
#define GOLDEN 0x9E3779B9u  // splitmix32's first add, carried by the counter

// 1, from constant memory so that the compiler cannot fold it: x * ONE + c
// issues as an IMAD on the FMA-heavy pipe, where x + c would take the
// integer ALU, the pipe the mix loads most
__constant__ uint32_t ONE = 1u;

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float cos_approx(float x) {
  float y;
  asm("cos.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// splitmix32 of the counter whose x = ctr + 0x9E3779B9 is given, with its
// low 8 bits cleared, as a float: 256 k for the top 24 bits k, exact
__device__ __forceinline__ float top24(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return (float)((x ^ (x >> 16)) & 0xFFFFFF00u);
}

// R^T at the counter ctr, given x = ctr + 0x9E3779B9, over -sqrt(2 ln 2)
__device__ __forceinline__ float gauss(uint32_t x) {
  const float u1 = fmaf(top24(x), 0x1p-32f, 0x1p-24f);  // (k1 + 1) 2^-24
  // u2 - 1/2 = (k2 + 1) 2^-24 - 1/2, exact; cos 2 pi u2 = -cos 2 pi (u2 - 1/2)
  const float v2 = fmaf(top24(x * ONE + 1u), 0x1p-32f, 0x1p-24f - 0.5f);
  // 6.2831855f is float32(2 pi), the constant the reference multiplies by
  return sqrt_approx(fabsf(lg2_approx(u1))) * cos_approx(6.2831855f * v2);
}

// one step of a walk: acc[v] += w * R(x[v]), then each counter moves on
template <int V>
__device__ __forceinline__ void step(float (&acc)[V], uint32_t (&x)[V], float w,
                                     uint32_t stride) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    acc[v] = fmaf(w, gauss(x[v]), acc[v]);
    x[v] = x[v] * ONE + stride;
  }
}

template <int V>
__device__ __forceinline__ void step4(float (&acc)[V], uint32_t (&x)[V], float4 w,
                                      uint32_t stride) {
  step<V>(acc, x, w.x, stride);
  step<V>(acc, x, w.y, stride);
  step<V>(acc, x, w.z, stride);
  step<V>(acc, x, w.w, stride);
}

__global__ void __launch_bounds__(SK_THREADS)
gaussian_sk_partials_kernel(uint32_t seed, const float* __restrict__ x,
                            long long n, int b, int splits,
                            float* __restrict__ partials) {
  const int c0 = (blockIdx.x * SK_THREADS + threadIdx.x) * SK_COLS;
  if (c0 >= b) return;
  const long long n_tiles = (n + TILE_N - 1) / TILE_N;
  // this split's tiles: n_tiles cut as evenly as whole tiles allow
  const long long t0 = n_tiles * blockIdx.y / splits;
  const long long t1 = n_tiles * (blockIdx.y + 1) / splits;
  const uint32_t stride = 2u * (uint32_t)b;
  const uint32_t col = seed * SEED_MUL + GOLDEN + 2u * (uint32_t)c0;
  float acc[SK_COLS] = {};
  for (long long t = t0; t < t1; ++t) {
    uint32_t ctr[SK_COLS];
#pragma unroll
    for (int v = 0; v < SK_COLS; ++v) ctr[v] = col + (uint32_t)t * TILE_MUL + 2u * v;
    const float* xt = x + t * TILE_N;
    const int rows = (int)min((long long)TILE_N, n - t * TILE_N);
    int r = 0;
    for (; r + 4 <= rows; r += 4) {
      step4<SK_COLS>(acc, ctr, __ldg(reinterpret_cast<const float4*>(xt + r)), stride);
    }
    for (; r < rows; ++r) step<SK_COLS>(acc, ctr, __ldg(xt + r), stride);
  }
  float* out = partials + (long long)blockIdx.y * b;
#pragma unroll
  for (int v = 0; v < SK_COLS; ++v) {
    if (c0 + v < b) out[c0 + v] = acc[v];
  }
}

__global__ void gaussian_sk_reduce_kernel(const float* __restrict__ partials,
                                          int splits, int b, float scale,
                                          float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= b) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += partials[(long long)s * b + j];
  out[j] = acc * scale;
}

// the rows i, i + g, ..., i + (V - 1) g of desk, each summed over the b
// columns in order
template <int V>
__device__ __forceinline__ void desk_rows(uint32_t seed, const float* __restrict__ s,
                                          int b, long long i, long long g,
                                          float scale, float* __restrict__ out) {
  const uint32_t row_stride = 2u * (uint32_t)b;
  float acc[V] = {};
  uint32_t ctr[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long row = i + v * g;
    ctr[v] = seed * SEED_MUL + GOLDEN + (uint32_t)(row / TILE_N) * TILE_MUL
             + (uint32_t)(row % TILE_N) * row_stride;
  }
  int j = 0;
  for (; j + 4 <= b; j += 4) {
    step4<V>(acc, ctr, __ldg(reinterpret_cast<const float4*>(s + j)), 2u);
  }
  for (; j < b; ++j) step<V>(acc, ctr, __ldg(s + j), 2u);
#pragma unroll
  for (int v = 0; v < V; ++v) out[i + v * g] = acc[v] * scale;
}

// the last rows of a thread, left < DESK_ROWS of them, as one group
template <int V>
__device__ __forceinline__ void desk_tail(int left, uint32_t seed,
                                          const float* __restrict__ s, int b,
                                          long long i, long long g, float scale,
                                          float* __restrict__ out) {
  if (left == V) {
    desk_rows<V>(seed, s, b, i, g, scale, out);
  } else if constexpr (V > 1) {
    desk_tail<V - 1>(left, seed, s, b, i, g, scale, out);
  }
}

__global__ void __launch_bounds__(DESK_THREADS)
gaussian_desk_kernel(uint32_t seed, const float* __restrict__ s, int b,
                     long long n, float scale, float* __restrict__ out) {
  const long long g = (long long)gridDim.x * DESK_THREADS;
  long long i = (long long)blockIdx.x * DESK_THREADS + threadIdx.x;
  for (; i + (DESK_ROWS - 1) * g < n; i += DESK_ROWS * g) {
    desk_rows<DESK_ROWS>(seed, s, b, i, g, scale, out);
  }
  if (i < n) desk_tail<DESK_ROWS - 1>((int)((n - 1 - i) / g) + 1, seed, s, b, i, g, scale, out);
}

// -sqrt(2 ln 2) / sqrt(b): R / sqrt(b) = this * sqrt(|log2 u1|) * cos(...)
static float out_scale(int b) { return (float)(-sqrt(2.0 * log(2.0) / b)); }

// Blocks of `kernel` (of `threads` threads) the card holds at once.
static int slots(const void* kernel, int threads, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  *out = per_sm * sms;
  return (int)err;
}

// The sk partials blocks the current card holds at once, into *out.
extern "C" int gaussian_sk_slots(int* out) {
  return slots((const void*)gaussian_sk_partials_kernel, SK_THREADS, out);
}

// x: (n,) float32, 16-byte aligned; partials: (splits, b) float32.  Column
// blocks of SK_THREADS * SK_COLS columns x `splits` runs of whole tiles.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int gaussian_sk_partials(uint32_t seed, const float* x, long long n,
                                    int b, int splits, float* partials,
                                    void* stream) {
  const int cols = SK_THREADS * SK_COLS;
  const dim3 grid((unsigned)((b + cols - 1) / cols), (unsigned)splits);
  gaussian_sk_partials_kernel<<<grid, SK_THREADS, 0, (cudaStream_t)stream>>>(
      seed, x, n, b, splits, partials);
  return (int)cudaGetLastError();
}

// out[j] = (sum over splits of partials[s, j], in order of s) * scale.
extern "C" int gaussian_sk_reduce(const float* partials, int splits, int b,
                                  float* out, void* stream) {
  const int threads = 256;
  gaussian_sk_reduce_kernel<<<(unsigned)((b + threads - 1) / threads), threads,
                              0, (cudaStream_t)stream>>>(partials, splits, b,
                                                         out_scale(b), out);
  return (int)cudaGetLastError();
}

// s: (b,) float32, 16-byte aligned; out: (n,) float32.  One wave of blocks,
// never more than the rows need.
extern "C" int gaussian_desk(uint32_t seed, const float* s, int b, long long n,
                             float* out, void* stream) {
  int blocks = 0;
  const int err = slots((const void*)gaussian_desk_kernel, DESK_THREADS, &blocks);
  if (err) return err;
  const long long need = (n + DESK_THREADS - 1) / DESK_THREADS;
  if (blocks > need) blocks = (int)need;
  gaussian_desk_kernel<<<(unsigned)blocks, DESK_THREADS, 0,
                         (cudaStream_t)stream>>>(seed, s, b, n, out_scale(b),
                                                 out);
  return (int)cudaGetLastError();
}
