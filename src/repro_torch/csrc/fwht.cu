// Unnormalized fast Walsh-Hadamard transform for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/fwht.py (_fwht_rows_kernel,
// launched by fwht_rows_pallas, and the two-level Kronecker path of
// fwht_pallas).  Two kernels:
//
//   fwht_rows  H_C along each row of an (R, C) matrix, C a power of two
//              <= 4096.  A block holds 4096 / C rows (16 KB of float32) in
//              shared memory and runs the log2(C) butterfly stages there,
//              with __syncthreads() between stages.
//   fwht_cols  H_n1 along the middle axis of a (B, n1, C) array, n1 a power
//              of two <= 4096: the second pass of the Kronecker identity
//              H_{n1*C} = H_{n1} (x) H_C for 1-D lengths above 4096.  A
//              block holds all n1 rows of T adjacent columns (T * n1 <=
//              32768 floats, 128 KB of shared memory), so each row
//              contributes T contiguous floats to the load and no transpose
//              is materialized.
//
// Every stage pairs element i with i + h and writes (a + b, a - b) in
// place: the same operations, in the same order, as the reshape butterfly
// of the plain version, so kernel and plain version agree bit for bit.
// The Kronecker split runs the stages h < C in pass one and h >= C in pass
// two, which is again the order of the direct transform.
//
// Bound on this card.  A transform reads and writes its rows once and does
// log2(C) additions per element: at 4 bytes per float that is far below
// the ~20 float operations per byte where an H100's 67 TFLOP/s float32 rate
// would take over from its 3.35 TB/s memory, so both kernels are bound by
// device-memory bytes.  Each keeps its rows in shared memory between
// stages, so device memory sees one read and one write per element and
// pass; a 1-D length above 4096 costs two passes.
#include <cuda_runtime.h>

#define FWHT_MAX_C 4096
#define FWHT_COLS_SMEM_FLOATS 32768

__global__ void fwht_rows_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, long long R,
                                 int C, int log_c) {
  __shared__ float s[FWHT_MAX_C];
  const int rpb = FWHT_MAX_C / C;            // rows per block
  const long long row0 = (long long)blockIdx.x * rpb;
  const int rows = (int)min((long long)rpb, R - row0);
  const int total = rows * C;
  const float* src = in + row0 * C;
  for (int e = threadIdx.x; e < total; e += blockDim.x) s[e] = src[e];
  __syncthreads();
  const int half = C >> 1;
  const int pairs = rows * half;
  for (int lh = 0; lh < log_c; ++lh) {
    const int h = 1 << lh;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int r = p / half;
      const int q = p - r * half;
      const int i = r * C + ((q >> lh) << (lh + 1)) + (q & (h - 1));
      const float a = s[i];
      const float b = s[i + h];
      s[i] = a + b;
      s[i + h] = a - b;
    }
    __syncthreads();
  }
  float* dst = out + row0 * C;
  for (int e = threadIdx.x; e < total; e += blockDim.x) dst[e] = s[e];
}

__global__ void fwht_cols_kernel(const float* __restrict__ in,
                                 float* __restrict__ out, int n1, int log_n1,
                                 int C, int T) {
  extern __shared__ float s[];                // (n1, T), row-major
  const int tiles = C / T;
  const long long batch = blockIdx.x / tiles;
  const int c0 = (blockIdx.x % tiles) * T;
  const long long base = batch * (long long)n1 * C + c0;
  const int total = n1 * T;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / T;
    s[e] = in[base + (long long)r * C + (e - r * T)];
  }
  __syncthreads();
  const int pairs = (n1 >> 1) * T;
  for (int lh = 0; lh < log_n1; ++lh) {
    const int h = 1 << lh;
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int q = p / T;
      const int c = p - q * T;
      const int i = ((q >> lh) << (lh + 1)) + (q & (h - 1));
      const float a = s[i * T + c];
      const float b = s[(i + h) * T + c];
      s[i * T + c] = a + b;
      s[(i + h) * T + c] = a - b;
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / T;
    out[base + (long long)r * C + (e - r * T)] = s[e];
  }
}

static int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

// in, out: (R, C) float32, C a power of two <= 4096; in == out is allowed.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int fwht_rows(const float* in, float* out, long long R, int C,
                         void* stream) {
  if (R == 0) return 0;
  const int rpb = FWHT_MAX_C / C;
  const long long blocks = (R + rpb - 1) / rpb;
  const int pairs = (rpb * C) / 2;
  const int threads = pairs < 32 ? 32 : (pairs > 256 ? 256 : pairs);
  fwht_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, R, C, ilog2(C));
  return (int)cudaGetLastError();
}

// in, out: (B, n1, C) float32, n1 and C powers of two, n1 <= 4096; the
// transform runs along n1.  in == out is allowed.
extern "C" int fwht_cols(const float* in, float* out, long long B, int n1,
                         int C, void* stream) {
  if (B == 0) return 0;
  int T = FWHT_COLS_SMEM_FLOATS / n1;
  if (T > C) T = C;
  const size_t smem = (size_t)n1 * T * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwht_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = B * (C / T);
  fwht_cols_kernel<<<(unsigned)blocks, 512, smem, (cudaStream_t)stream>>>(
      in, out, n1, ilog2(n1), C, T);
  return (int)cudaGetLastError();
}
