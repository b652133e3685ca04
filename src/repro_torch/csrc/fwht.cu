// Unnormalized fast Walsh-Hadamard transform for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/fwht.py (_fwht_rows_kernel,
// launched by fwht_rows_pallas, and the two-level Kronecker path of
// fwht_pallas): H_C along each row of a contiguous (R, C) float32 matrix,
// C a power of two up to 4096^2.
//
// Bound on this card.  A transform reads and writes each element once and
// does log2(C) additions per element: below 6 float operations per byte,
// far under the ~20 where an H100's 67 TFLOP/s float32 rate would take over
// from its 3.35 TB/s memory.  So the kernels are bound by device-memory
// bytes, and the design keeps every stage out of device memory, keeps
// enough loads in flight, and lets device memory see each element read
// once and written once.
//
// fwht_rows_kernel<log2 C>, C <= 4096: one pass.  A block of 256 threads
// takes 4096 consecutive floats (4096 / C rows; 256 rows when C < 16).
// Each thread loads a run of 16 consecutive floats as four 16-byte loads,
// all issued before the first is used, and runs the stages h = 1 .. 8 in
// registers; then h = 16 .. 256 across the lanes of its warp
// (__shfl_xor_sync, no barrier); then, for C >= 1024, the rows' floats
// pass once through shared memory (padded one float in 32, so neither
// side conflicts on banks) and each thread takes the 2^k floats 512 apart
// that the last k stages pair, runs those stages in registers and stores.
// Every index is a compile-time constant of the template.
//
// fwht_long_kernel<log2 n1, log2 c1>, C = n1 * c1 > 4096: the Kronecker
// identity H_C = H_n1 (x) H_c1 on each row viewed as (n1, c1), in one
// launch.  Pass one is the row pass above on the (n1, c1) rows; pass two
// runs H_n1 down the columns, a tile of all n1 rows by 16384 / n1 columns
// (64 bytes a row at n1 = 1024) held in registers as float4s: the low row
// bits in registers, the next across lanes, the rest after one exchange
// through shared memory (XOR-swizzled so 16-byte accesses do not conflict
// on banks), with no division by a runtime value.  The blocks are
// persistent and take tiles from a ticket counter in this order: the pass
// one tiles of a chunk of rows, then their pass two tiles, then the next
// chunk.  A pass two tile of row r waits until every pass one tile of r
// has signalled done[r]; those tiles hold earlier tickets, taken by
// running blocks that wait on nothing, so the wait always ends.  A chunk
// (chosen by the wrapper) is at most 16 MB, so pass two reads pass one's
// output from the 50 MB L2 cache: the input is loaded with an evict-first
// hint, the intermediate stored normally, the result stored evict-first,
// and device memory sees close to one read and one write per element.
//
// Times (chip_smoke.py, NVIDIA H100 80GB HBM3, power limit 700 W, L2
// flushed before each call): the largest (R, C) group of an lm25m SRHT
// round, (15, 2^22), 0.356 ms against 0.150 ms at the memory rate (the
// earlier shared-memory design with a separate column pass: 1.623 ms); the
// round's ten calls 0.81 ms against 0.30 (earlier 3.38).  Rows of 4096
// alone, (15360, 4096): 0.175 ms of device time against 0.150.  What is left
// of the long-row gap: pass one inside fwht_long_kernel runs 3 blocks an SM,
// and pass two's 64-byte row segments; tools/fwht_profile.py and
// tools/fwht_variants.py measure both (PERF.md).
//
// Order of operations.  Every stage pairs element i with i + h and writes
// (a + b, a - b), stages in ascending h: the operations, in the same order,
// of the plain version's reshape butterfly, so kernel and plain version
// agree bit for bit.  Across lanes, the lower lane computes v + p and the
// upper p - v as fmaf(+-1, v, p), one rounding of the same sum.  There are
// no float atomics; two calls return the same bits.
#include <cuda_runtime.h>

#define FWHT_MAX_C 4096     // longest row of one pass; floats a row tile holds
#define FWHT_THREADS 256    // threads of every block
#define FWHT_ROW_ELEMS 16   // consecutive floats a thread holds in a row pass
#define FWHT_COL_VECS 16    // float4s a thread holds in a column pass (8 when n1 = 8)
#define FWHT_MIN_N1 8       // fewest rows of the (n1, c1) view of a long row

constexpr int ilog2c(int v) { return v <= 1 ? 0 : 1 + ilog2c(v >> 1); }
constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The row pass over rows of length 2^LOG_C.
template <int LOG_C>
struct RowPass {
  static constexpr int LOG_E = cmin(LOG_C, ilog2c(FWHT_ROW_ELEMS));
  static constexpr int E = 1 << LOG_E;               // floats a thread holds
  static constexpr int LOG_T = LOG_C - LOG_E;        // threads a row, log2
  static constexpr int LOG_L = cmin(LOG_T, 5);       // stages across lanes
  static constexpr int LOG_W = LOG_T - LOG_L;        // stages after the exchange
  static constexpr int ELEMS = FWHT_THREADS * E;     // floats a block takes
  static constexpr int RUN = E << LOG_L;             // 512 when LOG_W > 0
  static constexpr int SMEM = LOG_W ? ELEMS + ELEMS / 32 : 1;  // padded floats
};

// The column pass of H_n1, n1 = 2^L1, over a tile of all n1 rows.  A float4
// holds 4 adjacent columns.  Its row bits: [0, RB) in registers, [RB, RB +
// LB) across lanes, [RB + LB, L1) across warps; its column-quad bits: QL
// in the lanes, below the row bits, and QW in the warps, above them.
template <int L1>
struct ColPass {
  static constexpr int RB = cmin(ilog2c(FWHT_COL_VECS), L1);
  static constexpr int V = 1 << RB;                  // float4s a thread holds
  static constexpr int TILE = FWHT_THREADS * 4 * V;  // floats of a tile
  static constexpr int QB = ilog2c(TILE / 4) - L1;   // column quads, log2
  static constexpr int QL = cmin(QB, 5);
  static constexpr int LB = 5 - QL;
  static constexpr int WB = L1 - RB - LB;
  static constexpr int TC = 4 << QB;                 // columns of a tile
  static_assert(QB >= 0 && WB >= 0 && WB <= RB && QB - QL + WB == 3,
                "column tile does not fit the block");
};

template <int E>
__device__ __forceinline__ void load_run(const float* __restrict__ p, float (&v)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const float4 a = __ldcs(reinterpret_cast<const float4*>(p + j));
      v[j] = a.x;
      v[j + 1] = a.y;
      v[j + 2] = a.z;
      v[j + 3] = a.w;
    }
  } else if constexpr (E == 2) {
    const float2 a = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int E>
__device__ __forceinline__ void store_run(float* __restrict__ p, const float (&v)[E]) {
  if constexpr (E >= 4) {
#pragma unroll
    for (int j = 0; j < E; j += 4)
      *reinterpret_cast<float4*>(p + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else if constexpr (E == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// stages h = 2^b, b in [LO, HI), on the index of v
template <int N, int LO, int HI>
__device__ __forceinline__ void reg_stages(float (&v)[N]) {
#pragma unroll
  for (int b = LO; b < HI; ++b) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!(i & (1 << b))) {
        const float a = v[i], c = v[i + (1 << b)];
        v[i] = a + c;
        v[i + (1 << b)] = a - c;
      }
    }
  }
}

template <int N, int HI>
__device__ __forceinline__ void reg_stages4(float4 (&v)[N]) {
#pragma unroll
  for (int b = 0; b < HI; ++b) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (!(i & (1 << b))) {
        const float4 a = v[i], c = v[i + (1 << b)];
        v[i] = make_float4(a.x + c.x, a.y + c.y, a.z + c.z, a.w + c.w);
        v[i + (1 << b)] = make_float4(a.x - c.x, a.y - c.y, a.z - c.z, a.w - c.w);
      }
    }
  }
}

// one stage across lanes: the pair is (this lane, lane ^ mask); sgn is +1
// in the lower lane (v + p) and -1 in the upper (p - v)
__device__ __forceinline__ float lane_step(float v, int mask, float sgn) {
  return fmaf(sgn, v, __shfl_xor_sync(0xffffffffu, v, mask));
}

// The row pass on the block's ELEMS floats from element e0 (whole rows);
// elements at or past e_end are neither read nor written.  s: SMEM floats.
template <int LOG_C>
__device__ __forceinline__ void row_pass(const float* __restrict__ in,
                                         float* __restrict__ out, long long e0,
                                         long long e_end, float* __restrict__ s) {
  using P = RowPass<LOG_C>;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long e = e0 + (long long)tid * P::E;
  float v[P::E];
  if (e < e_end) {
    load_run<P::E>(in + e, v);
  } else {
#pragma unroll
    for (int j = 0; j < P::E; ++j) v[j] = 0.0f;
  }
  reg_stages<P::E, 0, P::LOG_E>(v);
#pragma unroll
  for (int b = 0; b < P::LOG_L; ++b) {
    const float sgn = (lane >> b) & 1 ? -1.0f : 1.0f;
#pragma unroll
    for (int j = 0; j < P::E; ++j) v[j] = lane_step(v[j], 1 << b, sgn);
  }
  if constexpr (P::LOG_W == 0) {
    if (e < e_end) store_run<P::E>(out + e, v);
  } else {
    // element i of the block at s[i + i / 32]: a warp's 32 threads write 16
    // apart and read consecutive floats, each on its own bank
#pragma unroll
    for (int j = 0; j < P::E; ++j) {
      const int i = tid * P::E + j;
      s[i + (i >> 5)] = v[j];
    }
    __syncthreads();
    // thread tid takes the runs p = tid + 256 g of the block's (row, p) pairs,
    // p < RUN, and in each the floats row * C + k * RUN + p, k < 2^LOG_W
    constexpr int W = 1 << P::LOG_W;
    constexpr int G = P::E / W;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int pi = tid + FWHT_THREADS * g;
      const int base = ((pi / P::RUN) << LOG_C) + pi % P::RUN;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const int i = base + k * P::RUN;
        v[g * W + k] = s[i + (i >> 5)];
      }
    }
    reg_stages<P::E, 0, P::LOG_W>(v);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int pi = tid + FWHT_THREADS * g;
      const int base = ((pi / P::RUN) << LOG_C) + pi % P::RUN;
#pragma unroll
      for (int k = 0; k < W; ++k) {
        const long long i = e0 + base + k * P::RUN;
        if (i < e_end) out[i] = v[g * W + k];
      }
    }
  }
}

// float4 slot of the column tile's (row, quad) in shared memory: the
// row-major index with bits 3-5 and 4-6 XORed into bits 0-2, so that the 8
// lanes of each quarter warp, which one 16-byte access serves together, hit
// 8 different 16-byte bank groups on both sides of the exchange, for every
// ColPass layout
template <int QB>
__device__ __forceinline__ int col_slot(int row, int q) {
  const int f = (row << QB) | q;
  return f ^ ((f >> 3) & 7) ^ ((f >> 4) & 7);
}

// The column pass on the tile at element `base` of out (all n1 rows,
// TC columns of the (n1, 2^LOG_C1) view), in place.  s: TILE / 4 float4s.
template <int L1, int LOG_C1>
__device__ __forceinline__ void col_pass(float* __restrict__ out, long long base,
                                         float4* __restrict__ s) {
  using P = ColPass<L1>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = (lane & ((1 << P::QL) - 1)) | ((warp >> P::WB) << P::QL);
  const int rl = lane >> P::QL;                  // row bits RB .. RB + LB - 1
  const int rw = warp & ((1 << P::WB) - 1);      // row bits RB + LB .. L1 - 1
  float* const col = out + base + 4 * q;
  float4 v[P::V];
  const int row0 = (rl << P::RB) | (rw << (P::RB + P::LB));
#pragma unroll
  for (int k = 0; k < P::V; ++k)
    v[k] = __ldcg(reinterpret_cast<const float4*>(col + ((long long)(row0 | k) << LOG_C1)));
  reg_stages4<P::V, P::RB>(v);
#pragma unroll
  for (int b = 0; b < P::LB; ++b) {
    const int mask = 1 << (P::QL + b);
    const float sgn = lane & mask ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < P::V; ++k)
      v[k] = make_float4(lane_step(v[k].x, mask, sgn), lane_step(v[k].y, mask, sgn),
                         lane_step(v[k].z, mask, sgn), lane_step(v[k].w, mask, sgn));
  }
  if constexpr (P::WB == 0) {
#pragma unroll
    for (int k = 0; k < P::V; ++k)
      __stcs(reinterpret_cast<float4*>(col + ((long long)(row0 | k) << LOG_C1)), v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < P::V; ++k) s[col_slot<P::QB>(row0 | k, q)] = v[k];
    __syncthreads();
    // the warp's row bits now name row bits 0 .. WB - 1, and register k
    // holds row bits RB + LB .. L1 - 1 in its low WB bits, WB .. RB - 1 above
    constexpr int WM = (1 << P::WB) - 1;
#pragma unroll
    for (int k = 0; k < P::V; ++k) {
      const int row = rw | ((k >> P::WB) << P::WB) | (rl << P::RB) |
                      ((k & WM) << (P::RB + P::LB));
      v[k] = s[col_slot<P::QB>(row, q)];
    }
    reg_stages4<P::V, P::WB>(v);
#pragma unroll
    for (int k = 0; k < P::V; ++k) {
      const int row = rw | ((k >> P::WB) << P::WB) | (rl << P::RB) |
                      ((k & WM) << (P::RB + P::LB));
      __stcs(reinterpret_cast<float4*>(col + ((long long)row << LOG_C1)), v[k]);
    }
  }
}

template <int LOG_C>
__global__ void __launch_bounds__(FWHT_THREADS)
fwht_rows_kernel(const float* __restrict__ in, float* __restrict__ out, long long total) {
  __shared__ float s[RowPass<LOG_C>::SMEM];
  row_pass<LOG_C>(in, out, (long long)blockIdx.x * RowPass<LOG_C>::ELEMS, total, s);
}

// work: int32 [ticket, done[0 .. R - 1]], zeroed before the launch.  Three
// blocks an SM (80 registers, a few spilled): the (15, 2^22) call took
// 0.3435 ms so, 0.3654 with two (128 registers), 0.3800 with 8 float4s a
// thread at four (tools/fwht_variants.py, NVIDIA H100 80GB HBM3, 700 W).
template <int L1, int LOG_C1>
__global__ void __launch_bounds__(FWHT_THREADS, 3)
fwht_long_kernel(const float* __restrict__ in, float* __restrict__ out, long long R,
                 int chunk, int* __restrict__ work) {
  extern __shared__ float4 smem[];
  __shared__ long long s_ticket;
  constexpr int LOG_N = L1 + LOG_C1;
  constexpr long long P1T = (1LL << LOG_N) / RowPass<LOG_C1>::ELEMS;  // pass one tiles a row
  constexpr long long P2T = (1LL << LOG_N) / ColPass<L1>::TILE;       // pass two tiles a row
  constexpr long long TPR = P1T + P2T;
  int* const ticket = work;
  int* const done = work + 1;
  const long long total = R * TPR;
  const long long per_chunk = (long long)chunk * TPR;
  long long signal = -1;  // the row whose pass one tile this block just stored
  for (;;) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (signal >= 0) {
        __threadfence();
        atomicAdd(done + signal, 1);
      }
      s_ticket = atomicAdd(ticket, 1);
    }
    __syncthreads();
    const long long t = s_ticket;
    if (t >= total) break;
    const long long c = t / per_chunk;
    const long long r0 = c * chunk;
    const long long rows = min((long long)chunk, R - r0);
    long long o = t - c * per_chunk;
    if (o < rows * P1T) {
      const long long r = r0 + o / P1T;
      const long long e0 = (r << LOG_N) + (o % P1T) * RowPass<LOG_C1>::ELEMS;
      row_pass<LOG_C1>(in, out, e0, (r + 1) << LOG_N, reinterpret_cast<float*>(smem));
      signal = r;
    } else {
      o -= rows * P1T;
      const long long r = r0 + o / P2T;
      if (threadIdx.x == 0) {
        volatile int* d = done + r;
        while (*d < P1T) __nanosleep(64);
        __threadfence();
      }
      __syncthreads();
      col_pass<L1, LOG_C1>(out, (r << LOG_N) + (o % P2T) * ColPass<L1>::TC, smem);
      signal = -1;
    }
  }
}

template <int LOG_C>
static int launch_rows(const float* in, float* out, long long R, cudaStream_t st,
                       int* launched) {
  const long long total = R << LOG_C;
  const long long blocks = (total + RowPass<LOG_C>::ELEMS - 1) / RowPass<LOG_C>::ELEMS;
  fwht_rows_kernel<LOG_C><<<(unsigned)blocks, FWHT_THREADS, 0, st>>>(in, out, total);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

template <int L1, int LOG_C1>
static int launch_long(const float* in, float* out, long long R, int chunk, int* work,
                       cudaStream_t st, int* launched) {
  constexpr int smem = cmax(ColPass<L1>::TILE, RowPass<LOG_C1>::SMEM) * sizeof(float);
  constexpr long long TPR = ((1LL << (L1 + LOG_C1)) / RowPass<LOG_C1>::ELEMS) +
                            ((1LL << (L1 + LOG_C1)) / ColPass<L1>::TILE);
  cudaError_t err = cudaFuncSetAttribute(fwht_long_kernel<L1, LOG_C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  static int per_sm = 0;  // blocks an SM holds
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fwht_long_kernel<L1, LOG_C1>,
                                                        FWHT_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaMemsetAsync(work, 0, (R + 1) * sizeof(int), st)) != cudaSuccess) return (int)err;
  ++*launched;
  const long long grid = min(R * TPR, (long long)per_sm * sms);
  fwht_long_kernel<L1, LOG_C1><<<(unsigned)grid, FWHT_THREADS, smem, st>>>(in, out, R, chunk,
                                                                          work);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

#define FWHT_ROWS_CASE(L) \
  case L:                 \
    return launch_rows<L>(in, out, R, st, launched);

// in, out: (R, 2^log_c) float32, log_c <= 12, 16-byte aligned (8 when
// log_c == 1); in == out is allowed.  Adds the launches it enqueued to
// *launched.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int fwht_rows(const float* in, float* out, long long R, int log_c, void* stream,
                         int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0) return 0;
  switch (log_c) {
    FWHT_ROWS_CASE(0) FWHT_ROWS_CASE(1) FWHT_ROWS_CASE(2) FWHT_ROWS_CASE(3)
    FWHT_ROWS_CASE(4) FWHT_ROWS_CASE(5) FWHT_ROWS_CASE(6) FWHT_ROWS_CASE(7)
    FWHT_ROWS_CASE(8) FWHT_ROWS_CASE(9) FWHT_ROWS_CASE(10) FWHT_ROWS_CASE(11)
    FWHT_ROWS_CASE(12)
  }
  return (int)cudaErrorInvalidValue;
}

#define FWHT_LONG_CASE(L1, LC1) \
  if (log_n1 == L1 && log_c1 == LC1) return launch_long<L1, LC1>(in, out, R, chunk, work, st, launched);

// in, out: (R, n1 * c1) float32 viewed as (R, n1, c1), 16-byte aligned:
// H_c1 along c1, then H_n1 along n1, chunk rows at a time, in one launch
// (after a memset of work).  (log_n1, log_c1): (3, 10 .. 12) or (4 .. 12,
// 12), as kernels/fwht.py::split gives them.  work: R + 1 int32.  in ==
// out is allowed.  Adds the launches it enqueued to *launched.
extern "C" int fwht_long(const float* in, float* out, long long R, int log_n1, int log_c1,
                         int chunk, int* work, void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  if (R <= 0) return 0;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  FWHT_LONG_CASE(3, 10) FWHT_LONG_CASE(3, 11) FWHT_LONG_CASE(3, 12)
  FWHT_LONG_CASE(4, 12) FWHT_LONG_CASE(5, 12) FWHT_LONG_CASE(6, 12)
  FWHT_LONG_CASE(7, 12) FWHT_LONG_CASE(8, 12) FWHT_LONG_CASE(9, 12)
  FWHT_LONG_CASE(10, 12) FWHT_LONG_CASE(11, 12) FWHT_LONG_CASE(12, 12)
  return (int)cudaErrorInvalidValue;
}
