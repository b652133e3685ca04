// Batched count-sketch segment sum for Hopper (sm_90a).
//
//   out[g, j] = sum over i with h[i] == j of x[g, i]      (g < G, j < b)
//
// Replaces the Pallas kernel src/repro/kernels/countsketch.py
// (_countsketch_kernel, launched by countsketch_clients_pallas).  That
// kernel builds a (TILE_N, b_block) one-hot matrix and runs it through the
// MXU, because the TPU has no fast scatter: n * b multiply-adds.  Hopper
// scatters at memory speed, so this route keeps the function and drops the
// method.  An h outside [0, b) matches no slot and is dropped, as the
// one-hot compare drops it.
//
// Design: bucketing by windows of slots.  The hash h is shared by all G
// rows (one sketch operator per round).  Slots are grouped into windows of
// W = 2^shift slots, chosen by the wrapper (kernels/countsketch.py::route).
// Each index becomes a 32-byte record {i, h[i], x[g0 .. g0 + 5, i]} (one
// sector) in its window's range [off[win], off[win + 1]) of a scratch
// buffer; G > 6 runs placement and reduce once per chunk of 6 rows.  The
// stages: a histogram of the windows (integer atomics), off = its
// exclusive scan (CUB block scans), the placement, the reduce.
//
// Small n (below the wrapper's COARSE_MIN_N, or b > n; the SRHT desk
// scatter, whose b >> n gives windows of ~16 indices, so the work grows
// with n and not with b): one cooperative launch, cs_small, runs every
// stage, its blocks meeting at a grid barrier between them, because there
// the host's cost per launch, not the card, set the time.  One thread per
// index places its record at off[win] + atomicAdd(cursor[win]).
//
// Large n >= b (the uplink): a record scattered alone costs an L2 request
// per half and, over a 4 GB buffer, a DRAM row activation (on an H100, 32-byte
// records scattered over 4.2 GB took 18 ms, over 128 KB ranges 6.8 ms, a
// coalesced copy 3.6 ms).  So the records move in two coalesced passes of
// cs_group: into <= 512 coarse buckets of 2^cshift windows, each block
// staging 2048 records in shared memory (two blocks an SM, so one block's
// loads overlap another's stores) and writing each bucket's run with one
// atomic reservation; then, reading the buckets in order, into the windows,
// which are wide (32 slots, ~1,600 records at the bert_100m uplink) so a
// tile again falls into <= 1024 runs.  The histogram counts in shared
// memory, a block per SM.
//
// Reduce.  Narrow windows (<= CS_CAP records): a warp per window loads the
// records, ranks each by its key (slot, i) among the window's keys, puts
// the values in shared memory in that order, and one lane per row sums each
// slot's run from 0.0f in ascending i.  Wide windows (<= CS_BIG_CAP
// records): a block per window copies the records into shared memory and
// groups them by slot (a counting sort of their positions and keys); a
// warp per slot and chunk of CS_CAP records ranks the chunk the same way
// against the slot's keys, so the warps share a long slot, and a thread
// per (slot, row) sums each slot in that order.  Longer
// windows (a skewed hash, or b small against n) are listed: a block per
// tile of 256 records ranks them against the whole window, O(m^2) compares
// for m records, and the block that ranks a window's last tile sums it in
// that order.  Every slot of out is written, 0 where no index falls.
//
// Fixed summation order.  The cursors make the placement order depend on
// the run, but the sum does not: every path sums each slot from 0.0f over
// its indices in ascending i, the same order as a sequential left-to-right
// loop.  Two calls on the same inputs return the same bits.  There are no
// float atomics; the integer atomics (counts, cursors, reservations, the
// list of long windows, the barrier) give results that do not depend on
// their order.
//
// Bound on this card.  The function must read x (G * n floats) and h
// (n ints) once and write out (G * b floats): it is bound by device-memory
// bytes (3.35 TB/s on an H100 SXM); the G * n additions are negligible.
// This route moves more: h twice, x once, and each record written and read
// once, twice more on the large-n route (32 bytes each way per index).  At
// the bert_100m uplink (G = 5, n = 132,008,448, b = 2,640,275) that is
// ~20.5 GB (~6.1 ms at 3.35 TB/s) against the 3.2 GB (0.96 ms) of the
// bound.
#include <cuda_runtime.h>

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <type_traits>

#define CS_ROWS 6          // rows of x carried by one record
#define CS_CAP 128         // longest window (or slot) a warp ranks
#define CS_LANE_RECS (CS_CAP / 32)
#define CS_WARPS 8         // warps in a block of cs_small
#define CS_THREADS (CS_WARPS * 32)
#define CS_TILE CS_THREADS // records a block of the long phase ranks at once
#define CS_SCAN 1024       // counts per block of cs_scan
#define CS_SMALL_ITEMS 16  // counts per thread of cs_small's scan tiles
#define CS_SMALL_TILE (CS_THREADS * CS_SMALL_ITEMS)
#define CS_HIST_BINS 49152 // windows a block of cs_histogram_smem counts at once
#define CS_BUCKETS 1024    // most buckets of a cs_group tile
#define CS_GROUP_THREADS 512  // threads in a block of cs_group (2 blocks an SM)
#define CS_PART_ITEMS 4    // records per thread of cs_group
#define CS_PART_TILE (CS_GROUP_THREADS * CS_PART_ITEMS)
#define CS_BIG_THREADS 512 // threads in a block of cs_reduce_big
#define CS_BIG_CAP 2048    // most records of a window cs_reduce_big holds
#define CS_BIG_SLOTS 256   // most slots of a window cs_reduce_big takes
// Most windows of the large-n route: coarse_shift makes at most
// CS_BUCKETS / 2 coarse buckets, so each holds at most CS_MAX_WINDOWS /
// (CS_BUCKETS / 2) windows and a fine tile's two buckets at most
// CS_BUCKETS.  The wrapper (kernels/countsketch.py) reads these limits
// from this file.
#define CS_MAX_WINDOWS 262144
static_assert(CS_MAX_WINDOWS == (CS_BUCKETS / 2) * (CS_BUCKETS / 2),
              "a fine tile's two coarse buckets fit its CS_BUCKETS counters");

__device__ __forceinline__ long long load_h(const void* h, int h64,
                                            long long i) {
  return h64 ? __ldg((const long long*)h + i) : (long long)__ldg((const int*)h + i);
}

// the sort key of a record: (slot, i) when a window holds several slots,
// i alone when it holds one
template <bool WIDE>
using Key = typename std::conditional<WIDE, unsigned long long, unsigned>::type;
template <bool WIDE>
using KeyVec = typename std::conditional<WIDE, ulonglong2, uint4>::type;

template <bool WIDE>
__device__ __forceinline__ Key<WIDE> key_of(int i, int slot) {
  if constexpr (WIDE) {
    return ((unsigned long long)(unsigned)slot << 32) | (unsigned)i;
  } else {
    return (unsigned)i;
  }
}

// how many of the keys in v are below k
__device__ __forceinline__ int below(const uint4& v, unsigned k) {
  return (v.x < k) + (v.y < k) + (v.z < k) + (v.w < k);
}
__device__ __forceinline__ int below(const ulonglong2& v, unsigned long long k) {
  return (v.x < k) + (v.y < k);
}

// rank[q] += how many of the `loads` 16-byte groups of keys at kv lie below
// key[q], for the first NQ keys of a lane
template <int NQ, class Vec, class K>
__device__ __forceinline__ void count_below(const Vec* kv, int loads,
                                            const K (&key)[CS_LANE_RECS],
                                            int (&rank)[CS_LANE_RECS]) {
  for (int t = 0; t < loads; ++t) {
    const Vec v = kv[t];
#pragma unroll
    for (int q = 0; q < NQ; ++q) rank[q] += below(v, key[q]);
  }
}

// the same for the lane's first nq keys (nq uniform across the warp), with
// no compare issued for the others
template <class Vec, class K>
__device__ __forceinline__ void rank_keys(const Vec* kv, int loads, int nq,
                                          const K (&key)[CS_LANE_RECS],
                                          int (&rank)[CS_LANE_RECS]) {
  static_assert(CS_LANE_RECS == 4, "one case per count of keys");
  switch (nq) {
    case 1: count_below<1>(kv, loads, key, rank); break;
    case 2: count_below<2>(kv, loads, key, rank); break;
    case 3: count_below<3>(kv, loads, key, rank); break;
    default: count_below<4>(kv, loads, key, rank); break;
  }
}

// ---------------------------------------------------------------------------
// the scratch: one int32 buffer, laid out here for every entry point.  Data
// one phase writes and another reads is loaded with __ldcg (from L2): in
// cs_small the phases share one launch, and L1 is not coherent.
// ---------------------------------------------------------------------------

struct Work {
  long long rec, part, order, longs;  // records; coarse records; long windows
  long long count, off, tiles, bar;   // zeroed before the first stage
  long long cursor, nlong, gcur;      // and zeroed again for each later chunk
  long long ldone;                    // each long window's ranked tiles
  long long ints;                     // the buffer's size
};

static Work layout(long long n, long long nbins, int coarse) {
  Work w;
  long long p = 0;
  // every array starts on 16 bytes
  auto at = [&p](long long ints) { const long long a = (p + 3) & ~3LL; p = a + ints; return a; };
  w.rec = at(8 * n);                  // first: records start on a sector
  w.part = at(coarse ? 8 * n : 0);
  w.order = at(n);
  w.longs = at(n / (CS_CAP + 1) + 1);
  w.count = at(nbins);
  w.off = at(nbins + 1);
  w.tiles = at((nbins + CS_SCAN - 1) / CS_SCAN);
  w.bar = at(2);
  w.cursor = at(nbins);
  w.nlong = at(1);
  w.gcur = at(CS_BUCKETS);
  w.ldone = at(n / (CS_CAP + 1) + 1);
  w.ints = p;
  return w;
}

// pointers into the scratch, as the kernels take them
struct Ptrs {
  int4* rec;
  int* count;
  int* off;
  int* tiles;
  unsigned* bar;
  int* cursor;
  int* nlong;
  int* longs;
  int* order;
  int* ldone;
  long long reset_ints;  // from cursor to the end
};

static Ptrs pointers(int* work, const Work& w) {
  return Ptrs{(int4*)(work + w.rec), work + w.count, work + w.off, work + w.tiles,
              (unsigned*)(work + w.bar), work + w.cursor, work + w.nlong,
              work + w.longs, work + w.order, work + w.ldone, w.ints - w.cursor};
}

// windows per coarse bucket: 2^cshift, so that at most CS_BUCKETS / 2
// buckets (the coarse pass's tile takes them all; at the bert_100m uplink
// 323 buckets of 256 windows, so a fine tile's two buckets hold 512)
static int coarse_shift(long long nbins) {
  int s = 0;
  while (((nbins - 1) >> s) >= CS_BUCKETS / 2) ++s;
  return s;
}

// All blocks of a cooperative launch wait here.  bar[0] counts arrivals,
// bar[1] is the generation; both start at 0.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1) == gridDim.x - 1) {
      atomicExch(bar, 0);
      __threadfence();
      atomicAdd(bar + 1, 1);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// out[g0 .. g0 + rows - 1, slot0 .. slot0 + nslots - 1] = 0, by `threads`
// threads numbered t
__device__ __forceinline__ void zero_window(float* __restrict__ out, long long b,
                                            int g0, int rows, long long slot0,
                                            int nslots, int t, int threads) {
  for (int r = 0; r < rows; ++r) {
    float* o = out + (long long)(g0 + r) * b + slot0;
    if ((reinterpret_cast<size_t>(o) & 15) == 0 && (nslots & 3) == 0) {
      for (int s = 4 * t; s < nslots; s += 4 * threads)
        *reinterpret_cast<float4*>(o + s) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
      for (int s = t; s < nslots; s += threads) o[s] = 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// stages 1-2: histogram and scan
// ---------------------------------------------------------------------------

__device__ __forceinline__ void count_index(const void* __restrict__ h, int h64,
                                            long long i, long long b, int shift,
                                            int* __restrict__ count) {
  const long long hv = load_h(h, h64, i);
  if (hv >= 0 && hv < b) atomicAdd(count + (hv >> shift), 1);
}

// count[h[i] >> shift] += 1 for large n (at most COARSE_WINDOWS windows):
// a block per SM counts its stripe of h in shared memory, CS_HIST_BINS
// windows a pass, then adds each nonzero count with one atomic.
__global__ void __launch_bounds__(CS_SCAN)
cs_histogram_smem_kernel(const void* __restrict__ h, int h64, long long n,
                         long long b, int shift, long long nbins,
                         int* __restrict__ count) {
  extern __shared__ int sc[];
  const int tid = threadIdx.x;
  const long long per = ((n + gridDim.x - 1) / gridDim.x + 15) & ~15LL;
  const long long i0 = blockIdx.x * per, i1 = min(n, i0 + per);
  const int* h32 = static_cast<const int*>(h);
  for (long long lo = 0; lo < nbins; lo += CS_HIST_BINS) {
    const int nb = (int)min((long long)CS_HIST_BINS, nbins - lo);
    for (int j = tid; j < nb; j += CS_SCAN) sc[j] = 0;
    __syncthreads();
    auto add = [&](long long hv) {
      if (hv < 0 || hv >= b) return;
      const long long bin = (hv >> shift) - lo;
      if (bin >= 0 && bin < nb) atomicAdd(sc + bin, 1);
    };
#pragma unroll 4
    for (long long i = i0 + 4LL * tid; i < i1; i += 4LL * CS_SCAN) {
      if (!h64 && i + 4 <= i1) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(h32 + i));
        add(v.x);
        add(v.y);
        add(v.z);
        add(v.w);
      } else {
        for (long long k = i; k < min(i + 4, i1); ++k) add(load_h(h, h64, k));
      }
    }
    __syncthreads();
    for (int j = tid; j < nb; j += CS_SCAN)
      if (sc[j]) atomicAdd(count + lo + j, sc[j]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(CS_SCAN)
cs_tile_sums_kernel(const int* __restrict__ count, long long nbins,
                    int* __restrict__ tiles) {
  typedef cub::BlockReduce<int, CS_SCAN> Reduce;
  __shared__ typename Reduce::TempStorage tmp;
  const long long j = (long long)blockIdx.x * CS_SCAN + threadIdx.x;
  const int total = Reduce(tmp).Sum(j < nbins ? count[j] : 0);
  if (threadIdx.x == 0) tiles[blockIdx.x] = total;
}

// one block: the exclusive scan of the tile sums, in place
__global__ void __launch_bounds__(CS_SCAN)
cs_tile_prefix_kernel(int* __restrict__ tiles, long long ntiles) {
  typedef cub::BlockScan<int, CS_SCAN> Scan;
  __shared__ typename Scan::TempStorage tmp;
  int carry = 0;
  for (long long c0 = 0; c0 < ntiles; c0 += CS_SCAN) {
    const long long j = c0 + threadIdx.x;
    int ex, total;
    Scan(tmp).ExclusiveSum(j < ntiles ? tiles[j] : 0, ex, total);
    if (j < ntiles) tiles[j] = carry + ex;
    carry += total;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(CS_SCAN)
cs_offsets_kernel(const int* __restrict__ count, long long nbins,
                  const int* __restrict__ tiles, int* __restrict__ off) {
  typedef cub::BlockScan<int, CS_SCAN> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const long long j = (long long)blockIdx.x * CS_SCAN + threadIdx.x;
  int inc;
  Scan(tmp).InclusiveSum(j < nbins ? count[j] : 0, inc);
  if (j < nbins) off[j + 1] = tiles[blockIdx.x] + inc;
}

// ---------------------------------------------------------------------------
// stage 3: placement
// ---------------------------------------------------------------------------

__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          long long n, long long i, int g0,
                                          int rows, float (&v)[CS_ROWS]) {
#pragma unroll
  for (int r = 0; r < CS_ROWS; ++r)
    v[r] = r < rows ? __ldg(x + (long long)(g0 + r) * n + i) : 0.0f;
}

__device__ __forceinline__ void store_record(int4* __restrict__ rec, long long pos,
                                             int i, int hv, const float (&v)[CS_ROWS]) {
  rec[2 * pos] = make_int4(i, hv, __float_as_int(v[0]), __float_as_int(v[1]));
  rec[2 * pos + 1] = make_int4(__float_as_int(v[2]), __float_as_int(v[3]),
                               __float_as_int(v[4]), __float_as_int(v[5]));
}

// index i's record straight into its window (small n)
__device__ __forceinline__ void place_index(const float* __restrict__ x,
                                            const void* __restrict__ h, int h64,
                                            long long n, long long b, int shift,
                                            int g0, int rows, const Ptrs& p,
                                            long long i) {
  const long long hv = load_h(h, h64, i);
  if (hv < 0 || hv >= b) return;
  const long long win = hv >> shift;
  const long long pos = __ldcg(p.off + win) + atomicAdd(p.cursor + win, 1);
  float v[CS_ROWS];
  load_rows(x, n, i, g0, rows, v);
  store_record(p.rec, pos, (int)i, (int)hv, v);
}

// Large n: a block takes a tile of CS_PART_TILE records into shared memory
// in arrival order, counts them by bucket (bucket = h >> bsh), reserves
// each bucket's run with one atomic on cur[bucket] and writes the runs
// contiguously, at off[bucket << oshift] + the reserved place.  FROM_X
// builds the records of the tile's indices from x and h (the coarse pass:
// buckets of 2^cshift windows, fewer than CS_BUCKETS / 2); otherwise it
// reads the coarse records `src` in order (the fine pass: buckets are
// windows).  There a tile's windows lie in the coarse buckets of its first
// and last records; a tile whose coarse buckets hold more than CS_BUCKETS
// windows places record by record.
template <bool FROM_X>
__global__ void __launch_bounds__(CS_GROUP_THREADS)
cs_group_kernel(const float* __restrict__ x, const void* __restrict__ h,
                int h64, long long n, long long b, int g0, int rows,
                const int4* __restrict__ src, int bsh, int oshift, int cshift,
                const int* __restrict__ off, long long nbins,
                int* __restrict__ cur, int4* __restrict__ dst) {
  extern __shared__ int4 stage[];  // 2 * CS_PART_TILE, destinations, order
  int* dest = reinterpret_cast<int*>(stage + 2 * CS_PART_TILE);
  unsigned short* from = reinterpret_cast<unsigned short*>(dest + CS_PART_TILE);
  __shared__ int cnt[CS_BUCKETS], loff[CS_BUCKETS];
  __shared__ long long base[CS_BUCKETS];
  constexpr int PER = CS_BUCKETS / CS_GROUP_THREADS;  // buckets a thread scans
  typedef cub::BlockScan<int, CS_GROUP_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const int tid = threadIdx.x;
  const long long t0 = (long long)blockIdx.x * CS_PART_TILE;
  long long tend = min(n, t0 + CS_PART_TILE);
  int lo = 0;
  if constexpr (!FROM_X) {
    tend = min((long long)off[nbins], tend);
    if (t0 >= tend) return;
    lo = (src[2 * t0].y >> (bsh + cshift)) << cshift;
    const int hi = ((src[2 * (tend - 1)].y >> (bsh + cshift)) + 1) << cshift;
    if (hi - lo > CS_BUCKETS) {
      for (long long p = t0 + tid; p < tend; p += CS_GROUP_THREADS) {
        const int4 a = src[2 * p];
        const int bid = a.y >> bsh;
        const long long pos = off[(long long)bid << oshift] + atomicAdd(cur + bid, 1);
        dst[2 * pos] = a;
        dst[2 * pos + 1] = src[2 * p + 1];
      }
      return;
    }
  }
  for (int c = tid; c < CS_BUCKETS; c += CS_GROUP_THREADS) cnt[c] = 0;
  __syncthreads();
  int bk[CS_PART_ITEMS], rank[CS_PART_ITEMS];
#pragma unroll
  for (int k = 0; k < CS_PART_ITEMS; ++k) {
    const int a = k * CS_GROUP_THREADS + tid;  // arrival place in the tile
    const long long p = t0 + a;
    bk[k] = -1;
    if (p >= tend) continue;
    int hv;
    if constexpr (FROM_X) {
      const long long hl = load_h(h, h64, p);
      if (hl < 0 || hl >= b) continue;
      hv = (int)hl;
      float v[CS_ROWS];
      load_rows(x, n, p, g0, rows, v);
      store_record(stage, a, (int)p, hv, v);
    } else {
      const int4 r = src[2 * p];
      stage[2 * a] = r;
      stage[2 * a + 1] = src[2 * p + 1];
      hv = r.y;
    }
    bk[k] = (hv >> bsh) - lo;
    rank[k] = atomicAdd(cnt + bk[k], 1);
  }
  __syncthreads();
  int mine[PER], ex[PER], total;
#pragma unroll
  for (int j = 0; j < PER; ++j) mine[j] = cnt[PER * tid + j];
  Scan(tmp).ExclusiveSum(mine, ex, total);
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = PER * tid + j;
    loff[c] = ex[j];
    if (mine[j])
      base[c] = off[(long long)(c + lo) << oshift] + atomicAdd(cur + c + lo, mine[j]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < CS_PART_ITEMS; ++k) {
    if (bk[k] < 0) continue;
    const int s = loff[bk[k]] + rank[k];
    from[s] = (unsigned short)(k * CS_GROUP_THREADS + tid);
    dest[s] = (int)(base[bk[k]] + rank[k]);
  }
  __syncthreads();
  // 16 bytes a thread, neighbours on neighbouring halves: whole sectors
  for (int q = tid; q < 2 * total; q += CS_GROUP_THREADS) {
    const int s = q >> 1, half = q & 1;
    dst[2 * (long long)dest[s] + half] = stage[2 * from[s] + half];
  }
}

// ---------------------------------------------------------------------------
// stage 4: reduce
// ---------------------------------------------------------------------------

// a warp's shared memory for one window
template <bool WIDE>
struct __align__(16) WarpSmem {
  float vals[CS_ROWS][CS_CAP + 4];  // +4: rows 16-byte aligned, on other banks
  Key<WIDE> keys[CS_CAP];
  int slots[WIDE ? CS_CAP : 1];
};

// A warp sums window w (at most CS_CAP records) into out; a longer window
// is zeroed and listed in longs[0 .. *nlong).
template <bool WIDE>
__device__ void reduce_window(long long w, const Ptrs& p, long long b, int shift,
                              int g0, int rows, float* __restrict__ out,
                              WarpSmem<WIDE>& sm, int lane) {
  constexpr int V = 16 / sizeof(Key<WIDE>);  // keys per 16-byte load
  const int start = __ldcg(p.off + w), m = __ldcg(p.off + w + 1) - start;
  const long long slot0 = w << shift;
  const int nslots = (int)min((long long)1 << shift, b - slot0);
  if (WIDE || m == 0 || m > CS_CAP) zero_window(out, b, g0, rows, slot0, nslots, lane, 32);
  if (m == 0) return;
  if (m > CS_CAP) {
    if (lane == 0) p.longs[atomicAdd(p.nlong, 1)] = (int)w;
    return;
  }
  const int mv = (m + V - 1) / V;
  int4 ra[CS_LANE_RECS], rb[CS_LANE_RECS];
  Key<WIDE> key[CS_LANE_RECS] = {};
#pragma unroll
  for (int q = 0; q < CS_LANE_RECS; ++q) {
    const int e = q * 32 + lane;
    if (e < m) {
      ra[q] = __ldcg(p.rec + 2 * ((long long)start + e));
      rb[q] = __ldcg(p.rec + 2 * ((long long)start + e) + 1);
      key[q] = key_of<WIDE>(ra[q].x, ra[q].y);
      sm.keys[e] = key[q];
    } else if (e < mv * V) {
      sm.keys[e] = ~Key<WIDE>(0);  // above every key: ranks nothing
    }
  }
  __syncwarp();
  int rank[CS_LANE_RECS] = {};
  rank_keys(reinterpret_cast<const KeyVec<WIDE>*>(sm.keys), mv, (m + 31) >> 5,
            key, rank);
#pragma unroll
  for (int q = 0; q < CS_LANE_RECS; ++q) {
    if (q * 32 + lane < m) {
      const int r = rank[q];
      if constexpr (WIDE) sm.slots[r] = ra[q].y;
      sm.vals[0][r] = __int_as_float(ra[q].z);
      sm.vals[1][r] = __int_as_float(ra[q].w);
      sm.vals[2][r] = __int_as_float(rb[q].x);
      sm.vals[3][r] = __int_as_float(rb[q].y);
      sm.vals[4][r] = __int_as_float(rb[q].z);
      sm.vals[5][r] = __int_as_float(rb[q].w);
    }
  }
  __syncwarp();
  if (lane < rows) {
    float* o = out + (long long)(g0 + lane) * b;
    const float* v = sm.vals[lane];
    float acc = 0.0f;
    if constexpr (!WIDE) {  // one slot: w; sum in order, four at a time
      int k = 0;
      for (; k + 4 <= m; k += 4) {
        const float4 f = *reinterpret_cast<const float4*>(v + k);
        acc = (((acc + f.x) + f.y) + f.z) + f.w;
      }
      for (; k < m; ++k) acc += v[k];
      o[w] = acc;
    } else {
      int cur = sm.slots[0];
      for (int k = 0; k < m; ++k) {
        const int s = sm.slots[k];
        if (s != cur) {
          o[cur] = acc;
          acc = 0.0f;
          cur = s;
        }
        acc += v[k];
      }
      o[cur] = acc;
    }
  }
  __syncwarp();  // the warp's next window reuses sm
}

// A block per window of up to CS_BIG_CAP records and CS_BIG_SLOTS slots
// (the wide windows of the large-n route): the window's records are copied
// into shared memory (coalesced) and their positions and keys i grouped by
// slot (a counting sort); then a warp per (slot, chunk of CS_CAP records)
// ranks the chunk by i against the slot's keys, so a long slot is ranked
// by several warps at once, and a thread per (slot, row) sums each slot in
// that order.  A window with more records is zeroed and listed.
__global__ void __launch_bounds__(CS_BIG_THREADS)
cs_reduce_big_kernel(Ptrs p, long long b, int shift, int g0, int rows,
                     float* __restrict__ out) {
  constexpr int WARPS = CS_BIG_THREADS / 32;
  constexpr int PER = CS_BIG_CAP / CS_BIG_THREADS;  // records a thread copies
  static_assert(CS_BIG_SLOTS <= CS_BIG_THREADS, "a thread per slot in the scan");
  extern __shared__ int4 srec[];  // 2 * CS_BIG_CAP: the window's records
  __shared__ int sord[CS_BIG_CAP];  // positions grouped by slot
  __shared__ unsigned short srank[CS_BIG_CAP];
  __shared__ int scnt[CS_BIG_SLOTS], sbase[CS_BIG_SLOTS];
  // the keys grouped by slot: slot s from kbase(s), a multiple of 4, padded
  // with ~0u to the next one
  __shared__ __align__(16) unsigned skeys[CS_BIG_CAP + 4 * CS_BIG_SLOTS + 4];
  auto kbase = [&](int s) { return 4 * ((sbase[s] >> 2) + s); };
  // the work items of the rank: slot << 4 | chunk of CS_CAP records
  static_assert(CS_BIG_CAP / CS_CAP <= 16 && CS_BIG_SLOTS <= 4096, "an item fits 16 bits");
  __shared__ unsigned short sitem[CS_BIG_CAP / CS_CAP + CS_BIG_SLOTS];
  __shared__ int ssorted[CS_BIG_CAP];  // positions in (slot, i) order
  typedef cub::BlockScan<int, CS_BIG_THREADS> Scan;
  __shared__ typename Scan::TempStorage tmp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long w = blockIdx.x;
  const int start = p.off[w], m = p.off[w + 1] - start;
  const long long slot0 = w << shift;
  const int nslots = (int)min((long long)1 << shift, b - slot0);
  if (m == 0 || m > CS_BIG_CAP) {
    zero_window(out, b, g0, rows, slot0, nslots, tid, CS_BIG_THREADS);
    if (m > 0 && tid == 0) p.longs[atomicAdd(p.nlong, 1)] = (int)w;
    return;
  }
  for (int s = tid; s < nslots; s += CS_BIG_THREADS) scnt[s] = 0;
  __syncthreads();
  const int4* src = p.rec + 2 * (long long)start;
  int4 a[PER], a2[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {  // every load in flight before the atomics
    const int r = k * CS_BIG_THREADS + tid;
    if (r < m) a[k] = src[2 * r], a2[k] = src[2 * r + 1];
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int r = k * CS_BIG_THREADS + tid;
    const unsigned live = __ballot_sync(0xffffffffu, r < m);
    if (r < m) {
      srec[2 * r] = a[k];
      srec[2 * r + 1] = a2[k];
      // one atomic per slot per warp: lanes of one slot take consecutive ranks
      const int s = (int)(a[k].y - slot0);
      const unsigned peers = __match_any_sync(live, s);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(scnt + s, __popc(peers));
      base = __shfl_sync(peers, base, leader);
      srank[r] = (unsigned short)(base + __popc(peers & ((1u << lane) - 1)));
    }
  }
  __syncthreads();
  // one scan for the slots' starts (low 16 bits) and their items
  const int c = tid < nslots ? scnt[tid] : 0, chunks = (c + CS_CAP - 1) / CS_CAP;
  int ex, total;
  Scan(tmp).ExclusiveSum(c | chunks << 16, ex, total);
  const int nitems = total >> 16;
  if (tid < nslots) {
    sbase[tid] = ex & 0xffff;
    for (int k = 0; k < chunks; ++k) sitem[(ex >> 16) + k] = (unsigned short)(tid << 4 | k);
  }
  __syncthreads();
  if (tid < nslots)
    for (int e = c; e < ((c + 3) & ~3); ++e) skeys[kbase(tid) + e] = ~0u;  // ranks nothing
  for (int r = tid; r < m; r += CS_BIG_THREADS) {
    const int4 q = srec[2 * r];
    const int s = q.y - (int)slot0, e = srank[r];
    sord[sbase[s] + e] = r;
    skeys[kbase(s) + e] = (unsigned)q.x;
  }
  __syncthreads();
  // the items dealt to the warps in turn
  for (int it = wid; it < nitems; it += WARPS) {
    const int s = sitem[it] >> 4, c0 = (sitem[it] & 15) * CS_CAP, cs = scnt[s];
    const unsigned* keys = skeys + kbase(s);
    const int* ord = sord + sbase[s];
    int r[CS_LANE_RECS];
    unsigned key[CS_LANE_RECS] = {};
#pragma unroll
    for (int q = 0; q < CS_LANE_RECS; ++q) {
      const int e = c0 + q * 32 + lane;
      if (e < cs) key[q] = keys[e], r[q] = ord[e];
    }
    int rank[CS_LANE_RECS] = {};
    rank_keys(reinterpret_cast<const uint4*>(keys), (cs + 3) >> 2,
              min(CS_LANE_RECS, (cs - c0 + 31) >> 5), key, rank);
#pragma unroll
    for (int q = 0; q < CS_LANE_RECS; ++q)
      if (c0 + q * 32 + lane < cs) ssorted[sbase[s] + rank[q]] = r[q];
  }
  __syncthreads();
  // a thread per (slot, row) sums the slot in order; the loads of 8 run
  // ahead of the adds
  const float* vals = reinterpret_cast<const float*>(srec) + 2;
  for (int t = tid; t < nslots * rows; t += CS_BIG_THREADS) {
    const int s = t / rows, g = t - s * rows;
    const int* ws = ssorted + sbase[s];
    const int cs = scnt[s];
    float acc = 0.0f;
    int k = 0;
    for (; k + 8 <= cs; k += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = vals[8 * ws[k + u] + g];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; k < cs; ++k) acc += vals[8 * ws[k] + g];
    out[(long long)(g0 + g) * b + slot0 + s] = acc;
  }
}

// The long windows, by a block of CS_TILE threads: blocks take their tiles
// of CS_TILE records in turn and rank each record against the whole window
// by its key, writing order[off[w] + rank] = its position; the block that
// ranks a window's last tile then sums the window in that order, one thread
// per row, as the warp path does.
template <bool WIDE>
__device__ void long_windows(const Ptrs& p, long long b, int g0, int rows,
                             float* __restrict__ out, Key<WIDE>* tile, int& last) {
  const int nl = __ldcg(p.nlong);
  long long item = 0;
  for (int e = 0; e < nl; ++e) {
    const int w = __ldcg(p.longs + e);
    const int start = __ldcg(p.off + w), m = __ldcg(p.off + w + 1) - start;
    const int tiles = (m + CS_TILE - 1) / CS_TILE;
    for (int t0 = 0; t0 < m; t0 += CS_TILE, ++item) {
      if (item % gridDim.x != blockIdx.x) continue;  // the same for the block
      const int q = t0 + threadIdx.x;
      Key<WIDE> mine = 0;
      if (q < m) {
        const int4 r = __ldcg(p.rec + 2 * ((long long)start + q));
        mine = key_of<WIDE>(r.x, r.y);
      }
      int rank = 0;
      for (int c0 = 0; c0 < m; c0 += CS_TILE) {
        __syncthreads();
        if (c0 + (int)threadIdx.x < m) {
          const int4 r = __ldcg(p.rec + 2 * ((long long)start + c0 + threadIdx.x));
          tile[threadIdx.x] = key_of<WIDE>(r.x, r.y);
        }
        __syncthreads();
        const int len = min(CS_TILE, m - c0);
        for (int s = 0; s < len; ++s) rank += tile[s] < mine;
      }
      if (q < m) p.order[start + rank] = start + q;
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) last = atomicAdd(p.ldone + e, 1) == tiles - 1;
      __syncthreads();
      if (!last || (int)threadIdx.x >= rows) continue;
      __threadfence();
      float* o = out + (long long)(g0 + threadIdx.x) * b;
      int cur = -1;
      float acc = 0.0f;
      for (int k = 0; k < m; ++k) {
        const int4* r = p.rec + 2 * (long long)__ldcg(p.order + start + k);
        const int s = __ldcg(r).y;
        if (s != cur) {
          if (cur >= 0) o[cur] = acc;
          acc = 0.0f;
          cur = s;
        }
        acc += __ldcg(reinterpret_cast<const float*>(r) + 2 + threadIdx.x);
      }
      if (cur >= 0) o[cur] = acc;
    }
  }
}

template <bool WIDE>
__global__ void __launch_bounds__(CS_TILE)
cs_long_kernel(Ptrs p, long long b, int g0, int rows, float* __restrict__ out) {
  __shared__ Key<WIDE> tile[CS_TILE];
  __shared__ int last;
  long_windows<WIDE>(p, b, g0, rows, out, tile, last);
}

// ---------------------------------------------------------------------------
// small n: every stage in one cooperative launch
// ---------------------------------------------------------------------------

// stamps, when not null, gets the global timer (ns) at the start, after
// the histogram, after the scan, and after each chunk's placement and
// reduce: 3 + 2 * chunks values.
template <bool WIDE>
__global__ void __launch_bounds__(CS_THREADS)
cs_small_kernel(const float* __restrict__ x, const void* __restrict__ h,
                int h64, long long n, long long b, int shift, long long nbins,
                int G, Ptrs p, float* __restrict__ out,
                long long* __restrict__ stamps) {
  __shared__ WarpSmem<WIDE> sm[CS_WARPS];
  __shared__ Key<WIDE> tile[CS_TILE];
  __shared__ int last;
  typedef cub::BlockScan<int, CS_THREADS> Scan;
  typedef cub::BlockReduce<int, CS_THREADS> Reduce;
  __shared__ union {
    typename Scan::TempStorage scan;
    typename Reduce::TempStorage reduce;
  } tmp;
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const long long first = (long long)blockIdx.x * CS_THREADS + tid;
  const long long step = (long long)gridDim.x * CS_THREADS;
  int mark = 0;
  auto stamp = [&]() {
    if (stamps != nullptr && blockIdx.x == 0 && tid == 0) stamps[mark] = global_ns();
    ++mark;
  };
  stamp();
  for (long long i = first; i < n; i += step) count_index(h, h64, i, b, shift, p.count);
  grid_sync(p.bar);
  stamp();

  // off[j + 1] = carry + the sum of count[tile start .. j], for tile t
  auto scan_tile = [&](long long t, int carry) {
    const long long j0 = t * CS_SMALL_TILE + (long long)tid * CS_SMALL_ITEMS;
    int v[CS_SMALL_ITEMS];
#pragma unroll
    for (int k = 0; k < CS_SMALL_ITEMS; k += 4) {
      if (j0 + k + 4 <= nbins) {  // count starts on 16 bytes
        const int4 q = __ldcg(reinterpret_cast<const int4*>(p.count + j0 + k));
        v[k] = q.x, v[k + 1] = q.y, v[k + 2] = q.z, v[k + 3] = q.w;
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[k + u] = j0 + k + u < nbins ? __ldcg(p.count + j0 + k + u) : 0;
      }
    }
    Scan(tmp.scan).InclusiveSum(v, v);
#pragma unroll
    for (int k = 0; k < CS_SMALL_ITEMS; ++k)
      if (j0 + k < nbins) p.off[j0 + k + 1] = carry + v[k];
    __syncthreads();
  };
  const long long ntiles = (nbins + CS_SMALL_TILE - 1) / CS_SMALL_TILE;
  if (ntiles == 1) {
    if (blockIdx.x == 0) scan_tile(0, 0);
  } else if (ntiles > 1) {
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const long long j0 = t * CS_SMALL_TILE + (long long)tid * CS_SMALL_ITEMS;
      int sum = 0;
      for (int k = 0; k < CS_SMALL_ITEMS; ++k)
        if (j0 + k < nbins) sum += __ldcg(p.count + j0 + k);
      sum = Reduce(tmp.reduce).Sum(sum);
      if (tid == 0) p.tiles[t] = sum;
      __syncthreads();
    }
    grid_sync(p.bar);
    if (blockIdx.x == 0) {  // the exclusive scan of the tile sums
      int carry = 0;
      for (long long c0 = 0; c0 < ntiles; c0 += CS_THREADS) {
        const long long j = c0 + tid;
        int ex, total;
        Scan(tmp.scan).ExclusiveSum(j < ntiles ? __ldcg(p.tiles + j) : 0, ex, total);
        if (j < ntiles) p.tiles[j] = carry + ex;
        carry += total;
        __syncthreads();
      }
    }
    grid_sync(p.bar);
    for (long long t = blockIdx.x; t < ntiles; t += gridDim.x)
      scan_tile(t, __ldcg(p.tiles + t));
  }
  grid_sync(p.bar);
  stamp();

  for (int g0 = 0; g0 < G; g0 += CS_ROWS) {
    const int rows = min(CS_ROWS, G - g0);
    if (g0 > 0) {
      for (long long j = first; j < p.reset_ints; j += step) p.cursor[j] = 0;
      grid_sync(p.bar);
    }
    for (long long i = first; i < n; i += step) place_index(x, h, h64, n, b, shift, g0, rows, p, i);
    grid_sync(p.bar);
    stamp();
    for (long long w = (long long)blockIdx.x * CS_WARPS + wid; w < nbins;
         w += (long long)gridDim.x * CS_WARPS)
      reduce_window<WIDE>(w, p, b, shift, g0, rows, out, sm[wid], lane);
    grid_sync(p.bar);
    long_windows<WIDE>(p, b, g0, rows, out, tile, last);
    // timed, the last stamp waits for every block: one barrier more than
    // an untimed call
    if (g0 + CS_ROWS < G || stamps != nullptr) grid_sync(p.bar);
    stamp();
  }
}

// ---------------------------------------------------------------------------
// entry points: each returns the first CUDA error of its launches (0 if none)
// and adds to *launched the kernels and memsets it put on the stream
// ---------------------------------------------------------------------------

static unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

#define CS_CHECK(call)                              \
  do {                                              \
    cudaError_t e_ = (call);                        \
    if (e_ != cudaSuccess) return (int)e_;          \
  } while (0)

// a kernel launch or memset just issued: its error, or count it
#define CS_ENQUEUED(call)                           \
  do {                                              \
    CS_CHECK(call);                                 \
    ++*launched;                                    \
  } while (0)

// int32 words of the scratch buffer `work` that the entry points share
extern "C" long long cs_work_ints(long long n, long long nbins, int coarse) {
  return layout(n, nbins, coarse).ints;
}

template <bool WIDE>
static int launch_small(const float* x, const void* h, int h64, long long n,
                        long long b, int shift, long long nbins, int G, Ptrs p,
                        float* out, long long* stamps, int sms, cudaStream_t st,
                        int* launched) {
  static int per_sm = 0;  // blocks of cs_small_kernel<WIDE> an SM holds
  if (per_sm == 0)
    CS_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cs_small_kernel<WIDE>, CS_THREADS, 0));
  // every block must be resident at once (cooperative launch); no more
  // than the work needs, since each barrier waits for every block
  const long long need = max(max((long long)blocks_for(n, CS_THREADS),
                                 (long long)blocks_for(nbins, CS_WARPS)), 1LL);
  const unsigned grid = (unsigned)min(need, (long long)per_sm * sms);
  void* args[] = {(void*)&x, (void*)&h, (void*)&h64, (void*)&n, (void*)&b,
                  (void*)&shift, (void*)&nbins, (void*)&G, (void*)&p,
                  (void*)&out, (void*)&stamps};
  CS_ENQUEUED(cudaLaunchCooperativeKernel((void*)cs_small_kernel<WIDE>, grid,
                                          CS_THREADS, args, 0, st));
  return 0;
}

// Small n: zeroes the counters, then runs every stage for x (G, n) float32
// and h (n,) int32 (h64 = 0) or int64 (h64 = 1) into out (G, b), in one
// cooperative launch on at most `sms` SMs.  stamps: null, or room for
// 3 + 2 * ceil(G / CS_ROWS) timer values.
extern "C" int cs_small(const float* x, const void* h, int h64, long long n,
                        long long b, int shift, long long nbins, int G,
                        int* work, float* out, long long* stamps, int sms,
                        void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = layout(n, nbins, 0);
  CS_ENQUEUED(cudaMemsetAsync(work + w.count, 0, (w.ints - w.count) * sizeof(int), st));
  const Ptrs p = pointers(work, w);
  return shift > 0 ? launch_small<true>(x, h, h64, n, b, shift, nbins, G, p, out,
                                        stamps, sms, st, launched)
                   : launch_small<false>(x, h, h64, n, b, shift, nbins, G, p, out,
                                         stamps, sms, st, launched);
}

// Large n: zeroes the counters of `work`, then counts the indices of each
// window, a block per SM (`sms`).
extern "C" int cs_histogram(const void* h, int h64, long long n, long long b,
                            int shift, long long nbins, int sms, int* work,
                            void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = layout(n, nbins, 1);
  CS_ENQUEUED(cudaMemsetAsync(work + w.count, 0, (w.ints - w.count) * sizeof(int), st));
  if (n == 0 || nbins == 0) return 0;
  const int smem = (int)min((long long)CS_HIST_BINS, nbins) * sizeof(int);
  CS_CHECK(cudaFuncSetAttribute(cs_histogram_smem_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  cs_histogram_smem_kernel<<<sms, CS_SCAN, smem, st>>>(h, h64, n, b, shift, nbins,
                                                      work + w.count);
  CS_ENQUEUED(cudaGetLastError());
  return 0;
}

// Large n: off[0 .. nbins] = exclusive scan of the counts.
extern "C" int cs_scan(long long n, long long nbins, int* work, void* stream,
                       int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = layout(n, nbins, 1);
  const long long nt = (nbins + CS_SCAN - 1) / CS_SCAN;
  if (nt == 0) return 0;
  cs_tile_sums_kernel<<<(unsigned)nt, CS_SCAN, 0, st>>>(work + w.count, nbins,
                                                        work + w.tiles);
  CS_ENQUEUED(cudaGetLastError());
  cs_tile_prefix_kernel<<<1, CS_SCAN, 0, st>>>(work + w.tiles, nt);
  CS_ENQUEUED(cudaGetLastError());
  cs_offsets_kernel<<<(unsigned)nt, CS_SCAN, 0, st>>>(work + w.count, nbins,
                                                      work + w.tiles, work + w.off);
  CS_ENQUEUED(cudaGetLastError());
  return 0;
}

// Large n: places the records of rows g0 .. g0 + rows - 1 (rows <= CS_ROWS)
// of x (G, n) float32 into their windows, in the two passes of cs_group;
// for g0 > 0 the cursors are zeroed first.
extern "C" int cs_place(const float* x, const void* h, int h64, long long n,
                        long long b, int shift, long long nbins, int g0,
                        int rows, int* work, void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  const Work w = layout(n, nbins, 1);
  if (g0 > 0)
    CS_ENQUEUED(cudaMemsetAsync(work + w.cursor, 0, (w.ints - w.cursor) * sizeof(int), st));
  if (n == 0) return 0;
  const int smem = CS_PART_TILE * (2 * sizeof(int4) + sizeof(int) + sizeof(unsigned short));
  CS_CHECK(cudaFuncSetAttribute(cs_group_kernel<true>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  CS_CHECK(cudaFuncSetAttribute(cs_group_kernel<false>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const int cshift = coarse_shift(nbins);
  const unsigned grid = blocks_for(n, CS_PART_TILE);
  int4* part = (int4*)(work + w.part);
  cs_group_kernel<true><<<grid, CS_GROUP_THREADS, smem, st>>>(
      x, h, h64, n, b, g0, rows, nullptr, shift + cshift, cshift, 0,
      work + w.off, nbins, work + w.gcur, part);
  CS_ENQUEUED(cudaGetLastError());
  cs_group_kernel<false><<<grid, CS_GROUP_THREADS, smem, st>>>(
      nullptr, nullptr, 0, n, b, g0, rows, part, shift, 0, cshift, work + w.off,
      nbins, work + w.cursor, (int4*)(work + w.rec));
  CS_ENQUEUED(cudaGetLastError());
  return 0;
}

// Large n: sums every window (<= CS_BIG_SLOTS slots of 2^shift) into rows
// g0 .. g0 + rows - 1 of out (G, b), every slot written, a block per
// window; blocks: the grid of the long-window kernel.
extern "C" int cs_reduce(long long n, long long nbins, long long b, int shift,
                         int g0, int rows, int* work, float* out, int blocks,
                         void* stream, int* launched) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nbins == 0) return 0;
  if ((1 << shift) > CS_BIG_SLOTS) return (int)cudaErrorInvalidValue;
  const Ptrs p = pointers(work, layout(n, nbins, 1));
  const int smem = 2 * CS_BIG_CAP * sizeof(int4);
  CS_CHECK(cudaFuncSetAttribute(cs_reduce_big_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  cs_reduce_big_kernel<<<(unsigned)nbins, CS_BIG_THREADS, smem, st>>>(p, b, shift, g0,
                                                                     rows, out);
  CS_ENQUEUED(cudaGetLastError());
  if (shift > 0)
    cs_long_kernel<true><<<blocks, CS_TILE, 0, st>>>(p, b, g0, rows, out);
  else
    cs_long_kernel<false><<<blocks, CS_TILE, 0, st>>>(p, b, g0, rows, out);
  CS_ENQUEUED(cudaGetLastError());
  return 0;
}
