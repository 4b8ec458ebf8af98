// Window join for Hopper (sm_90a): the single-value sorted join whose
// table keys may repeat (their values sum).
//
// Replaces two TPU Pallas kernels with one contract:
//   * merfin_tpu/ops/join_kernel.py:32 _kernel (v1, host side
//     SortJoinTable.lookup_sorted_with);
//   * merfin_tpu/ops/join_kernel5.py:35 _kernel (v5, host side
//     SortJoinTableV5.lookup_sorted_with), v1's function with a lane-rolled
//     query layout that existed only to avoid Mosaic's 128x padding of a
//     (QB, 1) column.
// Contract: for each query of a u64 stream sorted ascending (as
// unsigned), the u32 sum of the values of the equal table keys (wrapping
// mod 2^32, like v1's int32 sum cast to u32), 0 where there is none and
// for the invalid-window sentinel u64::MAX.  Any query length.  Table:
// sorted keys u64[n] (equal keys allowed) and, in place of the values,
// their wrapped prefix column pre[i] = vals[0] + ... + vals[i-1] mod 2^32
// (n + 1 entries, built once with the table; v1's u32 hi/lo planes
// existed because the TPU has no 64-bit vectors).  The sum of a run of
// equal keys [lb, ub) is then pre[ub] - pre[lb] in u32 arithmetic,
// however long the run, and a run that a chunk boundary cuts telescopes:
// each chunk adds its part, pre[u] - pre[l] within the chunk.
//
// Design: tiles of T = THREADS * QPT sorted queries, two kernels.
//   1. bounds_kernel, one warp a tile: win[b] = lower_bound(first query of
//      tile b) by 32-ary search (each round the warp probes 32 keys and
//      cuts the range 33-fold: a 6.4e7-key table takes 6 dependent loads,
//      not 26), so every tile's search is in flight at once instead of
//      heading its CTA's critical path.  Tile b's window is [win[b],
//      win[b + 1]); sentinels sort last and never widen it.
//   2. window_join_kernel, one CTA a tile, QPT consecutive queries a
//      thread, launched as a programmatic dependent of bounds_kernel: its
//      CTAs load their queries while the bounds are found.  A run of
//      equal queries across the tile's end widens its window to the whole
//      run of equal keys.
//      * Dense windows (at most WIDE keys a query) stream through a ring
//        of two shared-memory stages of CHUNK keys and CHUNK + 1 prefix
//        entries, copied with cp.async: chunk c + 1 loads while chunk c is
//        merged.  A thread finds its first query in the chunk by a binary
//        search whose trip count depends on the chunk only (no
//        divergence), or continues from the chunk's start, then advances
//        linearly (galloping after eight probes) to each next query's
//        lower and upper bound; a query equal to its predecessor reuses its
//        sum.  The stage is skewed (a pad word every 8 entries), which
//        keeps the lanes' probes, a few keys apart, and the searches'
//        power-of-two strides off one shared-memory bank.  So a key
//        moves in an 8-byte cp.async and a prefix entry in a 4-byte
//        one: 16-byte copies need 16-byte aligned pairs and quads in
//        shared memory, and any pad that keeps them aligned leaves
//        lanes 8 keys apart (the v1 ratio) on at most 8 distinct bank
//        groups, a 2-way conflict on keys and 4-way on prefix entries,
//        in the merge's dependent chain, to save ~5 of the copy's
//        ~9 issues a thread a chunk.
//      * Wider windows (few queries far apart) skip the stream: each
//        thread searches its queries' bounds in device memory, galloping
//        from its previous query, and reads two prefix entries.
//   A tile of sentinels has an empty window and reads no table.
//
// What bounds it (PERF.md, H100): not yet the bytes.  At the completeness
// block (2^22 dense queries) the join kernel moves ~2.2 TB/s, held back
// by each tile's latency chain (queries, window copy, merge, store) with
// 8 CTAs an SM; the merge is a chain of dependent shared-memory loads.
// The bounds pass adds ~6 us of scattered 32-sector probes.  At the v1
// ratio (2^20 queries, an L2-resident 2^21-key table) the merge's
// shared-memory probes, ~2 keys a query, are the cost.  Constants set by
// measurement (scripts/join_tune.py; PERF.md); they can be overridden
// with -D for measurement, and merfin_window_config reports what was
// built.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MERFIN_WINDOW_THREADS
#define MERFIN_WINDOW_THREADS 256
#endif
#ifndef MERFIN_WINDOW_QPT
#define MERFIN_WINDOW_QPT 4
#endif
#ifndef MERFIN_WINDOW_CHUNK
#define MERFIN_WINDOW_CHUNK 1024
#endif
#ifndef MERFIN_WINDOW_MINB
#define MERFIN_WINDOW_MINB 8
#endif

namespace {

typedef unsigned long long u64;

constexpr int THREADS = MERFIN_WINDOW_THREADS;
constexpr int QPT = MERFIN_WINDOW_QPT;
constexpr long long T = (long long)THREADS * QPT;      // queries a tile
constexpr int CHUNK = MERFIN_WINDOW_CHUNK;             // keys a stage
// CTAs an SM the register allocation must allow (__launch_bounds__)
constexpr int MINB = MERFIN_WINDOW_MINB;
// a tile whose window holds more than WIDE keys a query searches device
// memory instead of streaming the window
constexpr long long WIDE = 32;
constexpr u64 SENTINEL = ~0ULL;

// Shared-memory layout of a stage: entry j of the chunk sits at
// j + j / 8, one pad word after every 8 entries.  Neighbouring lanes
// probe entries a few keys apart, and searches probe at power-of-two
// strides; unskewed, both put most lanes of a warp on one bank.
__host__ __device__ constexpr int skew(int j) { return j + (j >> 3); }

// one stage: CHUNK keys and a u64::MAX after them, CHUNK + 1 prefix
// entries
constexpr int STAGE_KEYS = (skew(CHUNK + 1) + 2) & ~1;
constexpr int STAGE_PRE = (skew(CHUNK) + 4) & ~3;
constexpr int STAGE_BYTES = STAGE_KEYS * 8 + STAGE_PRE * 4;
constexpr int SMEM_BYTES = 2 * STAGE_BYTES;

static_assert(THREADS >= 64 && THREADS % 32 == 0 && QPT >= 1,
              "bad window join constants");
static_assert(CHUNK >= 32 && CHUNK % 4 == 0, "bad window join chunk");

template <bool G>
__device__ __forceinline__ u64 at(const u64* a, long long i) {
  return G ? __ldg(a + i) : a[i];
}

// first i in [lo, hi) with a[i] >= x (UPPER = false) or a[i] > x (true);
// hi if none.  a[lo, hi) is sorted.
template <bool G, bool UPPER>
__device__ long long search_bound(const u64* a, long long lo, long long hi,
                                  u64 x) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const u64 v = at<G>(a, mid);
    if (UPPER ? v > x : v >= x) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// search_bound, given that the answer is >= lo: probes lo, lo+1, lo+3, ...
// and then searches the bracket, so an answer d places on costs
// ~2 log2(d) probes.
template <bool G, bool UPPER>
__device__ long long gallop(const u64* a, long long lo, long long hi, u64 x) {
  long long step = 1, top = hi;
  while (lo + step <= hi) {
    const long long i = lo + step - 1;
    const u64 v = at<G>(a, i);
    if (UPPER ? v > x : v >= x) {
      top = i;
      break;
    }
    lo = i + 1;
    step <<= 1;
  }
  return search_bound<G, UPPER>(a, lo, top, x);
}

// search_bound over device memory by a whole warp (all 32 lanes call it
// with the same arguments and get the same answer): each round probes 32
// keys spread over the range and keeps the 1/33 between the last probe
// below the answer and the first at or above it.
template <bool UPPER>
__device__ long long warp_bound(const u64* __restrict__ a, long long lo,
                                long long hi, u64 x) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const u64 v = __ldg(a + lo + (lane + 1) * len / 33);
    const int c = __popc(__ballot_sync(~0u, UPPER ? v <= x : v < x));
    const long long nlo = c == 0 ? lo : lo + c * len / 33 + 1;
    hi = c == 32 ? hi : lo + (c + 1) * len / 33;
    lo = nlo;
  }
  const bool in = lo + lane < hi;
  const u64 v = in ? __ldg(a + lo + lane) : 0;
  return lo + __popc(__ballot_sync(~0u, in && (UPPER ? v <= x : v < x)));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying keys[c0, c1) and pre[c0, c1] into a stage, skewed (all
// threads call it; one commit group), and put u64::MAX after the keys,
// visible after the next __syncthreads.
__device__ void stage(unsigned char* s, const u64* __restrict__ keys,
                      const uint32_t* __restrict__ pre, long long c0,
                      long long c1) {
  u64* sk = reinterpret_cast<u64*>(s);
  uint32_t* sp = reinterpret_cast<uint32_t*>(s + STAGE_KEYS * 8);
  const int len = (int)(c1 - c0);
  for (int j = threadIdx.x; j < len; j += THREADS) {
    cp_async<8>(sk + skew(j), keys + c0 + j);
  }
  for (int j = threadIdx.x; j <= len; j += THREADS) {
    cp_async<4>(sp + skew(j), pre + c0 + j);
  }
  cp_commit();
  if (threadIdx.x == 0) sk[skew(len)] = SENTINEL;
}

// The searches below run over a skewed stage: s[skew(j)] is entry j.

// first i in [0, len) with entry i >= x, len if none (len >= 1): a
// binary search whose trip count depends on len only, so a warp never
// diverges
__device__ __forceinline__ int lower_bound_smem(const u64* s, int len,
                                                u64 x) {
  int base = 0;
  for (int n = len; n > 1;) {
    const int half = n >> 1;
    base = s[skew(base + half)] < x ? base + half : base;
    n -= half;
  }
  return base + (s[skew(base)] < x ? 1 : 0);
}

// first i in [lo, hi) with entry i >= x (UPPER: > x), hi if none, given
// that entries from lo on are sorted: a gallop, then a binary search
template <bool UPPER>
__device__ __forceinline__ int gallop_smem(const u64* s, int lo, int hi,
                                           u64 x) {
  int step = 1, top = hi;
  while (lo + step <= hi) {
    const int i = lo + step - 1;
    const u64 v = s[skew(i)];
    if (UPPER ? v > x : v >= x) {
      top = i;
      break;
    }
    lo = i + 1;
    step <<= 1;
  }
  while (lo < top) {
    const int mid = (lo + top) >> 1;
    const u64 v = s[skew(mid)];
    if (UPPER ? v > x : v >= x) {
      top = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

// gallop_smem after up to eight linear probes (neighbouring queries of a
// dense stream are a key or two apart); x < u64::MAX, and the stage's
// u64::MAX after its last key stops the probes there
template <bool UPPER>
__device__ __forceinline__ int advance_smem(const u64* s, int lo, int hi,
                                            u64 x) {
  for (int k = 0; k < 8; ++k, ++lo) {
    const u64 v = s[skew(lo)];
    if (UPPER ? v > x : v >= x) return lo;
  }
  return gallop_smem<UPPER>(s, lo, hi, x);
}

// win[b] for b in [0, tiles]: lower_bound(first query of tile b), or,
// where that query is a sentinel (and for b = tiles), upper_bound(last
// real query of the stream).  Tile b's window is then [win[b],
// win[b + 1]), widened where a run of equal queries crosses into tile
// b + 1; the keys strictly between two tiles' queries that it also holds
// match nothing.  One warp a tile, so every tile's ~6 dependent loads are
// in flight at once.
__global__ void __launch_bounds__(256)
bounds_kernel(const u64* __restrict__ keys, long long n,
              const u64* __restrict__ q, long long m,
              long long* __restrict__ win, long long tiles) {
  asm volatile("griddepcontrol.launch_dependents;");
  const long long b = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (b > tiles) return;                       // whole warps
  const u64 first = b < tiles ? __ldg(q + b * T) : SENTINEL;
  long long r;
  if (first != SENTINEL) {
    r = warp_bound<false>(keys, 0, n, first);
  } else {
    const long long e = warp_bound<false>(q, 0, m, SENTINEL);
    r = e == 0 ? 0 : warp_bound<true>(keys, 0, n, __ldg(q + e - 1));
  }
  if ((threadIdx.x & 31) == 0) win[b] = r;
}

__global__ void __launch_bounds__(THREADS, MINB)
window_join_kernel(const u64* __restrict__ keys,
                   const uint32_t* __restrict__ pre,
                   const u64* __restrict__ q, long long m,
                   long long n, const long long* __restrict__ win,
                   uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char s_buf[];

  const long long t0 = (long long)blockIdx.x * T;
  const long long qi = t0 + (long long)threadIdx.x * QPT;
  u64 x[QPT];
  uint32_t acc[QPT];
  // a whole run of QPT queries at 16-byte aligned addresses (torch's
  // allocations are) moves in 16-byte pieces
  const bool whole = qi + QPT <= m &&
                     (reinterpret_cast<uintptr_t>(q + qi) & 15) == 0 &&
                     (reinterpret_cast<uintptr_t>(out + qi) & 15) == 0;
  bool loaded = false;
  if constexpr (QPT % 2 == 0) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < QPT; j += 2) {
        const ulonglong2 v =
            __ldg(reinterpret_cast<const ulonglong2*>(q + qi + j));
        x[j] = v.x;
        x[j + 1] = v.y;
      }
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      x[j] = qi + j < m ? __ldg(q + qi + j) : SENTINEL;
    }
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) acc[j] = 0;
  // launched while bounds_kernel runs: its windows are complete and
  // visible from here on
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const long long w0 = __ldg(win + blockIdx.x);
  long long w1 = max(__ldg(win + blockIdx.x + 1), w0);
  if (t0 + T < m) {
    const u64 last = __ldg(q + t0 + T - 1);
    if (last != SENTINEL && last == __ldg(q + t0 + T)) {
      w1 = gallop<true, true>(keys, w1, n, last);   // its whole run
    }
  }

  if (w1 - w0 <= WIDE * T) {                   // dense: stream the window
    const long long chunks = (w1 - w0 + CHUNK - 1) / CHUNK;
    if (chunks > 0) stage(s_buf, keys, pre, w0, min(w0 + CHUNK, w1));
    for (long long c = 0; c < chunks; ++c) {
      const long long c0 = w0 + c * CHUNK;
      const long long c1 = min(c0 + CHUNK, w1);
      const int b = (int)(c & 1);
      if (c + 1 < chunks) {
        stage(s_buf + (b ^ 1) * STAGE_BYTES, keys, pre, c1,
              min(c1 + CHUNK, w1));
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const u64* sk = reinterpret_cast<const u64*>(s_buf + b * STAGE_BYTES);
      const uint32_t* sp = reinterpret_cast<const uint32_t*>(
          s_buf + b * STAGE_BYTES + STAGE_KEYS * 8);
      const int len = (int)(c1 - c0);
      const u64 lo_key = sk[0], hi_key = sk[skew(len - 1)];
      // a thread whose queries began in an earlier chunk continues from
      // this chunk's start; one whose first query is here searches for it
      int pos = x[0] < lo_key ? 0 : -1;
      bool found = false;
      uint32_t add = 0;
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const u64 xj = x[j];
        if (xj > hi_key) break;                // sentinels too
        if (xj < lo_key) continue;
        if (j > 0 && found && xj == x[j - 1]) {
          acc[j] += add;
          continue;
        }
        const int l = pos < 0 ? lower_bound_smem(sk, len, xj)
                              : advance_smem<false>(sk, pos, len, xj);
        const int u = advance_smem<true>(sk, l, len, xj);
        add = u > l ? sp[skew(u)] - sp[skew(l)] : 0;
        acc[j] += add;
        pos = u;
        found = true;
      }
      __syncthreads();                         // before the stage is reused
    }
  } else {                                     // wide: search device memory
    long long pos = w0;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const u64 xj = x[j];
      if (xj == SENTINEL) break;
      if (j > 0 && xj == x[j - 1]) {
        acc[j] = acc[j - 1];
        continue;
      }
      const long long l = j == 0
                              ? search_bound<true, false>(keys, w0, w1, xj)
                              : gallop<true, false>(keys, pos, w1, xj);
      const long long u = gallop<true, true>(keys, l, w1, xj);
      if (u > l) acc[j] = __ldg(pre + u) - __ldg(pre + l);
      pos = u;
    }
  }

  if constexpr (QPT % 4 == 0) {
    if (whole) {
#pragma unroll
      for (int j = 0; j < QPT; j += 4) {
        *reinterpret_cast<uint4*>(out + qi + j) =
            make_uint4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    if (qi + j < m) out[qi + j] = acc[j];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launch entry returns
// cudaGetLastError() after its launch: 0 when it was accepted.

// out[0..2] = (T queries a tile, CHUNK keys a stage, WIDE keys a query
// above which a tile searches device memory).
extern "C" void merfin_window_config(long long* out) {
  out[0] = T;
  out[1] = CHUNK;
  out[2] = WIDE;
}

// Allow the kernel its dynamic shared memory and carveout; called once
// before the first launch.
extern "C" int merfin_window_init() {
  const int err = (int)cudaFuncSetAttribute(
      window_join_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != 0) return err;
  // the largest shared-memory carveout, so that as many CTAs share an SM
  // as their threads and registers allow; what is left of L1 still
  // caches the loads (cp.async.ca and __ldg both go through it)
  return (int)cudaFuncSetAttribute(
      window_join_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// pre: the wrapped u32 prefix column of the values (n + 1 entries);
// windows: int64 scratch of ceil(m / T) + 1 entries.
extern "C" int merfin_window_join(const void* keys, const void* pre,
                                  long long n, const void* q, long long m,
                                  void* out, void* windows, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (m + T - 1) / T;
  bounds_kernel<<<(unsigned int)(((tiles + 1) * 32 + 255) / 256), 256, 0,
                  s>>>((const u64*)keys, n, (const u64*)q, m,
                       (long long*)windows, tiles);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = s;
  // programmatic dependent launch: the join's CTAs start, and load their
  // queries, while bounds_kernel runs
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, window_join_kernel, (const u64*)keys, (const uint32_t*)pre,
      (const u64*)q, m, n, (const long long*)windows, (uint32_t*)out);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
