// Sorted joins for Hopper (sm_90a): the union join (two value columns)
// and the single-value join, one template.
//
// Replaces two TPU Pallas kernels of merfin_tpu/ops/join_kernel4.py:
//   * _kernel2 (host side join_sorted_rec2), the union join of -hist,
//     -dump and the variant scorers: NV = 2, C entry merfin_union_join;
//   * _kernel (host side join_sorted_rec, SortJoinTableV4), the v4
//     single-value join of -completeness: NV = 1, C entry
//     merfin_sorted_join.
// Contract, not layout: for each query of a u64 stream (sorted ascending
// as unsigned), return the exact u32 value(s) of the table's equal key,
// with 0 for a miss and for the invalid-window sentinel u64::MAX.  The
// table is structure-of-arrays: sorted unique keys u64[n], NV value
// columns u32[n], and a fence index fences[j] = keys[j * F] (F = 16: one
// leaf of F keys is one 128-byte line), built once per table.
//
// Design (windowed):
//   1. windows_kernel: two threads per tile of T sorted queries find the
//      tile's fence window [flo, fhi): flo is the leaf of the first
//      query, fhi one past the leaf of the last real query (sentinels
//      sort last and never widen it).  Doing this in its own pass lets
//      every tile's ~log2(n/F) dependent loads overlap at once instead of
//      holding an SM slot each.
//   2. join_kernel: one CTA per tile, QPT consecutive queries per thread.
//      Per tile, from the window's size:
//      * dense (the window's keys fit SMEM entries): the keys are copied
//        into shared memory with cp.async; each thread finds its first
//        query by binary search there and the rest by galloping forward
//        (a merge);
//      * sparse (at most FENCES_PER_QUERY fences a query): the fence
//        slice is copied into shared memory SMEM - 2 fences at a time;
//        each query finds its leaf in the chunk that holds it and reads
//        that leaf's F keys from device memory in one round trip;
//      * wider windows (a tile of few distinct queries far apart): the
//        fences are searched in device memory (within the window,
//        galloping from the thread's previous query), then the leaf as
//        above.
//      Value columns are read from device memory only on a hit; a query
//      equal to the thread's previous one reuses its answer.
//   A tile of sentinels has an empty window and reads no table.
//
// Constants, set by measurement (scripts/join_tune.py on an H100; see
// PERF.md): THREADS = 256 and QPT = 1 (T = 256 queries a tile); a -hist
// dispatch's window (~190 keys a query on the 1.98e8-key table, ~3K
// fences a tile) takes the sparse path in two chunks.  SMEM = 2048
// entries (16 KB of dynamic shared memory) holds the dense window of a
// completeness block (~85 keys a tile) and lets several CTAs share an SM,
// so the dependent trips of many tiles overlap: 64 KB (three CTAs an SM)
// was 10-30% slower at the completeness block and the variant span, and
// QPT = 2 or 4 (longer merges a thread, fewer tiles) 10-25% slower at
// the -hist dispatch.  They can be overridden with -D for measurement;
// merfin_join_config reports what was built.
//
// What bounds it now: bytes moved at random.  A -hist query moves ~300
// bytes (its share of the fence slice, ~8 * 190 / F; a whole 128-byte
// leaf line; a sector of each value column) against the ~100 its bound
// counts, and the two dependent trips of a sparse query (leaf, then
// values) leave the card short of its memory rate.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef MERFIN_JOIN_THREADS
#define MERFIN_JOIN_THREADS 256
#endif
#ifndef MERFIN_JOIN_QPT
#define MERFIN_JOIN_QPT 1
#endif
#ifndef MERFIN_JOIN_SMEM
#define MERFIN_JOIN_SMEM 2048
#endif

namespace {

typedef unsigned long long u64;

constexpr int THREADS = MERFIN_JOIN_THREADS;
constexpr int QPT = MERFIN_JOIN_QPT;
constexpr long long T = (long long)THREADS * QPT;   // queries a tile
constexpr int F = 16;                                // keys a leaf
constexpr long long SMEM = MERFIN_JOIN_SMEM;         // u64 entries
// a tile whose fence slice exceeds this many fences a query searches the
// fences in device memory instead of staging them
constexpr long long FENCES_PER_QUERY = 16;
constexpr u64 SENTINEL = ~0ULL;

static_assert(QPT >= 1 && SMEM >= 2 * F, "bad join constants");

template <bool G>
__device__ __forceinline__ u64 at(const u64* a, long long i) {
  return G ? __ldg(a + i) : a[i];
}

// first i in [lo, hi) with a[i] >= x (UPPER = false) or a[i] > x (true);
// hi if none.  a[lo, hi) is sorted.
template <bool G, bool UPPER>
__device__ long long search_bound(const u64* a, long long lo,
                                  long long hi, u64 x) {
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
__device__ long long gallop(const u64* a, long long lo, long long hi,
                            u64 x) {
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Copy a[lo, hi) into shared memory so that s[off + i] = a[lo + i]; the
// copy starts at an even index (16-byte aligned).  All threads call it.
__device__ int stage(u64* s, const u64* __restrict__ a, long long lo,
                     long long hi) {
  const long long a0 = lo & ~1LL;
  const long long cnt = hi - a0;
  for (long long j = threadIdx.x; j < (cnt >> 1); j += blockDim.x) {
    cp_async16(s + 2 * j, a + a0 + 2 * j);
  }
  if ((cnt & 1) && threadIdx.x == 0) s[cnt - 1] = __ldg(a + a0 + cnt - 1);
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  return (int)(lo - a0);
}

// index of x in the leaf that starts at key leaf * F, or -1
__device__ long long leaf_find(const u64* __restrict__ keys, long long n,
                               long long leaf, u64 x) {
  const long long base = leaf * F;
  if (base + F <= n) {
    const ulonglong2* p = reinterpret_cast<const ulonglong2*>(keys + base);
    ulonglong2 v[F / 2];
#pragma unroll
    for (int i = 0; i < F / 2; ++i) v[i] = __ldg(p + i);
    long long hit = -1;
#pragma unroll
    for (int i = 0; i < F / 2; ++i) {
      if (v[i].x == x) hit = base + 2 * i;
      if (v[i].y == x) hit = base + 2 * i + 1;
    }
    return hit;
  }
  for (long long i = base; i < n; ++i) {
    if (__ldg(keys + i) == x) return i;
  }
  return -1;
}

// win[2b] = flo and win[2b + 1] = fhi of tile b (fence indexes)
__global__ void windows_kernel(const u64* __restrict__ fences, long long nf,
                               const u64* __restrict__ q, long long m,
                               long long* __restrict__ win, long long tiles) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * tiles) return;
  const long long q0 = (t >> 1) * T;
  const long long qe = min(q0 + T, m);
  long long r = 0;
  if ((t & 1) == 0) {
    const u64 x0 = __ldg(q + q0);
    if (x0 != SENTINEL) {
      r = max(search_bound<true, true>(fences, 0, nf, x0) - 1, 0LL);
    }
  } else {
    long long lo = qe, hi = qe;               // first sentinel of the tile
    if (__ldg(q + qe - 1) == SENTINEL) {
      lo = q0;
      while (lo < hi) {
        const long long mid = lo + ((hi - lo) >> 1);
        if (__ldg(q + mid) != SENTINEL) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
    }
    if (lo > q0) {
      r = search_bound<true, true>(fences, 0, nf, __ldg(q + lo - 1));
    }
  }
  win[t] = r;
}

template <int NV>
__global__ void __launch_bounds__(THREADS)
join_kernel(const u64* __restrict__ keys, const uint32_t* __restrict__ vals0,
            const uint32_t* __restrict__ vals1, long long n,
            const u64* __restrict__ fences, const u64* __restrict__ q,
            long long m, uint32_t* __restrict__ out0,
            uint32_t* __restrict__ out1, const long long* __restrict__ win) {
  extern __shared__ __align__(16) u64 s_buf[];
  const long long b = blockIdx.x;
  const long long q0 = b * T + (long long)threadIdx.x * QPT;
  u64 x[QPT];
  uint32_t r0[QPT], r1[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    x[j] = q0 + j < m ? __ldg(q + q0 + j) : SENTINEL;
    r0[j] = 0;
    r1[j] = 0;
  }
  const long long flo = __ldg(win + 2 * b);
  const long long fhi = max(__ldg(win + 2 * b + 1), flo);
  const long long k0 = flo * F;
  const long long k1 = min(fhi * F, n);

  // the global index of each query's key, or -1
  long long hit[QPT];
  if (k1 - k0 <= SMEM) {                       // dense: keys in smem
    stage(s_buf, keys, k0, k1);                // k0 is even: offset 0
    const long long cnt = k1 - k0;
    long long pos = 0;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      hit[j] = -1;
      if (x[j] == SENTINEL) continue;
      if (j > 0 && x[j] == x[j - 1]) {
        hit[j] = hit[j - 1];
        continue;
      }
      pos = j == 0 ? search_bound<false, false>(s_buf, 0, cnt, x[j])
                   : gallop<false, false>(s_buf, pos, cnt, x[j]);
      if (pos < cnt && s_buf[pos] == x[j]) hit[j] = k0 + pos;
    }
  } else if (fhi - flo <= FENCES_PER_QUERY * T) {
    // sparse: the fence slice, SMEM - 2 fences at a time, in shared
    // memory; a thread resolves each of its queries in the chunk that
    // holds its leaf (x < the next chunk's first fence)
    int j = 0;
    long long r = 0;
    for (long long c0 = flo; c0 < fhi; c0 += SMEM - 2) {
      const long long c1 = min(c0 + SMEM - 2, fhi);
      const u64* s_f = s_buf + stage(s_buf, fences, c0,
                                     c1 + (c1 < fhi ? 1 : 0));
      const long long cnt = c1 - c0;
      const u64 next = c1 < fhi ? s_f[cnt] : SENTINEL;
      bool first = true;
      for (; j < QPT && x[j] != SENTINEL && (c1 == fhi || x[j] < next);
           ++j) {
        hit[j] = -1;
        if (j > 0 && x[j] == x[j - 1]) {
          hit[j] = hit[j - 1];
          continue;
        }
        r = first ? search_bound<false, true>(s_f, 0, cnt, x[j])
                  : gallop<false, true>(s_f, r, cnt, x[j]);
        first = false;
        if (r > 0) hit[j] = leaf_find(keys, n, c0 + r - 1, x[j]);
      }
      __syncthreads();                         // before the next stage
    }
    for (; j < QPT; ++j) hit[j] = -1;          // sentinels
  } else {                                     // wider: fences in memory
    long long r = flo;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      hit[j] = -1;
      if (x[j] == SENTINEL) continue;
      if (j > 0 && x[j] == x[j - 1]) {
        hit[j] = hit[j - 1];
        continue;
      }
      r = j == 0 ? search_bound<true, true>(fences, flo, fhi, x[j])
                 : gallop<true, true>(fences, r, fhi, x[j]);
      if (r > 0) hit[j] = leaf_find(keys, n, r - 1, x[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    if (hit[j] >= 0) {
      r0[j] = __ldg(vals0 + hit[j]);
      if (NV == 2) r1[j] = __ldg(vals1 + hit[j]);
    }
    if (q0 + j < m) {
      out0[q0 + j] = r0[j];
      if (NV == 2) out1[q0 + j] = r1[j];
    }
  }
}

template <int NV>
int launch(const void* keys, const void* vals0, const void* vals1,
           long long n, const void* fences, const void* q, long long m,
           void* out0, void* out1, void* win, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nf = (n + F - 1) / F;
  const long long tiles = (m + T - 1) / T;
  windows_kernel<<<(unsigned int)((2 * tiles + 255) / 256), 256, 0, s>>>(
      (const u64*)fences, nf, (const u64*)q, m, (long long*)win, tiles);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  join_kernel<NV><<<(unsigned int)tiles, THREADS, SMEM * sizeof(u64), s>>>(
      (const u64*)keys, (const uint32_t*)vals0, (const uint32_t*)vals1, n,
      (const u64*)fences, (const u64*)q, m, (uint32_t*)out0,
      (uint32_t*)out1, (const long long*)win);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each launch entry returns
// cudaGetLastError() after its launches: 0 when they were accepted.

// out[0..3] = (T queries a tile, F keys a leaf, SMEM entries,
// FENCES_PER_QUERY): the wrapper sizes the fence index and the window
// scratch from them.
extern "C" void merfin_join_config(long long* out) {
  out[0] = T;
  out[1] = F;
  out[2] = SMEM;
  out[3] = FENCES_PER_QUERY;
}

// Allow the join kernels their dynamic shared memory; called once before
// the first launch.
extern "C" int merfin_join_init() {
  const int bytes = (int)(SMEM * sizeof(u64));
  int err = (int)cudaFuncSetAttribute(
      join_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != 0) return err;
  return (int)cudaFuncSetAttribute(
      join_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// fences: keys[::F] (ceil(n / F) entries); windows: int64 scratch of
// 2 * ceil(m / T) entries.
extern "C" int merfin_union_join(const void* keys, const void* read_vals,
                                 const void* asm_vals, long long n,
                                 const void* fences, const void* q,
                                 long long m, void* out_read, void* out_asm,
                                 void* windows, void* stream) {
  return launch<2>(keys, read_vals, asm_vals, n, fences, q, m, out_read,
                   out_asm, windows, stream);
}

extern "C" int merfin_sorted_join(const void* keys, const void* vals,
                                  long long n, const void* fences,
                                  const void* q, long long m, void* out,
                                  void* windows, void* stream) {
  return launch<1>(keys, vals, nullptr, n, fences, q, m, out, nullptr,
                   windows, stream);
}
