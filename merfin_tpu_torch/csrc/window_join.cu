// Window join for Hopper (sm_90a): single-value sorted join that streams
// each query block's table window through shared memory.
//
// Replaces two TPU Pallas kernels with one contract:
//   * merfin_tpu/ops/join_kernel.py:_kernel (v1, host side
//     SortJoinTable.lookup_sorted_with);
//   * merfin_tpu/ops/join_kernel5.py:_kernel (v5, host side
//     SortJoinTableV5.lookup_sorted_with), v1's function with a lane-rolled
//     query layout that existed only to avoid Mosaic's 128x padding of a
//     (QB, 1) column.
// Contract: for each query of a u64 stream sorted ascending (as
// unsigned), the u32 sum of the values of the equal table keys (wrapping
// mod 2^32, like v1's int32 sum cast to u32), 0 where there is none and
// for the invalid-window sentinel u64::MAX.  Table: sorted keys u64[n]
// and values u32[n], structure of arrays (v1's u32 hi/lo planes existed
// because the TPU has no 64-bit vectors).
//
// Design: one CTA per block of QB = 1024 sorted queries (4 per thread,
// strided so that loads coalesce).  The block's table window is
// [lower_bound(first query), upper_bound(last real query)): two threads
// of different warps find the two ends by binary search (v1 computes the
// same window outside its kernel with searchsorted).  Sentinels sort last,
// so the last real query is the one before the block's first sentinel;
// sentinels never widen the window.  The block streams its window through
// shared memory in tiles of TILE keys and values (24 KB), loaded
// coalesced; each thread binary-searches its queries that fall inside the
// tile and adds the values of every equal key.  The ragged edge of the
// query stream is masked, so any query length works.  The kernel
// allocates nothing and launches on the caller's stream.
//
// What bounds it: bytes of the window.  Every block reads its whole
// window once (12 B a key), so the cost is linear in the keys between a
// block's first and last query: about QB * table / queries keys per
// block.  That is cheap for a dense query stream and ruinous for a sparse
// one, which is why the table builder's ratio rule gives this kernel only
// streams with table/query <= 2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QB = 1024;
constexpr int THREADS = 256;
constexpr int PER_THREAD = QB / THREADS;
constexpr int TILE = 2048;
constexpr unsigned long long SENTINEL = ~0ULL;

// first index in [0, n) whose key is >= x (upper = false) or > x (true)
__device__ long long bound(const unsigned long long* __restrict__ keys,
                           long long n, unsigned long long x, bool upper) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    const unsigned long long k = __ldg(keys + mid);
    if (k < x || (upper && k == x)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
window_join_kernel(const unsigned long long* __restrict__ keys,
                   const uint32_t* __restrict__ vals, long long n,
                   const unsigned long long* __restrict__ q, long long m,
                   uint32_t* __restrict__ out) {
  __shared__ unsigned long long s_keys[TILE];
  __shared__ uint32_t s_vals[TILE];
  __shared__ long long s_win[2];

  const long long q0 = (long long)blockIdx.x * QB;
  const int qn = (int)min((long long)QB, m - q0);   // ragged last block

  unsigned long long x[PER_THREAD];
  uint32_t acc[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    x[j] = idx < qn ? q[q0 + idx] : SENTINEL;
    acc[j] = 0;
  }

  if (threadIdx.x == 0) {
    const unsigned long long first = q[q0];
    s_win[0] = first == SENTINEL ? 0 : bound(keys, n, first, false);
  } else if (threadIdx.x == 32) {
    int lo = 0, hi = qn;                       // first sentinel of the block
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (q[q0 + mid] != SENTINEL) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    s_win[1] = lo == 0 ? 0 : bound(keys, n, q[q0 + lo - 1], true);
  }
  __syncthreads();
  const long long w0 = s_win[0];
  const long long w1 = max(s_win[1], w0);      // empty when all sentinels

  for (long long t0 = w0; t0 < w1; t0 += TILE) {
    const int len = (int)min((long long)TILE, w1 - t0);
    for (int j = threadIdx.x; j < len; j += THREADS) {
      s_keys[j] = __ldg(keys + t0 + j);
      s_vals[j] = __ldg(vals + t0 + j);
    }
    __syncthreads();
    const unsigned long long first = s_keys[0], last = s_keys[len - 1];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const unsigned long long xj = x[j];
      if (xj == SENTINEL || xj < first || xj > last) continue;
      int lo = 0, hi = len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_keys[mid] < xj) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      for (; lo < len && s_keys[lo] == xj; ++lo) acc[j] += s_vals[lo];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    if (idx < qn) out[q0 + idx] = acc[j];
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int merfin_window_join(const void* keys, const void* vals,
                                  long long n, const void* q, long long m,
                                  void* out, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const long long blocks = (m + QB - 1) / QB;
  window_join_kernel<<<(unsigned int)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)vals, n,
      (const unsigned long long*)q, m, (uint32_t*)out);
  return (int)cudaGetLastError();
}
