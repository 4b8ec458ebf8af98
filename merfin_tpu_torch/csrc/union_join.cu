// Sorted joins by binary search for Hopper (sm_90a): the union join
// (two value columns) and the single-value join, one template.
//
// Replaces two TPU Pallas kernels of merfin_tpu/ops/join_kernel4.py:
//   * _kernel2 (host side join_sorted_rec2), the union join of -hist and
//     -dump: NV = 2, C entry merfin_union_join;
//   * _kernel (host side join_sorted_rec, SortJoinTableV4), the v4
//     single-value join of -completeness: NV = 1, C entry
//     merfin_sorted_join.
// Contract, not layout: for each query of a u64 stream (sorted ascending
// as unsigned), return the exact u32 value(s) of the table's equal key,
// with 0 for a miss and for the invalid-window sentinel u64::MAX.  The
// TPU kernels' u8 byte planes and one-hot matmuls existed only to make
// bf16 MXU products exact; here the table is plain structure-of-arrays:
// sorted unique keys u64[n] and NV value columns u32[n].
//
// Design: one thread per query runs a lower-bound binary search over the
// whole key array; the ragged edge of the query stream is masked, so any
// query length works.  The kernel allocates nothing and launches on the
// caller's stream.
//
// What bounds it: dependent loads.  Each query walks ~log2(n) steps
// (about 28 at n = 1.9e8 keys), each a load that waits for the previous
// one.  Because the queries are sorted, neighbouring threads of a warp
// walk nearly the same path, so their loads share L2 lines (and the top
// levels of every search stay hot in L2 across blocks).  Narrowing each
// block to its window, wgmma/TMA tiles or a merge-path join in shared
// memory are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int NV>
__global__ void sorted_join_kernel(const unsigned long long* __restrict__ keys,
                                   const uint32_t* __restrict__ vals0,
                                   const uint32_t* __restrict__ vals1,
                                   long long n,
                                   const unsigned long long* __restrict__ q,
                                   long long m,
                                   uint32_t* __restrict__ out0,
                                   uint32_t* __restrict__ out1) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long x = q[i];
  uint32_t a = 0, b = 0;
  if (x != ~0ULL && n > 0) {
    long long lo = 0, hi = n;                  // first key >= x
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (__ldg(keys + mid) < x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (lo < n && __ldg(keys + lo) == x) {
      a = __ldg(vals0 + lo);
      if (NV == 2) b = __ldg(vals1 + lo);
    }
  }
  out0[i] = a;
  if (NV == 2) out1[i] = b;
}

template <int NV>
int launch(const void* keys, const void* vals0, const void* vals1,
           long long n, const void* q, long long m, void* out0, void* out1,
           void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  sorted_join_kernel<NV><<<(unsigned int)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)vals0,
      (const uint32_t*)vals1, n, (const unsigned long long*)q, m,
      (uint32_t*)out0, (uint32_t*)out1);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes).  Each returns
// cudaGetLastError() after the launch: 0 when the launch was accepted.
extern "C" int merfin_union_join(const void* keys, const void* read_vals,
                                 const void* asm_vals, long long n,
                                 const void* q, long long m, void* out_read,
                                 void* out_asm, void* stream) {
  return launch<2>(keys, read_vals, asm_vals, n, q, m, out_read, out_asm,
                   stream);
}

extern "C" int merfin_sorted_join(const void* keys, const void* vals,
                                  long long n, const void* q, long long m,
                                  void* out, void* stream) {
  return launch<1>(keys, vals, nullptr, n, q, m, out, nullptr, stream);
}
