// Union sorted join for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel merfin_tpu/ops/join_kernel4.py:_kernel2
// (host side join_sorted_rec2).  Contract, not layout: for each query of a
// u64 stream (sorted ascending as unsigned), return the exact (read, asm)
// u32 values of the union table, with (0, 0) for a miss and for the
// invalid-window sentinel u64::MAX.  The TPU kernel's u8 byte planes and
// one-hot matmuls existed only to make bf16 MXU products exact; here the
// table is plain structure-of-arrays: sorted unique keys u64[n], read
// u32[n], asm u32[n].
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

__global__ void union_join_kernel(const unsigned long long* __restrict__ keys,
                                  const uint32_t* __restrict__ read_vals,
                                  const uint32_t* __restrict__ asm_vals,
                                  long long n,
                                  const unsigned long long* __restrict__ q,
                                  long long m,
                                  uint32_t* __restrict__ out_read,
                                  uint32_t* __restrict__ out_asm) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const unsigned long long x = q[i];
  uint32_t r = 0, a = 0;
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
      r = __ldg(read_vals + lo);
      a = __ldg(asm_vals + lo);
    }
  }
  out_read[i] = r;
  out_asm[i] = a;
}

}  // namespace

// Plain C interface (loaded with ctypes).  Returns cudaGetLastError()
// after the launch: 0 when the launch was accepted.
extern "C" int merfin_union_join(const void* keys, const void* read_vals,
                                 const void* asm_vals, long long n,
                                 const void* q, long long m, void* out_read,
                                 void* out_asm, void* stream) {
  if (m <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  union_join_kernel<<<(unsigned int)blocks, threads, 0,
                      (cudaStream_t)stream>>>(
      (const unsigned long long*)keys, (const uint32_t*)read_vals,
      (const uint32_t*)asm_vals, n, (const unsigned long long*)q, m,
      (uint32_t*)out_read, (uint32_t*)out_asm);
  return (int)cudaGetLastError();
}
