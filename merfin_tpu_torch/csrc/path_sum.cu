// Per-path f64 sums in path order, for Hopper (sm_90a): the fused
// scorer's totdK on its f64 branch (-prob tables, or a value map with
// the overflow fallback live).
//
// Contract: out[i] = the sum of values[b_start[i] .. b_end[i]) added one
// value at a time from the first, starting at 0.0, in IEEE double with
// round-to-nearest: the loop of merfin's varMer::getTotdK
// (varMer.C:648-659) over the same per-window values, bit for bit.  An
// empty range gives 0.0.  -polish orders paths by the sum truncated to
// int (varMer.H:72) and writes a het record only when the top two sums
// are equal as doubles (varMer.C:453), so the last bit decides records;
// a prefix difference or a tree sum does not give those bits.
//
// Design: one thread per path.  A path's windows are contiguous, so a
// thread streams its own range; loads are issued ahead in groups of
// UNROLL and added in order with __dadd_rn (never contracted with a
// neighbouring multiply).  The additions of one path form a chain of
// its length (tens to a few hundred windows), so the time goes to the
// loads: 8 bytes a window, read once.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void path_sum_kernel(const double* __restrict__ values,
                                const long long* __restrict__ b_start,
                                const long long* __restrict__ b_end,
                                long long paths, double* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= paths) return;
  long long j = b_start[i];
  const long long end = b_end[i];
  double s = 0.0;
  for (; j + UNROLL <= end; j += UNROLL) {
    double v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(values + j + u);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) s = __dadd_rn(s, v[u]);
  }
  for (; j < end; ++j) s = __dadd_rn(s, __ldg(values + j));
  out[i] = s;
}

}  // namespace

// Plain C interface (loaded with ctypes); returns cudaGetLastError()
// after the launch: 0 when it was accepted.  b_start, b_end: int64
// [paths]; values: f64 covering every range; out: f64 [paths].
extern "C" int merfin_path_sum(const void* values, const void* b_start,
                               const void* b_end, long long paths, void* out,
                               void* stream) {
  if (paths <= 0) return (int)cudaGetLastError();
  const long long blocks = (paths + THREADS - 1) / THREADS;
  path_sum_kernel<<<(unsigned int)blocks, THREADS, 0,
                    (cudaStream_t)stream>>>(
      (const double*)values, (const long long*)b_start,
      (const long long*)b_end, paths, (double*)out);
  return (int)cudaGetLastError();
}
