// Fleet state-at-time segment lookup, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fleet_state/kernel.py:52,
// segment_index_pallas (body _kernel): for each query (source device src,
// trace time split into int32 whole seconds qi and an f32 fraction qf), the
// global CSR segment index
//   idx = #{s : dev[s] < src} + #{s : dev[s] == src and (ti[s], tf[s]) <=lex
//         (qi, qf)} - 1.
// Mosaic cannot gather, so the TPU kernel compares every query with all S
// segments in one (block, S) masked count: O(N * S) work.
//
// Contract (the plain version, kernels/fleet_state/ref.py, is held to it
// with exact equality).  The segment triples (dev, ti, tf) must be sorted
// lexicographically, non-decreasing: compiled traces are in CSR order with
// strictly increasing starts per device, and the wrapper checks the order
// once, when a trace's arrays are uploaded.  Under that order the masked
// count is the number of triples <=lex (src, qi, qf), which is the upper
// bound of the query in the array: a binary search finds it exactly, for
// every query (src < 0 gives -1 when every dev >= 0, as the count does).
// The comparisons are the masked count's own (int32 <, ==; f32 <=), so the
// result is the count, not an approximation of it.
//
// Design.  One thread per query, a binary search over the whole segment
// array: ceil(log2(S + 1)) probes.  The wrapper uploads each segment as one
// 16-byte record (dev, ti, tf's bits, 0), so a probe is one 16-byte load
// through the read-only path (__ldg) and one L1/L2 request: with three
// separate arrays a probe was three requests, and at N = 1e6 on 2.9e5
// segments the kernel took 4x torch.searchsorted's time over one 8-byte key
// (0.189 against 0.045 ms on the H100).  A trace's records are small against
// the 50 MB L2 (38 KB for the shipped synthetic week, 4.6 MB for a
// 1024-device four-week trace), so after the first queries every probe hits
// L2 or L1.  No shared memory, no synchronisation, no atomics:
// deterministic.
//
// Bound on the card: the bytes that must move, each input read once and the
// output written once, 16 * N + 12 * S (src, qi, qf in, idx out; the
// segments' three fields, the record's padding not counted), over
// 3.35 TB/s: 4.8 us at N = 1e6, S = 2,369.  The operations (~8 integer
// and float compares and selects per probe) are far below the card's rate.
// In practice a call is bound by the wrapper's host time and the launch at
// the fleet sizes of the simulator (1e3 queries), and even at 1e6 queries on
// a week's trace; on large traces by the dependent L2 latency of the search
// (~log2 S round trips per thread).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
segment_index_kernel(const int4* __restrict__ seg, int s,
                     const int* __restrict__ src, const int* __restrict__ qi,
                     const float* __restrict__ qf, int n,
                     int* __restrict__ out) {
  const int q = blockIdx.x * THREADS + threadIdx.x;
  if (q >= n) return;
  const int d = src[q];
  const int qs = qi[q];
  const float qfrac = qf[q];
  // upper bound: the first position whose triple is not <=lex the query
  int lo = 0, hi = s;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int4 r = __ldg(seg + mid);        // (dev, ti, tf bits, 0)
    const float mf = __int_as_float(r.z);
    const bool le =
        r.x < d || (r.x == d && (r.y < qs || (r.y == qs && mf <= qfrac)));
    if (le) lo = mid + 1; else hi = mid;
  }
  out[q] = lo - 1;
}

}  // namespace

extern "C" {

// seg: (s,) records of four int32, 16-byte aligned: dev, ti, the bits of
// the fp32 tf, and 0; sorted as above.  src, qi: (n,) int32; qf: (n,)
// fp32.  Writes out (n,) int32.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
int segment_index_launch(const void* seg, int s, const void* src,
                         const void* qi, const void* qf, int n, void* out,
                         void* stream) {
  if (s < 1 || n < 1 || n > INT_MAX - THREADS ||
      reinterpret_cast<uintptr_t>(seg) % alignof(int4) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  segment_index_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(seg), s, static_cast<const int*>(src),
      static_cast<const int*>(qi), static_cast<const float*>(qf), n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
