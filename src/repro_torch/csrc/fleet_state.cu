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
// with exact equality).  The segment triples (dev, ti, tf) are sorted
// lexicographically, non-decreasing, every dev >= 0 and every ti >= 0, and
// off (D + 1,) are their CSR offsets: off[d] = #{s : dev[s] < d}, off[D] =
// S, every dev < D.  bkt (D, K + 1) refines them: bkt[d][k] = off[d] +
// #{s of device d : ti[s] < k << shift} for k = 0..K, with K << shift past
// every ti, so bkt[d][0] = off[d] and bkt[d][K] = off[d + 1].  The wrapper
// builds and checks all of this once, when a trace's arrays are uploaded.
// Then the masked count splits in levels:
//   src < 0   -> -1                       (no segment has dev < src)
//   src >= D  -> S - 1                    (every segment has dev < src)
//   else      -> with k = clamp(qi >> shift, 0, K - 1), the upper bound of
//                (qi, qf) in [bkt[src][k], bkt[src][k + 1]), minus one:
// every segment of the device before bkt[src][k] starts before
// k << shift <= qi, so it counts; every one from bkt[src][k + 1] on starts
// at or after (k + 1) << shift > qi, so it does not (for qi < 0, k = 0 and
// the range starts at off[src]; past the last bucket, it ends at
// off[src + 1]).  A query before its device's first segment gives
// off[src] - 1, the previous device's last segment, as the global count
// does.  The comparisons are the masked count's own (int32 <, ==; f32 <=),
// so the result is the count, not an approximation of it.
//
// Bound on the card: the bytes that must move, each input read once and the
// output written once, 16 * N + 12 * S (src, qi, qf in, idx out; the
// segments' three fields, the records' padding and the index tables not
// counted), over 3.35 TB/s: 4.8 us at N = 1e6, S = 2,369, and 13 ns at the
// simulator's N = 1000.  The operations are far below the card's rate.
//
// Design.  The first design (one thread per query, a binary search over
// all S records) was held back by its dependent, divergent probes, not by
// bytes: each probe of a warp touches up to 32 different lines, and at
// N = 1e6 on a 1024-device four-week trace (4.6 MB of records, in L2 but
// not L1) ~19 probes of 32-byte sectors a query made the L2 traffic ~20x
// the bound's bytes.  At N = 1000, the host path around a few microseconds
// of device work was the time.  Here:
//  * each query searches only its own device's segments, and within them
//    only those of one bucket of 2^shift seconds: K buckets a device, K
//    the average segments a device rounded up to a power of two, so a
//    query reads one pair of adjacent bucket bounds and ~1-2 records (each
//    one 16-byte record (dev, ti, tf's bits, 0) through the read-only path,
//    __ldg of int4) where a search of the device's range probes ~log2(S/D)
//    times and one of all S records ~log2(S) times;
//  * the grid is persistent (as many CTAs as the card holds at once, each
//    striding over the queries);
//  * each query is one 16-byte record (src, qi, qf's bits, 0), and
//    segment_index_lookup does the whole host round trip in one call: one
//    asynchronous upload from pinned memory, the kernel, one asynchronous
//    download into pinned memory, one stream synchronise.
// A search of the device's whole CSR range, its offsets staged in shared
// memory, was slower at 1e6 queries on both traces timed: a warp's queries
// go to different devices, so every one of its ~log2(S/D) probes diverges.
// No atomics, no inter-CTA communication: deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
segment_index_kernel(const int4* __restrict__ seg, int s, const int* __restrict__ bkt,
                     int d_count, int k_count, int shift,
                     const int4* __restrict__ q, int n, int* __restrict__ out) {
  const int stride = gridDim.x * THREADS;
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < n; k += stride) {
    const int4 r = __ldg(q + k);                 // (src, qi, qf bits, 0)
    const int d = r.x;
    int idx;
    if (d < 0) {
      idx = -1;
    } else if (d >= d_count) {
      idx = s - 1;
    } else {
      const int qs = r.y;
      const float qfrac = __int_as_float(r.z);
      int b = qs < 0 ? 0 : qs >> shift;
      if (b >= k_count) b = k_count - 1;
      const int* bb = bkt + static_cast<size_t>(d) * (k_count + 1) + b;
      int lo = __ldg(bb), hi = __ldg(bb + 1);
      // upper bound in [lo, hi): the first record not <=lex the query
      while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        const int4 m = __ldg(seg + mid);
        const bool le = m.y < qs || (m.y == qs && __int_as_float(m.z) <= qfrac);
        if (le) lo = mid + 1; else hi = mid;
      }
      idx = lo - 1;
    }
    out[k] = idx;
  }
}

bool table_ok(int s, int d_count, int k_count, int shift) {
  return s >= 1 && d_count >= 0 && k_count >= 1 && shift >= 0 && shift < 31;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

int launch(const void* seg, int s, const void* bkt, int d_count, int k_count,
           int shift, int max_blocks, const void* q, int n, void* out,
           cudaStream_t st) {
  int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > max_blocks) blocks = max_blocks;
  segment_index_kernel<<<blocks, THREADS, 0, st>>>(
      static_cast<const int4*>(seg), s, static_cast<const int*>(bkt), d_count, k_count, shift,
      static_cast<const int4*>(q), n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The launch plan of a table of s segments over d_count devices, computed
// once per table: *max_blocks is the number of CTAs the card holds at once
// (SMs x resident CTAs per SM).  Returns 0, or a CUDA error
// (cudaErrorInvalidValue for a table the kernel does not take).
int segment_index_plan(int s, int d_count, int k_count, int shift, int* max_blocks) {
  if (!table_ok(s, d_count, k_count, shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_index_kernel, THREADS, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *max_blocks = sms * (per_sm > 0 ? per_sm : 1);
  return 0;
}

// seg: (s,) records of four int32, 16-byte aligned: dev, ti, the bits of
// the fp32 tf, and 0; sorted as above.  bkt: (d_count, k_count + 1) int32
// bucket bounds of 2^shift seconds.  q: (n,) query records of four int32, 16-byte aligned: src, qi,
// the bits of the fp32 qf, and 0.  Writes out (n,) int32.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 on success).
int segment_index_launch(const void* seg, int s, const void* bkt, int d_count,
                         int k_count, int shift, int max_blocks, const void* q, int n,
                         void* out, void* stream) {
  if (!table_ok(s, d_count, k_count, shift) || n < 1 || max_blocks < 1
      || !aligned16(seg) || !aligned16(q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch(seg, s, bkt, d_count, k_count, shift, max_blocks, q, n, out,
                static_cast<cudaStream_t>(stream));
}

// The whole lookup in one call: copies n query records from pinned host
// memory host_q to dev_q, launches the kernel into dev_out, copies the n
// results into pinned host memory host_out, all on `stream`, then
// synchronises the stream.  Returns 0 or the first CUDA error.
int segment_index_lookup(const void* seg, int s, const void* bkt, int d_count,
                         int k_count, int shift, int max_blocks, const void* host_q,
                         void* dev_q, int n, void* dev_out, void* host_out,
                         void* stream) {
  if (!table_ok(s, d_count, k_count, shift) || n < 1 || max_blocks < 1
      || !aligned16(seg) || !aligned16(dev_q)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemcpyAsync(dev_q, host_q, 16 * static_cast<size_t>(n),
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = launch(seg, s, bkt, d_count, k_count, shift, max_blocks, dev_q, n,
                        dev_out, st);
  if (rc != 0) return rc;
  err = cudaMemcpyAsync(host_out, dev_out, 4 * static_cast<size_t>(n),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}

}  // extern "C"
