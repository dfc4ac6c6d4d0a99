// Pairwise RankNet loss over masked cohorts, forward and score gradient,
// written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pairwise_rank/kernel.py:61,
// pairwise_rank_pallas (body _kernel): the mean masked RankNet BCE over all
// ordered pairs i != j of a cohort, with (1, 1) sum/count accumulators that
// every step of the TPU's sequential (N/128)^2 grid revisits.  The TPU side
// has no backward kernel (its custom VJP differentiates the jnp oracle);
// here the gradient with respect to the scores is a kernel too, so the plain
// gradient's (B, N, N) matrices never exist on the card.
//
// Contract (the plain version, kernels/pairwise_rank/ref.py, is held to it),
// per batch row b of scores s, targets t, mask m, all (B, N) fp32:
//   l_ij   = s_i - s_j
//   tgt_ij = 1 / 0 / 0.5 by the sign of t_i - t_j        (hard)
//          = sigmoid(t_i - t_j), the stable form          (soft)
//   pm_ij  = m_i * m_j, 0 on the diagonal
//   bce_ij = max(l, 0) - l * tgt + log1p(exp(-|l|))
//   loss_b = sum_ij pm_ij * bce_ij / max(count_b, 1),  count_b = sum_ij pm_ij
// Because pm is symmetric, tgt_ji = 1 - tgt_ij and sigmoid(-l) = 1 -
// sigmoid(l), the (i, j) and (j, i) terms of the score gradient fold into
// one row reduction:
//   dL/ds_i = g_b * 2 / max(count_b, 1) * sum_j pm_ij (sigmoid(l_ij) - tgt_ij)
// (at l = 0 this equals autodiff of the plain form: the two terms' offsets
// from max() and |.| cancel).
//
// Bound on the card.  Per valid pair (pm != 0), counting every fp32
// add/mul/compare-select as one operation and expf, log1pf and the
// sigmoid's expf as one operation each (they are several instructions on
// the SFU and the FMA pipes):
//   forward  14 ops (hard), 16 (soft): two differences, the target, pm,
//            the BCE's seven (max, mul, sub, abs, exp, log1p, add), the
//            weighted accumulate (2) and the count (1);
//   gradient 10 ops (hard), 12 (soft): two differences, the target, pm,
//            the sigmoid (3), the subtraction and the accumulate (2).
// The bound counts them at the fp32 rate, the type of the function's
// inputs and outputs, although the gradient kernel evaluates them in fp64
// (half that rate on the H100 SXM): a row whose pair terms nearly
// cancel needs each term far more exact than fp32's 6e-8 to keep its small
// gradient within 1e-5 of its largest.  With fp32 terms 26 of 350,000
// random soft-target cohorts of 8 missed that against an fp64 evaluation
// (scripts/pairwise_rank_precision.py); with fp64 terms none did.
// Bytes: 3 * 4 * B * N in, 4 * B out (+ 4 * B * N out for the gradient).
// At N = 30 the work is ~1e4 operations: launch latency is all there is.
// At N = 65,536 it is 6e10 operations against 0.8 MB of input, far above
// the ~20 FLOP/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s): the kernel is
// bound by operations, and in practice by the transcendentals.  What the
// design does about it: the column tile sits in shared memory and every
// thread of the CTA reads the same word (a broadcast, no bank conflicts);
// the N^2 pair matrices never reach device memory; masked pairs skip the
// math.
//
// Design.  The TPU's carried accumulator does not exist on a GPU, where
// CTAs run concurrently.  Grid (ceil(N / 128), B): each CTA owns 128 rows i
// (one thread per row) and loops over every 128-wide column tile j staged
// in shared memory.  Forward: a thread sums a tile in fp32 and adds the
// tile's sum to an fp64 row accumulator, so a row of 65,536 pairs keeps
// ~1e-7 of relative error (its terms are all >= 0: no cancellation).  The
// gradient's terms and sums are fp64 throughout.  Forward: the CTA reduces
// its rows' (sum, count) in fp64 by a fixed tree and writes one partial per
// CTA; a second launch reduces each batch row's partials in a fixed order
// (fp64: the count of 65,536^2 pairs is past fp32's exact integers) and
// writes loss (B,) fp32 and count (B,) fp64.  Gradient: the same grid, one
// writer per i, scaled by the saved count.  No atomics: the results are
// deterministic.  Batches past grid.y's 65,535 are launched in chunks of
// 65,535 rows by the same C call; each batch row's reduction does not
// depend on the chunking.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int ROWS = 128;     // rows per CTA, one thread each; = column tile
constexpr int FINAL = 256;    // threads of the per-batch-row final reduction
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ float stable_sigmoid(float x) {
  const float e = expf(-fabsf(x));
  return x >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);
}

template <bool HARD>
__device__ __forceinline__ float pair_target(float d) {
  if (HARD) return d > 0.f ? 1.f : (d < 0.f ? 0.f : 0.5f);
  return stable_sigmoid(d);
}

// Fixed-order tree over ROWS fp64 values in shared memory; result in v[0].
__device__ __forceinline__ void tree_sum(double* v) {
  for (int stride = ROWS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) v[threadIdx.x] += v[threadIdx.x + stride];
  }
  __syncthreads();
}

// Pass 1 of the forward: per CTA, sum over its rows i and every column j of
// pm_ij * bce_ij and of pm_ij, into part_sum / part_cnt [B][n_blocks].
template <bool HARD>
__global__ void __launch_bounds__(ROWS)
pairwise_rank_fwd_rows(const float* __restrict__ s, const float* __restrict__ t,
                       const float* __restrict__ m, int n,
                       double* __restrict__ part_sum,
                       double* __restrict__ part_cnt) {
  __shared__ float ss[ROWS], ts[ROWS], ms[ROWS];
  __shared__ double red_s[ROWS], red_c[ROWS];
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const int i = blockIdx.x * ROWS + threadIdx.x;
  const bool row_ok = i < n;
  const float si = row_ok ? s[base + i] : 0.f;
  const float ti = row_ok ? t[base + i] : 0.f;
  const float mi = row_ok ? m[base + i] : 0.f;
  double acc_s = 0.0, acc_c = 0.0;
  for (int j0 = 0; j0 < n; j0 += ROWS) {
    const int j = j0 + threadIdx.x;
    __syncthreads();                       // the previous tile is consumed
    ss[threadIdx.x] = j < n ? s[base + j] : 0.f;
    ts[threadIdx.x] = j < n ? t[base + j] : 0.f;
    ms[threadIdx.x] = j < n ? m[base + j] : 0.f;
    __syncthreads();
    if (mi == 0.f) continue;
    const int cols = min(ROWS, n - j0);
    float tile_s = 0.f, tile_c = 0.f;
    for (int c = 0; c < cols; ++c) {
      const float pm = (j0 + c == i) ? 0.f : mi * ms[c];
      if (pm == 0.f) continue;
      const float l = si - ss[c];
      const float tgt = pair_target<HARD>(ti - ts[c]);
      const float bce = fmaxf(l, 0.f) - l * tgt + log1pf(expf(-fabsf(l)));
      tile_s = fmaf(bce, pm, tile_s);
      tile_c += pm;
    }
    acc_s += tile_s;
    acc_c += tile_c;
  }
  red_s[threadIdx.x] = acc_s;
  red_c[threadIdx.x] = acc_c;
  tree_sum(red_s);
  tree_sum(red_c);
  if (threadIdx.x == 0) {
    const size_t p = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    part_sum[p] = red_s[0];
    part_cnt[p] = red_c[0];
  }
}

// Pass 2 of the forward: one CTA per batch row reduces its n_blocks
// partials in a fixed order (strided per thread, then a fixed tree).
__global__ void __launch_bounds__(FINAL)
pairwise_rank_fwd_final(const double* __restrict__ part_sum,
                        const double* __restrict__ part_cnt, int n_blocks,
                        float* __restrict__ loss, double* __restrict__ count) {
  __shared__ double red_s[FINAL], red_c[FINAL];
  const size_t base = static_cast<size_t>(blockIdx.x) * n_blocks;
  double acc_s = 0.0, acc_c = 0.0;
  for (int p = threadIdx.x; p < n_blocks; p += FINAL) {
    acc_s += part_sum[base + p];
    acc_c += part_cnt[base + p];
  }
  red_s[threadIdx.x] = acc_s;
  red_c[threadIdx.x] = acc_c;
  for (int stride = FINAL / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) {
      red_s[threadIdx.x] += red_s[threadIdx.x + stride];
      red_c[threadIdx.x] += red_c[threadIdx.x + stride];
    }
  }
  if (threadIdx.x == 0) {
    const double c = red_c[0];
    loss[blockIdx.x] = static_cast<float>(red_s[0] / (c > 1.0 ? c : 1.0));
    count[blockIdx.x] = c;
  }
}

__device__ __forceinline__ double stable_sigmoid_d(double x) {
  const double e = exp(-fabs(x));
  return x >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
}

// The gradient: grad[b][i] = g[b] * 2 / max(count[b], 1)
//                            * sum_j pm_ij (sigmoid(l_ij) - tgt_ij),
// every term and the sum in fp64 (the inputs are fp32, so l_ij and the
// target difference are exact in fp64).
template <bool HARD>
__global__ void __launch_bounds__(ROWS)
pairwise_rank_bwd_rows(const float* __restrict__ s, const float* __restrict__ t,
                       const float* __restrict__ m,
                       const double* __restrict__ count,
                       const float* __restrict__ g, int n,
                       float* __restrict__ grad) {
  __shared__ float ss[ROWS], ts[ROWS], ms[ROWS];
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const int i = blockIdx.x * ROWS + threadIdx.x;
  const bool row_ok = i < n;
  const float si = row_ok ? s[base + i] : 0.f;
  const float ti = row_ok ? t[base + i] : 0.f;
  const float mi = row_ok ? m[base + i] : 0.f;
  double acc = 0.0;
  for (int j0 = 0; j0 < n; j0 += ROWS) {
    const int j = j0 + threadIdx.x;
    __syncthreads();
    ss[threadIdx.x] = j < n ? s[base + j] : 0.f;
    ts[threadIdx.x] = j < n ? t[base + j] : 0.f;
    ms[threadIdx.x] = j < n ? m[base + j] : 0.f;
    __syncthreads();
    if (mi == 0.f) continue;
    const int cols = min(ROWS, n - j0);
    for (int c = 0; c < cols; ++c) {
      const float pm = (j0 + c == i) ? 0.f : mi * ms[c];
      if (pm == 0.f) continue;
      const double d = static_cast<double>(ti) - static_cast<double>(ts[c]);
      const double tgt = HARD ? (d > 0.0 ? 1.0 : (d < 0.0 ? 0.0 : 0.5))
                              : stable_sigmoid_d(d);
      const double l = static_cast<double>(si) - static_cast<double>(ss[c]);
      acc = fma(static_cast<double>(pm), stable_sigmoid_d(l) - tgt, acc);
    }
  }
  if (row_ok) {
    const double c = count[blockIdx.y];
    grad[base + i] = static_cast<float>(
        static_cast<double>(g[blockIdx.y]) * 2.0 / (c > 1.0 ? c : 1.0) * acc);
  }
}

bool shape_ok(int b, int n) {
  return b >= 1 && n >= 1 && n <= INT_MAX - ROWS;
}

}  // namespace

extern "C" {

// scores, targets, mask: (b, n) fp32, contiguous.  Scratch: 2 * b *
// ceil(n / 128) doubles (per-CTA sums, then counts).  Writes loss (b,) fp32
// and count (b,) fp64.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (0 on success).
int pairwise_rank_fwd_launch(const void* scores, const void* targets,
                             const void* mask, int b, int n, int hard,
                             void* scratch, void* loss, void* count,
                             void* stream) {
  if (!shape_ok(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + ROWS - 1) / ROWS;
  double* part_sum = static_cast<double*>(scratch);
  double* part_cnt = part_sum + static_cast<size_t>(b) * n_blocks;
  for (int b0 = 0; b0 < b; b0 += MAX_GRID_Y) {      // grid.y chunks of rows
    const int rows = b - b0 < MAX_GRID_Y ? b - b0 : MAX_GRID_Y;
    const size_t off = static_cast<size_t>(b0) * n;
    const size_t poff = static_cast<size_t>(b0) * n_blocks;
    const dim3 grid(n_blocks, rows);
    const float* s = static_cast<const float*>(scores) + off;
    const float* t = static_cast<const float*>(targets) + off;
    const float* m = static_cast<const float*>(mask) + off;
    if (hard) {
      pairwise_rank_fwd_rows<true><<<grid, ROWS, 0, st>>>(
          s, t, m, n, part_sum + poff, part_cnt + poff);
    } else {
      pairwise_rank_fwd_rows<false><<<grid, ROWS, 0, st>>>(
          s, t, m, n, part_sum + poff, part_cnt + poff);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  pairwise_rank_fwd_final<<<b, FINAL, 0, st>>>(
      part_sum, part_cnt, n_blocks, static_cast<float*>(loss),
      static_cast<double*>(count));
  return static_cast<int>(cudaGetLastError());
}

// count: (b,) fp64 from the forward; grad_loss: (b,) fp32, the gradient
// flowing into each row's loss.  Writes grad (b, n) fp32.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int pairwise_rank_bwd_launch(const void* scores, const void* targets,
                             const void* mask, const void* count,
                             const void* grad_loss, int b, int n, int hard,
                             void* grad, void* stream) {
  if (!shape_ok(b, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int b0 = 0; b0 < b; b0 += MAX_GRID_Y) {      // grid.y chunks of rows
    const int rows = b - b0 < MAX_GRID_Y ? b - b0 : MAX_GRID_Y;
    const size_t off = static_cast<size_t>(b0) * n;
    const dim3 grid((n + ROWS - 1) / ROWS, rows);
    const float* s = static_cast<const float*>(scores) + off;
    const float* t = static_cast<const float*>(targets) + off;
    const float* m = static_cast<const float*>(mask) + off;
    const double* c = static_cast<const double*>(count) + b0;
    const float* g = static_cast<const float*>(grad_loss) + b0;
    float* out = static_cast<float*>(grad) + off;
    if (hard) {
      pairwise_rank_bwd_rows<true><<<grid, ROWS, 0, st>>>(s, t, m, c, g, n, out);
    } else {
      pairwise_rank_bwd_rows<false><<<grid, ROWS, 0, st>>>(s, t, m, c, g, n, out);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
