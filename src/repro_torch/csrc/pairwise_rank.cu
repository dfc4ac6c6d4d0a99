// Pairwise RankNet loss over masked cohorts, with its score gradient in the
// same launch, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/pairwise_rank/kernel.py:61,
// pairwise_rank_pallas (body _kernel): the mean masked RankNet BCE over all
// ordered pairs i != j of a cohort, with (1, 1) sum/count accumulators that
// every step of the TPU's sequential (N/128)^2 grid revisits.  The TPU side
// has no backward kernel (its custom VJP differentiates the jnp oracle);
// here the gradient with respect to the scores comes out of the same launch
// as the loss, so the plain gradient's (B, N, N) matrices never exist on
// the card and a training step makes one pair-kernel launch.
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
//   dloss_b/ds_i = 2 / max(count_b, 1) * sum_j pm_ij (sigmoid(l_ij) - tgt_ij)
// (at l = 0 this equals autodiff of the plain form: the two terms' offsets
// from max() and |.| cancel).  The fused launch writes that (B, N) array;
// the autograd Function multiplies it by the upstream gradient.
//
// Bound on the card.  Per valid pair (pm != 0), counting every fp32
// add/mul/compare-select as one operation and each transcendental (expf,
// log1pf, expm1f, a division) as one:
//   loss alone       14 ops (hard), 16 (soft);
//   loss + gradient  18 ops (hard: + the reciprocal, the select and the
//                    weighted accumulate), 28 (soft: + two two-differences,
//                    the exps of the sinh form and the division).
// Bytes: 3 * 4 * B * N in, 12 * B out (+ 4 * B * N for the gradient).  At
// N = 30 the work is ~1e4 operations: one launch is all there is.  At
// N = 65,536 it is ~8e10 operations against 0.8 MB of input, far above the
// ~20 FLOP/byte fp32 ridge (67 TFLOP/s over 3.35 TB/s): bound by operations,
// in practice by the transcendentals on the SFU.
//
// Precision.  A row whose pair terms nearly cancel needs each term with
// far less absolute error than fp32's 6e-8 of 1 to keep its small gradient
// within 1e-5 of the row's largest: computed as sigmoid(l) - tgt in fp32,
// 26 of 350,000 random soft-target cohorts of 8 missed that, which is why
// the gradient kernel this one replaced ran in fp64.  Here every gradient term comes from a
// form without cancellation (pair_terms), so it keeps fp32's relative
// accuracy, and the row sums are fp64.  The loss terms keep relative
// accuracy too (log1p_01): a well-ranked cohort's loss is a sum of small
// terms alone.  scripts/pairwise_rank_precision.py holds both routes to 0
// misses on the card, the loss of well-separated cohorts to 1e-5 relative.
//
// Design.  The TPU's carried accumulator does not exist on a GPU, where
// CTAs run concurrently.
//  * N <= 32 (the imitation step: B = 16, N = 30): one group of lanes per
//    cohort (N rounded up to a power of two; B = 70,000 cohorts of 8 take
//    four cohorts a warp), columns by shuffle, the cohort's sums by a
//    butterfly of xor shuffles: no shared memory, no scratch, one pass.
//  * N > 32: a 2-D grid of 128-row tiles x column chunks, as many chunks
//    as fill the card once, so N = 65,536 runs ~16 warps an SM, not 4.  A
//    CTA stages its columns 128 at a time in shared memory (every thread
//    reads the same word: a broadcast), adds fp32 tile sums of the loss
//    into fp64 and the gradient terms into fp64 row sums, writes its
//    partials, and takes an integer ticket; the cohort's last CTA adds the
//    partials in a fixed order and writes loss, count and the gradient.
//    No float atomics: the results are deterministic.
// Batches past grid.y's 65,535 are launched in chunks of 65,535 cohorts by
// the same C call; a cohort's result does not depend on the chunking.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int ROWS = 128;       // threads per CTA; rows per CTA and column tile (tiles)
constexpr int GROUP_MAX = 32;   // cohorts of N <= 32 take the group kernel
constexpr int MAX_GRID_Y = 65535;
constexpr unsigned FULL = 0xffffffffu;

// The rounding error of s = fl(a - b): a - b == s + err exactly (TwoSum).
__device__ __forceinline__ float two_diff_err(float a, float b, float s) {
  const float bb = s - a;
  return (a - (s - bb)) + (-b - bb);
}

// One pair (i, j): the BCE term of the loss and, with GRAD, the gradient
// term sigmoid(l) - tgt, both from the one e = exp(-|l|) (the accurate
// expf: the gradient's relative accuracy rests on it).  Every gradient form
// is free of cancellation, so each term keeps fp32's relative accuracy
// (within the 1 ulp of the approximate reciprocal):
//   hard, tgt 1:   -e/(1+e) (l >= 0), -1/(1+e) (l < 0)
//   hard, tgt 0:    1/(1+e) (l >= 0),  e/(1+e) (l < 0)
//   hard, tgt 1/2: -/+ expm1(-|l|) / (2 (1+e))
//   soft: sigmoid(l) - sigmoid(d) = 2 sinh(delta/2) e^{-(|l|+|d|)/2}
//         / ((1+e)(1+e_d)), delta = (s_i - s_j) - (t_i - t_j) formed from
//         the exact two-differences of both, e_d = exp(-|d|) (which the
//         target needs anyway); 2 sinh(x/2) e^{-y/2} is written with expm1
//         for |delta| < 1 and as a difference of two exps above, so nothing
//         overflows.
// 1 / x for x in [1, 3], within 1 ulp (MUFU.RCP, no IEEE fix-up or range
// check: the argument is never denormal, zero or infinite).
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// log(1 + e) for e in [0, 1], within a few ulps relative: 2 atanh(z), z =
// e / (2 + e) in [0, 1/3], as 2 z (1 + w/3 + w^2/5 + ... + w^6/13) in w =
// z^2 <= 1/9 (the rest of the series is below 1.5e-8 relative).  The
// rounded 1 + e under a logarithm would lose a small e's low bits: a
// cohort ranked well, whose loss is made of such terms, would be off by
// up to 1e-3 relative.
__device__ __forceinline__ float log1p_01(float e) {
  const float z = e * rcp_approx(2.f + e);
  const float w = z * z;
  float p = 1.f / 13.f;
  p = fmaf(p, w, 1.f / 11.f);
  p = fmaf(p, w, 1.f / 9.f);
  p = fmaf(p, w, 1.f / 7.f);
  p = fmaf(p, w, 1.f / 5.f);
  p = fmaf(p, w, 1.f / 3.f);
  p = fmaf(p, w, 1.f);
  return 2.f * z * p;
}

template <bool HARD, bool GRAD>
__device__ __forceinline__ void pair_terms(float si, float sj, float ti, float tj,
                                           float& bce, float& g) {
  const float l = si - sj;
  const float d = ti - tj;
  const float e = expf(-fabsf(l));
  float tgt, ed = 0.f;
  if (HARD) {
    tgt = d > 0.f ? 1.f : (d < 0.f ? 0.f : 0.5f);
  } else {
    ed = expf(-fabsf(d));
    tgt = d >= 0.f ? 1.f / (1.f + ed) : ed / (1.f + ed);
  }
  bce = fmaxf(l, 0.f) - l * tgt + log1p_01(e);
  if (!GRAD) return;
  if (HARD) {
    const float inv = rcp_approx(1.f + e);
    if (__builtin_expect(d != 0.f, 1)) {
      // tgt 1: -e inv (l >= 0), -inv (l < 0); tgt 0: inv (l >= 0), e inv (l < 0)
      const bool one = d > 0.f;
      const float mag = (l >= 0.f) == one ? e * inv : inv;
      g = one ? -mag : mag;
    } else {                                       // tied targets: tgt 1/2
      g = (l >= 0.f ? -0.5f : 0.5f) * expm1f(-fabsf(l)) * inv;
    }
  } else {
    const float delta = (l - d) + (two_diff_err(si, sj, l) - two_diff_err(ti, tj, d));
    const float ad = fabsf(delta);
    const float half = -0.5f * (fabsf(l) + fabsf(d));
    const float num = ad < 1.f ? expf(half - 0.5f * ad) * expm1f(ad)
                               : expf(half + 0.5f * ad) - expf(half - 0.5f * ad);
    g = copysignf(num, delta) / ((1.f + e) * (1.f + ed));
  }
}

// Fixed-order tree over ROWS fp64 values in shared memory; result in v[0].
__device__ __forceinline__ void tree_sum(double* v) {
  for (int stride = ROWS / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) v[threadIdx.x] += v[threadIdx.x + stride];
  }
  __syncthreads();
}

// N <= 32: g lanes (N rounded up to a power of two) per cohort, one lane
// per row i, ROWS / g cohorts per CTA.  Column j's values come from lane j
// of the group by shuffle; the cohort's sums by a butterfly of xor
// shuffles, which leaves the same fp64 sum, in the same order, on every
// lane.  No shared memory, no scratch, one pass.
template <bool HARD, bool GRAD>
__global__ void __launch_bounds__(ROWS)
pairwise_rank_group(const float* __restrict__ s, const float* __restrict__ t,
                    const float* __restrict__ m, int b, int n, int g,
                    float* __restrict__ loss, double* __restrict__ count,
                    float* __restrict__ grad) {
  const int flat = blockIdx.x * ROWS + threadIdx.x;
  const int cohort = flat / g;
  const int i = flat & (g - 1);
  const bool ok = cohort < b && i < n;
  const size_t base = static_cast<size_t>(cohort) * n;
  const float si = ok ? s[base + i] : 0.f;
  const float ti = ok ? t[base + i] : 0.f;
  const float mi = ok ? m[base + i] : 0.f;
  float acc_s = 0.f, acc_c = 0.f;
  double acc_g = 0.0;
  for (int j = 0; j < n; ++j) {
    const float sj = __shfl_sync(FULL, si, j, g);
    const float tj = __shfl_sync(FULL, ti, j, g);
    const float mj = __shfl_sync(FULL, mi, j, g);
    const float pm = j == i ? 0.f : mi * mj;
    if (pm == 0.f) continue;
    float bce, gt;
    pair_terms<HARD, GRAD>(si, sj, ti, tj, bce, gt);
    acc_s = fmaf(bce, pm, acc_s);
    acc_c += pm;
    if (GRAD) acc_g += static_cast<double>(pm * gt);
  }
  double sum = acc_s, cnt = acc_c;
  for (int off = g / 2; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(FULL, sum, off, g);
    cnt += __shfl_xor_sync(FULL, cnt, off, g);
  }
  if (cohort >= b) return;
  const double denom = cnt > 1.0 ? cnt : 1.0;
  if (i == 0) {
    loss[cohort] = static_cast<float>(sum / denom);
    count[cohort] = cnt;
  }
  if (GRAD && i < n) grad[base + i] = static_cast<float>(2.0 / denom * acc_g);
}

// N > 32: grid (row_tiles * n_chunks, cohorts).  A CTA owns ROWS rows i
// (one thread each) and one chunk of columns, staged ROWS at a time in
// shared memory.  It writes its rows' fp64 gradient sums and its (sum,
// count) pair to scratch, then takes a ticket; the cohort's last CTA adds
// the partials in a fixed order (chunk 0 first; CTA 0 first, by a fixed
// tree) and writes loss, count and the scaled gradient.  The ticket is an
// integer atomicAdd on a counter that the last CTA resets; no float is
// added atomically, so the results do not depend on the CTAs' order.
template <bool HARD, bool GRAD>
__global__ void __launch_bounds__(ROWS)
pairwise_rank_tiles(const float* __restrict__ s, const float* __restrict__ t,
                    const float* __restrict__ m, int n, int chunk, int n_chunks,
                    double* __restrict__ part_g, double* __restrict__ part_s,
                    double* __restrict__ part_c, unsigned* __restrict__ tickets,
                    float* __restrict__ loss, double* __restrict__ count,
                    float* __restrict__ grad) {
  __shared__ float ss[ROWS], ts[ROWS], ms[ROWS];
  __shared__ double red_s[ROWS], red_c[ROWS];
  __shared__ bool last;
  const int row_tiles = gridDim.x / n_chunks;
  const int r = blockIdx.x % row_tiles, c = blockIdx.x / row_tiles;
  const int y = blockIdx.y;
  const size_t base = static_cast<size_t>(y) * n;
  const int i = r * ROWS + threadIdx.x;
  const bool row_ok = i < n;
  const float si = row_ok ? s[base + i] : 0.f;
  const float ti = row_ok ? t[base + i] : 0.f;
  const float mi = row_ok ? m[base + i] : 0.f;
  const int j_begin = c * chunk;
  const int j_end = min(n, j_begin + chunk);
  double acc_s = 0.0, acc_c = 0.0, acc_g = 0.0;
  for (int j0 = j_begin; j0 < j_end; j0 += ROWS) {
    const int j = j0 + threadIdx.x;
    __syncthreads();                       // the previous tile is consumed
    ss[threadIdx.x] = j < j_end ? s[base + j] : 0.f;
    ts[threadIdx.x] = j < j_end ? t[base + j] : 0.f;
    ms[threadIdx.x] = j < j_end ? m[base + j] : 0.f;
    __syncthreads();
    if (mi == 0.f) continue;
    const int cols = min(ROWS, j_end - j0);
    float tile_s = 0.f, tile_c = 0.f;
#pragma unroll 4
    for (int cc = 0; cc < cols; ++cc) {
      const float pm = (j0 + cc == i) ? 0.f : mi * ms[cc];
      if (pm == 0.f) continue;
      float bce, gt;
      pair_terms<HARD, GRAD>(si, ss[cc], ti, ts[cc], bce, gt);
      tile_s = fmaf(bce, pm, tile_s);
      tile_c += pm;
      if (GRAD) acc_g += static_cast<double>(pm * gt);
    }
    acc_s += tile_s;
    acc_c += tile_c;
  }
  if (GRAD && row_ok) {
    part_g[(static_cast<size_t>(y) * n_chunks + c) * n + i] = acc_g;
    __threadfence();
  }
  red_s[threadIdx.x] = acc_s;
  red_c[threadIdx.x] = acc_c;
  tree_sum(red_s);
  tree_sum(red_c);
  const size_t pb = static_cast<size_t>(y) * gridDim.x;
  if (threadIdx.x == 0) {
    part_s[pb + blockIdx.x] = red_s[0];
    part_c[pb + blockIdx.x] = red_c[0];
    __threadfence();
    last = atomicAdd(tickets + y, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double fs = 0.0, fc = 0.0;
  for (int p = threadIdx.x; p < static_cast<int>(gridDim.x); p += ROWS) {
    fs += __ldcg(part_s + pb + p);
    fc += __ldcg(part_c + pb + p);
  }
  red_s[threadIdx.x] = fs;
  red_c[threadIdx.x] = fc;
  tree_sum(red_s);
  tree_sum(red_c);
  const double cnt = red_c[0];
  const double denom = cnt > 1.0 ? cnt : 1.0;
  if (threadIdx.x == 0) {
    loss[y] = static_cast<float>(red_s[0] / denom);
    count[y] = cnt;
    tickets[y] = 0u;
  }
  if (GRAD) {
    const double scale = 2.0 / denom;
    const double* pg = part_g + static_cast<size_t>(y) * n_chunks * n;
    for (int k = threadIdx.x; k < n; k += ROWS) {
      double a = 0.0;
      for (int cc = 0; cc < n_chunks; ++cc) a += __ldcg(pg + static_cast<size_t>(cc) * n + k);
      grad[base + k] = static_cast<float>(scale * a);
    }
  }
}

int group_width(int n) {
  int g = 1;
  while (g < n) g <<= 1;
  return g;
}

// The column chunks of the tile kernel: enough CTAs per cohort to fill the
// card once (its SMs x the CTAs an SM holds), never more than one chunk per
// ROWS columns.  Depends on N and the card only, so a row's result does
// not depend on the batch it comes in.  Returns 0 or a CUDA error.
int tile_plan(int n, int* chunk, int* n_chunks) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, pairwise_rank_tiles<true, true>, ROWS, 0);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int tiles = (n + ROWS - 1) / ROWS;
  int want = resident / tiles;
  if (want < 1) want = 1;
  if (want > tiles) want = tiles;
  *chunk = ((tiles + want - 1) / want) * ROWS;
  *n_chunks = (n + *chunk - 1) / *chunk;
  return 0;
}

struct Scratch {
  double* part_g;
  double* part_s;
  double* part_c;
  unsigned* tickets;
  size_t bytes;
};

// Scratch of the tile kernel for b cohorts of n > GROUP_MAX with n_chunks
// column chunks: per-row gradient partials (with grad), per-CTA sums and
// counts, one ticket per cohort (zero on entry; the kernel leaves it zero).
Scratch scratch_layout(void* base, int b, int n, int n_chunks, bool grad) {
  const size_t grid_x = static_cast<size_t>((n + ROWS - 1) / ROWS) * n_chunks;
  const size_t ng = grad ? static_cast<size_t>(b) * n_chunks * n : 0;
  char* p = static_cast<char*>(base);
  Scratch sc;
  sc.part_g = reinterpret_cast<double*>(p);
  sc.part_s = sc.part_g + ng;
  sc.part_c = sc.part_s + b * grid_x;
  sc.tickets = reinterpret_cast<unsigned*>(sc.part_c + b * grid_x);
  sc.bytes = 8 * (ng + 2 * b * grid_x) + 4 * static_cast<size_t>(b);
  return sc;
}

template <bool HARD, bool GRAD>
int launch_all(const float* s, const float* t, const float* m, int b, int n,
               void* scratch, float* loss, double* count, float* grad,
               cudaStream_t st) {
  if (n <= GROUP_MAX) {
    const int g = group_width(n);
    const long long threads = static_cast<long long>(b) * g;
    const int blocks = static_cast<int>((threads + ROWS - 1) / ROWS);
    pairwise_rank_group<HARD, GRAD><<<blocks, ROWS, 0, st>>>(s, t, m, b, n, g, loss,
                                                             count, grad);
    return static_cast<int>(cudaGetLastError());
  }
  int chunk = 0, n_chunks = 0;
  const int rc = tile_plan(n, &chunk, &n_chunks);
  if (rc != 0) return rc;
  const int row_tiles = (n + ROWS - 1) / ROWS;
  const Scratch sc = scratch_layout(scratch, b, n, n_chunks, GRAD);
  const size_t grid_x = static_cast<size_t>(row_tiles) * n_chunks;
  for (int b0 = 0; b0 < b; b0 += MAX_GRID_Y) {      // grid.y chunks of cohorts
    const int rows = b - b0 < MAX_GRID_Y ? b - b0 : MAX_GRID_Y;
    const size_t off = static_cast<size_t>(b0) * n;
    const dim3 grid(static_cast<unsigned>(grid_x), rows);
    pairwise_rank_tiles<HARD, GRAD><<<grid, ROWS, 0, st>>>(
        s + off, t + off, m + off, n, chunk, n_chunks,
        GRAD ? sc.part_g + static_cast<size_t>(b0) * n_chunks * n : nullptr,
        sc.part_s + b0 * grid_x, sc.part_c + b0 * grid_x, sc.tickets + b0,
        loss + b0, count + b0, GRAD ? grad + off : nullptr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

bool shape_ok(int b, int n) {
  return b >= 1 && n >= 1 && n <= INT_MAX - ROWS
         && static_cast<long long>(b) * group_width(n < GROUP_MAX ? n : GROUP_MAX) <= INT_MAX;
}

}  // namespace

extern "C" {

// Bytes of zeroed scratch pairwise_rank_launch needs for (b, n): 0 for
// n <= 32, which needs none; -1 for a shape it does not take, or a CUDA
// error code's negation below -1 if the card cannot be queried.
long long pairwise_rank_scratch_bytes(int b, int n, int want_grad) {
  if (!shape_ok(b, n)) return -1;
  if (n <= GROUP_MAX) return 0;
  int chunk = 0, n_chunks = 0;
  const int rc = tile_plan(n, &chunk, &n_chunks);
  if (rc != 0) return -1 - rc;
  return static_cast<long long>(scratch_layout(nullptr, b, n, n_chunks, want_grad != 0).bytes);
}

// scores, targets, mask: (b, n) fp32, contiguous.  scratch: the zeroed
// bytes pairwise_rank_scratch_bytes gives (ignored for n <= 32).  Writes
// loss (b,) fp32 and count (b,) fp64 and, with want_grad, grad (b, n) fp32
// = 2 / max(count, 1) * sum_j pm_ij (sigmoid(l_ij) - tgt_ij), the
// gradient of each row's loss before the upstream factor.  One launch (per
// 65,535 cohorts for n > 32).  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success).
int pairwise_rank_launch(const void* scores, const void* targets,
                         const void* mask, int b, int n, int hard,
                         int want_grad, void* scratch, void* loss, void* count,
                         void* grad, void* stream) {
  if (!shape_ok(b, n) || (want_grad && grad == nullptr)
      || (n > GROUP_MAX && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* s = static_cast<const float*>(scores);
  const float* t = static_cast<const float*>(targets);
  const float* m = static_cast<const float*>(mask);
  float* l = static_cast<float*>(loss);
  double* c = static_cast<double*>(count);
  float* g = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hard) {
    return want_grad ? launch_all<true, true>(s, t, m, b, n, scratch, l, c, g, st)
                     : launch_all<true, false>(s, t, m, b, n, scratch, l, c, g, st);
  }
  return want_grad ? launch_all<false, true>(s, t, m, b, n, scratch, l, c, g, st)
                   : launch_all<false, false>(s, t, m, b, n, scratch, l, c, g, st);
}

}  // extern "C"
