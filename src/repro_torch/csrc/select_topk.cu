// Fused Q-net scoring -> top-K cohort selection, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select_topk/kernel.py,
// select_topk_pallas (body _kernel): per tile of candidates, the 3-layer
// Q-net MLP (F -> H -> H -> 1, ReLU, fp32), + bias, masked rows sunk to
// NEG_INF, and a running top-K carried across the TPU's sequential grid.
//
// Contract (the plain version, kernels/select_topk/ref.py, is held to it):
//   order is score descending, then index ascending (lowest-index ties);
//   masked rows score NEG_INF, so they come after every valid row and,
//   having real indices, before every virgin slot (NEG_INF, INT_MAX);
//   the caller asks for k <= N and reads the first k of K_pad slots.
//
// Bound on the card: 2*N*(F*H + H*H + H) fp32 FLOPs, about 9.1 GFLOP at
// N = 1e6, F = 6, H = 64, against (F + 2)*4*N bytes of input, about 32 MB:
// 284 FLOP per byte, far above the H100's ~20 FLOP/byte fp32 ridge
// (67 TFLOP/s over 3.35 TB/s), so the kernel is bound by fp32 CUDA-core
// FMAs.  Tensor cores (TF32, bf16) would move scores off the fp32 reference
// and are left out.  What the design does about the bound: every FMA is an
// fp32 FMA on a weight held in shared memory and broadcast to the warp,
// read four at a time (LDS.128), with the hidden activations in registers;
// the (N,) score vector never reaches device memory.
//
// Design.  The TPU carried the top-K in an output block every grid step
// revisits; CTAs on Hopper run concurrently, so the selection is two-pass:
//   pass 1 (score_tile_topk): one CTA per tile of 256 candidates, one thread
//     per row.  The weights are staged in shared memory (zero-padded to
//     HP = 32, 64 or 128 hidden units, which leaves every sum unchanged),
//     each thread runs its row's MLP with FMAs in a fixed k-ascending order,
//     and the tile is bitonic-sorted in shared memory by the comparator;
//     its best K_pad entries go to a scratch list (virgin-filled past 256).
//   pass 2 (merge_pairs): a fixed-order tree of pairwise merges.  Each CTA
//     merges two sorted lists into the best K_pad by ranking every entry
//     with a binary search in the other list (A wins exact ties, so ranks
//     form a permutation).  No atomics: the result is exact and
//     deterministic.
// Limits: F <= 64, H <= 128, K_pad <= 1024, checked here and by the wrapper.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TILE = 256;
constexpr float NEG_INF = -3.0e38f;
constexpr int VIRGIN_IDX = INT_MAX;
constexpr int MAX_F = 64;
constexpr int MAX_H = 128;
constexpr int MAX_K_PAD = 1024;

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int HP>
__global__ void __launch_bounds__(TILE)
score_tile_topk(const float* __restrict__ feats, const float* __restrict__ mask,
                const float* __restrict__ bias, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, int n, int f_dim, int h_dim,
                int k_pad, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;                     // [f_dim][HP]
  float* w2t = w1s + f_dim * HP;         // [HP][HP], w2t[j][k] = w2[k][j]
  float* b1s = w2t + HP * HP;            // [HP]
  float* b2s = b1s + HP;                 // [HP]
  float* w3s = b2s + HP;                 // [HP]
  float* sv = w3s + HP;                  // [TILE] sort keys: score
  int* si = reinterpret_cast<int*>(sv + TILE);  // [TILE] sort keys: index

  const int tid = threadIdx.x;
  for (int e = tid; e < f_dim * HP; e += TILE) {
    const int f = e / HP, j = e - f * HP;
    w1s[e] = j < h_dim ? w1[f * h_dim + j] : 0.f;
  }
  for (int e = tid; e < HP * HP; e += TILE) {
    const int j = e / HP, k = e - j * HP;
    w2t[e] = (j < h_dim && k < h_dim) ? w2[k * h_dim + j] : 0.f;
  }
  for (int j = tid; j < HP; j += TILE) {
    const bool live = j < h_dim;
    b1s[j] = live ? b1[j] : 0.f;
    b2s[j] = live ? b2[j] : 0.f;
    w3s[j] = live ? w3[j] : 0.f;
  }
  __syncthreads();

  const int row = blockIdx.x * TILE + tid;
  float score = NEG_INF;
  int idx = VIRGIN_IDX;                  // rows past N are virgin slots
  if (row < n) {
    float h1[HP];
#pragma unroll
    for (int j = 0; j < HP; ++j) h1[j] = 0.f;
    const float* x = feats + static_cast<size_t>(row) * f_dim;
    for (int f = 0; f < f_dim; ++f) {
      const float xf = __ldg(x + f);
      const float4* w = reinterpret_cast<const float4*>(w1s + f * HP);
#pragma unroll
      for (int j4 = 0; j4 < HP / 4; ++j4) {
        const float4 wv = w[j4];
        h1[4 * j4 + 0] = fmaf(xf, wv.x, h1[4 * j4 + 0]);
        h1[4 * j4 + 1] = fmaf(xf, wv.y, h1[4 * j4 + 1]);
        h1[4 * j4 + 2] = fmaf(xf, wv.z, h1[4 * j4 + 2]);
        h1[4 * j4 + 3] = fmaf(xf, wv.w, h1[4 * j4 + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < HP; ++j) h1[j] = fmaxf(h1[j] + b1s[j], 0.f);
    float s = 0.f;
#pragma unroll 1
    for (int j = 0; j < HP; ++j) {
      const float4* w = reinterpret_cast<const float4*>(w2t + j * HP);
      float acc = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < HP / 4; ++k4) {
        const float4 wv = w[k4];
        acc = fmaf(h1[4 * k4 + 0], wv.x, acc);
        acc = fmaf(h1[4 * k4 + 1], wv.y, acc);
        acc = fmaf(h1[4 * k4 + 2], wv.z, acc);
        acc = fmaf(h1[4 * k4 + 3], wv.w, acc);
      }
      s = fmaf(fmaxf(acc + b2s[j], 0.f), w3s[j], s);
    }
    s = (s + b3[0]) + bias[row];
    score = mask[row] > 0.f ? s : NEG_INF;
    idx = row;
  }

  // bitonic sort of the tile in "before" order (position 0 = best)
  sv[tid] = score;
  si[tid] = idx;
  __syncthreads();
  for (int size = 2; size <= TILE; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const int p = tid ^ stride;
      if (p > tid) {
        const float av = sv[tid], bv = sv[p];
        const int ai = si[tid], bi = si[p];
        const bool asc = (tid & size) == 0;
        if (asc ? before(bv, bi, av, ai) : before(av, ai, bv, bi)) {
          sv[tid] = bv; si[tid] = bi;
          sv[p] = av; si[p] = ai;
        }
      }
      __syncthreads();
    }
  }

  const size_t base = static_cast<size_t>(blockIdx.x) * k_pad;
  for (int j = tid; j < k_pad; j += TILE) {
    out_v[base + j] = j < TILE ? sv[j] : NEG_INF;
    out_i[base + j] = j < TILE ? si[j] : VIRGIN_IDX;
  }
}

// Merges lists 2b and 2b+1 of src (each k_pad entries in "before" order)
// into list b of dst, keeping the best k_pad.  blockDim.x == k_pad.
__global__ void merge_pairs(const float* __restrict__ src_v,
                            const int* __restrict__ src_i, int n_lists,
                            int k_pad, float* __restrict__ dst_v,
                            int* __restrict__ dst_i) {
  extern __shared__ __align__(16) float msm[];
  float* av = msm;
  int* ai = reinterpret_cast<int*>(av + k_pad);
  float* bv = reinterpret_cast<float*>(ai + k_pad);
  int* bi = reinterpret_cast<int*>(bv + k_pad);

  const int t = threadIdx.x;
  const int a_list = 2 * blockIdx.x;
  const size_t a_off = static_cast<size_t>(a_list) * k_pad;
  const size_t out = static_cast<size_t>(blockIdx.x) * k_pad;
  if (a_list + 1 >= n_lists) {           // odd list out: carried as it is
    dst_v[out + t] = src_v[a_off + t];
    dst_i[out + t] = src_i[a_off + t];
    return;
  }
  const size_t b_off = a_off + k_pad;
  av[t] = src_v[a_off + t];
  ai[t] = src_i[a_off + t];
  bv[t] = src_v[b_off + t];
  bi[t] = src_i[b_off + t];
  __syncthreads();

  {  // A[t] lands after t entries of A and every B strictly before it
    const float x = av[t];
    const int xi = ai[t];
    int lo = 0, hi = k_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (before(bv[mid], bi[mid], x, xi)) lo = mid + 1; else hi = mid;
    }
    const int r = t + lo;
    if (r < k_pad) { dst_v[out + r] = x; dst_i[out + r] = xi; }
  }
  {  // B[t] lands after t entries of B and every A not after it
    const float x = bv[t];
    const int xi = bi[t];
    int lo = 0, hi = k_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (!before(x, xi, av[mid], ai[mid])) lo = mid + 1; else hi = mid;
    }
    const int r = t + lo;
    if (r < k_pad) { dst_v[out + r] = x; dst_i[out + r] = xi; }
  }
}

template <int HP>
cudaError_t launch_scores(const float* feats, const float* mask,
                          const float* bias, const float* w1, const float* b1,
                          const float* w2, const float* b2, const float* w3,
                          const float* b3, int n, int f_dim, int h_dim,
                          int k_pad, float* out_v, int* out_i, int n_tiles,
                          cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(f_dim * HP + HP * HP + 3 * HP + TILE)
                          * sizeof(float) + TILE * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_tile_topk<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  score_tile_topk<HP><<<n_tiles, TILE, smem, stream>>>(
      feats, mask, bias, w1, b1, w2, b2, w3, b3, n, f_dim, h_dim, k_pad,
      out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch: (n_tiles + ceil(n_tiles / 2)) * k_pad floats in scratch_v and
// as many ints in scratch_i, n_tiles = ceil(n / 256).  Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (0 on success).
int select_topk_launch(const void* feats, const void* mask, const void* bias,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, int n,
                       int f_dim, int h_dim, int k_pad, void* scratch_v,
                       void* scratch_i, void* out_v, void* out_i,
                       void* stream) {
  if (n < 1 || n > INT_MAX - TILE || f_dim < 1 || f_dim > MAX_F ||
      h_dim < 1 || h_dim > MAX_H || k_pad < 8 || k_pad > MAX_K_PAD ||
      k_pad % 8 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (n + TILE - 1) / TILE;
  float* v0 = static_cast<float*>(scratch_v);
  int* i0 = static_cast<int*>(scratch_i);
  float* v1 = v0 + static_cast<size_t>(n_tiles) * k_pad;
  int* i1 = i0 + static_cast<size_t>(n_tiles) * k_pad;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  float* first_v = n_tiles == 1 ? ov : v0;
  int* first_i = n_tiles == 1 ? oi : i0;

  const float* args[9] = {
      static_cast<const float*>(feats), static_cast<const float*>(mask),
      static_cast<const float*>(bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3)};
  cudaError_t err;
  if (h_dim <= 32) {
    err = launch_scores<32>(args[0], args[1], args[2], args[3], args[4],
                            args[5], args[6], args[7], args[8], n, f_dim,
                            h_dim, k_pad, first_v, first_i, n_tiles, s);
  } else if (h_dim <= 64) {
    err = launch_scores<64>(args[0], args[1], args[2], args[3], args[4],
                            args[5], args[6], args[7], args[8], n, f_dim,
                            h_dim, k_pad, first_v, first_i, n_tiles, s);
  } else {
    err = launch_scores<128>(args[0], args[1], args[2], args[3], args[4],
                             args[5], args[6], args[7], args[8], n, f_dim,
                             h_dim, k_pad, first_v, first_i, n_tiles, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* cur_v = v0;
  const int* cur_i = i0;
  bool cur_in_first = true;
  int count = n_tiles;
  const size_t merge_smem = static_cast<size_t>(4) * k_pad * sizeof(float);
  while (count > 1) {
    const int next = (count + 1) / 2;
    float* dv;
    int* di;
    if (next == 1) {
      dv = ov; di = oi;
    } else if (cur_in_first) {
      dv = v1; di = i1;
    } else {
      dv = v0; di = i0;
    }
    merge_pairs<<<next, k_pad, merge_smem, s>>>(cur_v, cur_i, count, k_pad,
                                                dv, di);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur_v = dv;
    cur_i = di;
    cur_in_first = !cur_in_first;
    count = next;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
