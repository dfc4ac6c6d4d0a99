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
//   pass 1: one CTA per tile of 256 candidates, one thread per row, then the
//     tile is bitonic-sorted in shared memory by the comparator and its best
//     L0 = min(K_pad, 256) entries go to a scratch list.  Two scorers, with
//     the same FMAs in the same fixed k-ascending order, so a row's score
//     does not depend on which one ran:
//       score_tile_topk<HP> (H <= 128 and the weights fit in shared memory):
//         the weights are staged in shared memory, zero-padded to HP = 32,
//         64 or 128 hidden units (which leaves every sum unchanged), and a
//         row's hidden activations stay in registers;
//       score_tile_topk_wide (any F and H): the weights are read through the
//         read-only path (__ldg; every lane of a warp reads the same word, a
//         broadcast), 32 hidden units' sums are kept in registers at a time,
//         and the first layer's activations go to a global scratch,
//         column-major [H][rows] so a warp's accesses coalesce.
//   pass 2 (merge_pairs): a fixed-order tree of pairwise merges.  Lists
//     double in length per level up to K_pad (256 -> 512 -> ... -> K_pad);
//     each CTA merges two sorted lists by ranking every entry with a binary
//     search in the other list (A wins exact ties, so ranks form a
//     permutation), its threads looping over the entries.  Lists of up to
//     3072 entries are staged in shared memory, longer ones are searched in
//     device memory.  An odd list out is carried, padded with virgin slots.
//     No atomics: the result is exact and deterministic.
// Limits: 1 <= N < 2^31 - 256 and K_pad <= N rounded up to 8; any F and H.

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TILE = 256;
constexpr float NEG_INF = -3.0e38f;
constexpr int VIRGIN_IDX = INT_MAX;
constexpr int MAX_SMEM = 232448;          // a CTA's shared memory on sm_90
constexpr int MERGE_SMEM_LIST = 3072;     // longest list merged in smem
constexpr int MERGE_THREADS = 256;
constexpr int WJ = 32;                    // wide scorer: units per register chunk

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Bitonic sort of the CTA's TILE (score, index) pairs in "before" order
// (position 0 = best), then the first list_len (<= TILE) go to the tile's
// scratch list.
__device__ __forceinline__ void sort_tile_and_write(float* sv, int* si,
                                                    float score, int idx,
                                                    int list_len,
                                                    float* __restrict__ out_v,
                                                    int* __restrict__ out_i) {
  const int tid = threadIdx.x;
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
  const size_t base = static_cast<size_t>(blockIdx.x) * list_len;
  if (tid < list_len) {
    out_v[base + tid] = sv[tid];
    out_i[base + tid] = si[tid];
  }
}

size_t narrow_smem(int f_dim, int hp) {
  return static_cast<size_t>(f_dim * hp + hp * hp + 3 * hp + TILE) * sizeof(float)
         + TILE * sizeof(int);
}

// 32, 64 or 128: the padded width of the shared-memory scorer; 0: the wide one.
int pick_hp(int f_dim, int h_dim) {
  const int hp = h_dim <= 32 ? 32 : (h_dim <= 64 ? 64 : (h_dim <= 128 ? 128 : 0));
  if (hp == 0 || narrow_smem(f_dim, hp) > static_cast<size_t>(MAX_SMEM)) return 0;
  return hp;
}

template <int HP>
__global__ void __launch_bounds__(TILE)
score_tile_topk(const float* __restrict__ feats, const float* __restrict__ mask,
                const float* __restrict__ bias, const float* __restrict__ w1,
                const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const float* __restrict__ w3,
                const float* __restrict__ b3, int n, int f_dim, int h_dim,
                int list_len, float* __restrict__ out_v, int* __restrict__ out_i) {
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
  sort_tile_and_write(sv, si, score, idx, list_len, out_v, out_i);
}

// Any F and H: weights through __ldg, the first layer's activations in
// h1buf[j * n_pad + row] (n_pad = tiles * TILE).
__global__ void __launch_bounds__(TILE)
score_tile_topk_wide(const float* __restrict__ feats,
                     const float* __restrict__ mask,
                     const float* __restrict__ bias,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     const float* __restrict__ w3, const float* __restrict__ b3,
                     int n, int f_dim, int h_dim, int list_len,
                     float* __restrict__ h1buf, float* __restrict__ out_v,
                     int* __restrict__ out_i) {
  __shared__ float sv[TILE];
  __shared__ int si[TILE];
  const int row = blockIdx.x * TILE + threadIdx.x;
  const size_t n_pad = static_cast<size_t>(gridDim.x) * TILE;
  float score = NEG_INF;
  int idx = VIRGIN_IDX;
  if (row < n) {
    const float* x = feats + static_cast<size_t>(row) * f_dim;
    float* h1 = h1buf + row;
    // WJ hidden units at a time in registers: each input is read once per
    // chunk, and every unit's sum keeps its own k-ascending FMA order
    for (int j0 = 0; j0 < h_dim; j0 += WJ) {
      float a[WJ];
#pragma unroll
      for (int jj = 0; jj < WJ; ++jj) a[jj] = 0.f;
      for (int f = 0; f < f_dim; ++f) {
        const float xf = __ldg(x + f);
        const float* w = w1 + static_cast<size_t>(f) * h_dim + j0;
#pragma unroll
        for (int jj = 0; jj < WJ; ++jj) {
          if (j0 + jj < h_dim) a[jj] = fmaf(xf, __ldg(w + jj), a[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < WJ; ++jj) {
        if (j0 + jj < h_dim) {
          h1[(j0 + jj) * n_pad] = fmaxf(a[jj] + __ldg(b1 + j0 + jj), 0.f);
        }
      }
    }
    float s = 0.f;
    for (int j0 = 0; j0 < h_dim; j0 += WJ) {
      float acc[WJ];
#pragma unroll
      for (int jj = 0; jj < WJ; ++jj) acc[jj] = 0.f;
      for (int k = 0; k < h_dim; ++k) {
        const float hk = h1[k * n_pad];
        const float* w = w2 + static_cast<size_t>(k) * h_dim + j0;
#pragma unroll
        for (int jj = 0; jj < WJ; ++jj) {
          if (j0 + jj < h_dim) acc[jj] = fmaf(hk, __ldg(w + jj), acc[jj]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < WJ; ++jj) {
        if (j0 + jj < h_dim) {
          s = fmaf(fmaxf(acc[jj] + __ldg(b2 + j0 + jj), 0.f),
                   __ldg(w3 + j0 + jj), s);
        }
      }
    }
    s = (s + b3[0]) + bias[row];
    score = mask[row] > 0.f ? s : NEG_INF;
    idx = row;
  }
  sort_tile_and_write(sv, si, score, idx, list_len, out_v, out_i);
}

// Merges lists 2b and 2b+1 of src (in_len entries each, "before" order)
// into list b of dst, keeping the best out_len (<= 2 * in_len).  An odd list
// out is carried, padded with virgin slots.  With stage, the two lists are
// first copied to shared memory (4 * in_len words).
__global__ void __launch_bounds__(MERGE_THREADS)
merge_pairs(const float* __restrict__ src_v, const int* __restrict__ src_i,
            int n_lists, int in_len, int out_len, int stage,
            float* __restrict__ dst_v, int* __restrict__ dst_i) {
  extern __shared__ __align__(16) float msm[];
  const int a_list = 2 * blockIdx.x;
  const size_t a_off = static_cast<size_t>(a_list) * in_len;
  const size_t out = static_cast<size_t>(blockIdx.x) * out_len;
  if (a_list + 1 >= n_lists) {
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
      const bool live = t < in_len;
      dst_v[out + t] = live ? src_v[a_off + t] : NEG_INF;
      dst_i[out + t] = live ? src_i[a_off + t] : VIRGIN_IDX;
    }
    return;
  }
  const float* av = src_v + a_off;
  const int* ai = src_i + a_off;
  const float* bv = av + in_len;
  const int* bi = ai + in_len;
  if (stage) {
    float* sav = msm;
    int* sai = reinterpret_cast<int*>(sav + in_len);
    float* sbv = reinterpret_cast<float*>(sai + in_len);
    int* sbi = reinterpret_cast<int*>(sbv + in_len);
    for (int t = threadIdx.x; t < in_len; t += blockDim.x) {
      sav[t] = av[t]; sai[t] = ai[t]; sbv[t] = bv[t]; sbi[t] = bi[t];
    }
    __syncthreads();
    av = sav; ai = sai; bv = sbv; bi = sbi;
  }
  for (int t = threadIdx.x; t < in_len; t += blockDim.x) {
    {  // A[t] lands after t entries of A and every B strictly before it
      const float x = av[t];
      const int xi = ai[t];
      int lo = 0, hi = in_len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(bv[mid], bi[mid], x, xi)) lo = mid + 1; else hi = mid;
      }
      const int r = t + lo;
      if (r < out_len) { dst_v[out + r] = x; dst_i[out + r] = xi; }
    }
    {  // B[t] lands after t entries of B and every A not after it
      const float x = bv[t];
      const int xi = bi[t];
      int lo = 0, hi = in_len;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (!before(x, xi, av[mid], ai[mid])) lo = mid + 1; else hi = mid;
      }
      const int r = t + lo;
      if (r < out_len) { dst_v[out + r] = x; dst_i[out + r] = xi; }
    }
  }
}

template <int HP>
cudaError_t launch_scores(const float* const* a, int n, int f_dim, int h_dim,
                          int list_len, float* out_v, int* out_i, int n_tiles,
                          cudaStream_t stream) {
  const size_t smem = narrow_smem(f_dim, HP);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        score_tile_topk<HP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  score_tile_topk<HP><<<n_tiles, TILE, smem, stream>>>(
      a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], n, f_dim, h_dim,
      list_len, out_v, out_i);
  return cudaGetLastError();
}

int tiles_of(int n) { return (n + TILE - 1) / TILE; }

bool args_ok(int n, int f_dim, int h_dim, int k_pad) {
  return n >= 1 && n <= INT_MAX - TILE && f_dim >= 1 && h_dim >= 1 &&
         k_pad >= 8 && k_pad % 8 == 0 &&
         k_pad <= static_cast<long long>(tiles_of(n)) * TILE;
}

}  // namespace

extern "C" {

// Entries of each of the two ping-pong list buffers (values in scratch_v,
// indices in scratch_i): the largest level of the merge tree.
long long select_topk_list_entries(int n, int k_pad) {
  if (n < 1 || k_pad < 1) return 0;
  int count = tiles_of(n);
  long long len = k_pad < TILE ? k_pad : TILE;
  long long most = count * len;
  while (count > 1) {
    count = (count + 1) / 2;
    len = 2 * len < k_pad ? 2 * len : k_pad;
    if (count * len > most) most = count * len;
  }
  return most;
}

// Floats of the wide scorer's activation scratch (0 when the shared-memory
// scorer takes these widths).
long long select_topk_h1_floats(int n, int f_dim, int h_dim) {
  if (n < 1 || pick_hp(f_dim, h_dim) != 0) return 0;
  return static_cast<long long>(tiles_of(n)) * TILE * h_dim;
}

// Scratch: 2 * select_topk_list_entries(n, k_pad) floats in scratch_v and as
// many ints in scratch_i; h1: select_topk_h1_floats(n, f_dim, h_dim) floats
// (may be null when that is 0).  out_v, out_i: k_pad entries.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError() (0 on success).
int select_topk_launch(const void* feats, const void* mask, const void* bias,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, int n,
                       int f_dim, int h_dim, int k_pad, void* scratch_v,
                       void* scratch_i, void* h1, void* out_v, void* out_i,
                       void* stream) {
  if (!args_ok(n, f_dim, h_dim, k_pad)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = tiles_of(n);
  const long long buf = select_topk_list_entries(n, k_pad);
  float* v0 = static_cast<float*>(scratch_v);
  int* i0 = static_cast<int*>(scratch_i);
  float* v1 = v0 + buf;
  int* i1 = i0 + buf;
  float* ov = static_cast<float*>(out_v);
  int* oi = static_cast<int*>(out_i);
  const int list0 = k_pad < TILE ? k_pad : TILE;
  float* first_v = n_tiles == 1 ? ov : v0;
  int* first_i = n_tiles == 1 ? oi : i0;

  const float* a[9] = {
      static_cast<const float*>(feats), static_cast<const float*>(mask),
      static_cast<const float*>(bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3)};
  cudaError_t err;
  switch (pick_hp(f_dim, h_dim)) {
    case 32:
      err = launch_scores<32>(a, n, f_dim, h_dim, list0, first_v, first_i, n_tiles, s);
      break;
    case 64:
      err = launch_scores<64>(a, n, f_dim, h_dim, list0, first_v, first_i, n_tiles, s);
      break;
    case 128:
      err = launch_scores<128>(a, n, f_dim, h_dim, list0, first_v, first_i, n_tiles, s);
      break;
    default:
      if (h1 == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      score_tile_topk_wide<<<n_tiles, TILE, 0, s>>>(
          a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], n, f_dim,
          h_dim, list0, static_cast<float*>(h1), first_v, first_i);
      err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const float* cur_v = v0;
  const int* cur_i = i0;
  bool cur_in_first = true;
  int count = n_tiles;
  int len = list0;
  while (count > 1) {
    const int next = (count + 1) / 2;
    const int out_len = 2 * len < k_pad ? 2 * len : k_pad;
    float* dv;
    int* di;
    if (next == 1) {
      dv = ov; di = oi;
    } else if (cur_in_first) {
      dv = v1; di = i1;
    } else {
      dv = v0; di = i0;
    }
    const int stage = len <= MERGE_SMEM_LIST;
    const size_t smem = stage ? static_cast<size_t>(4) * len * sizeof(float) : 0;
    const int threads = len < MERGE_THREADS ? ((len + 31) / 32) * 32 : MERGE_THREADS;
    merge_pairs<<<next, threads, smem, s>>>(cur_v, cur_i, count, len, out_len,
                                            stage, dv, di);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur_v = dv;
    cur_i = di;
    cur_in_first = !cur_in_first;
    count = next;
    len = out_len;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
