// Fused Q-net scoring -> top-K cohort selection, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/select_topk/kernel.py:98,
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
// and are left out: every product is an fp32 FMA written here.
//
// Design.
//  * Scoring is a small SGEMM per tile of BM = 128 rows, 256 threads a CTA.
//    Hidden units go in chunks of 64; thread (ty, tx) (ty = tid / 8,
//    tx = tid % 8) holds a 4 x 8 tile of sums in registers: rows ty*4 ..
//    ty*4 + 3, units tx*4 .. tx*4+3 and 32 + tx*4 .. +3 of the chunk.  Per k
//    it reads 4 activations (a 16-byte shared load, a broadcast to the row
//    group's 8 lanes) and 8 weights (two 16-byte loads, conflict-free) for
//    32 FMAs: the shared-memory pipe (~4 cycles a 16-byte load for a warp:
//    12 cycles per 32 FMAs), not the FMA pipe, sets the pace; a larger tile
//    needs more than the 128 registers that two CTAs a SM allow.  H is
//    padded to H_pad, a multiple of 64, with zero weights (the copies
//    zero-fill), which leaves every sum unchanged.  Three paths (each its
//    own instantiation) stage the operands with cp.async, double-buffered,
//    the next copy in flight while the last is used:
//      resident (H_pad = 64, F <= 32: the paths' Q-nets): w1 and w2 are
//        copied once for the CTA's life and a tile copies only its
//        features, a tile ahead; a row group's features, activations and
//        sums belong to the 8 lanes of one quarter-warp, and each warp
//        copies its own rows, so within a tile warps sync only with
//        themselves (one block barrier a tile: the admit count below);
//      streamed (any F, H_pad <= 320): every step stages 32 k-rows of the
//        features and of w1 (layer 1) or of w2 (layer 2), a block barrier
//        before and after each; the first layer's activations stay in
//        shared memory for the whole tile ([H_pad][BM], each unit's 4-row
//        blocks swizzled by the unit so that a quarter-warp's stores hit
//        eight bank groups);
//      global (any F, H_pad > 320, where [H_pad][BM] no longer fits beside
//        the staging): as streamed, but the activations go to the CTA's
//        own [H_pad][BM] slice of the scratch and layer 2 stages them, 32
//        units at a time, beside w2's rows.  Any H.
//    The resident and streamed paths write nothing but the result to device
//    memory.
//  * A row's score is computed the same way whatever CTA, tile, path or
//    route computes it: each unit's sum is one fmaf chain in k-ascending
//    order from 0; the ReLU and w3 product are folded per thread over the
//    thread's own units (chunk by chunk, units in the order above); the 8
//    threads of a row then sum by a fixed xor-butterfly (1, 2, 4), which
//    leaves all 8 with the same bits; then (s + b3) + bias.
//  * Selection, K_pad <= 256 ("carry"): a persistent grid (as many CTAs as
//    the card holds at once, at most one per tile) walks its tiles in a
//    fixed order and carries its own sorted top-K_pad in shared memory.  A
//    freshly scored row enters only if it comes before the list's K_pad-th
//    entry under the contract's order, `before(row, kth)` (not `score >
//    kth`: an equal score with a lower index must get in); the few that do
//    are rank-sorted and merged in by binary-search ranks.  At 1e6 rows and
//    k = 64 almost every row is dropped by that one compare, and a tile
//    with none costs one barrier.  Each CTA then writes its list and takes
//    an integer ticket (atomicAdd on an int in a ticket buffer that stays
//    zero between launches; the kernel resets what it used); the last CTA
//    of each group of 16 merges the group's lists, and the last group the
//    groups' lists, each list's admitted head ranked by binary searches in
//    the others.  Top-K under a strict total order is unique, so the merge
//    order cannot change the result.  No float atomics.  One launch, at
//    every N.  The tickets and the scratch belong to one stream: launches
//    that may overlap need buffers of their own.
//  * Selection, K_pad > 256 ("tree"): each tile's rows are rank-sorted and
//    its best min(K_pad, BM) go to a scratch list; then a fixed-order tree
//    of pairwise merges (merge_pairs, one launch a level) keeps the best
//    K_pad.  1 + ceil(log2(tiles)) launches.
// Limits: 1 <= N < 2^31 - 256, any F >= 1 and H >= 1, 8 <= K_pad <= N
// rounded up to 8 (K_pad a multiple of 8).

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TX = 8;                      // threads across a chunk of units
constexpr int R = 4;                       // rows a thread
constexpr int ROW_GROUPS = THREADS / TX;   // 32
constexpr int BM = ROW_GROUPS * R;         // rows a tile
constexpr int LDX = BM + 4;                // a staged k-row's stride
constexpr int UC = 64;                     // hidden units per chunk
constexpr int KC = 32;                     // k-rows per staged chunk
constexpr int STAGE = KC * LDX + KC * UC;  // one staged step: [KC][LDX] + [KC][UC]
constexpr int GROUP = 16;                  // CTAs per first-level merge group
constexpr int CARRY_MAX = 256;             // largest K_pad carried in shared memory
constexpr int CAND = 256;                  // candidates merged at once
constexpr int HP_SHARED = 320;             // widest H_pad with activations in shared memory
constexpr float NEG_INF = -3.0e38f;
constexpr int VIRGIN_IDX = INT_MAX;
constexpr int MAX_SMEM = 232448;           // a CTA's shared memory on sm_90
constexpr int MERGE_SMEM_LIST = 3072;      // longest list merged in smem
constexpr int MERGE_THREADS = 256;
constexpr int MAX_DEVICES = 64;
constexpr int TICKETS = 1024;              // words of the ticket buffer: groups + 1 at most

// The scoring paths, one instantiation each.
enum Path { RESIDENT = 0, STREAMED = 1, GLOBAL_H1 = 2 };

__host__ __device__ __forceinline__ int hp_of(int h) { return (h + UC - 1) / UC * UC; }
__host__ __device__ __forceinline__ bool is_carry(int k_pad) { return k_pad <= CARRY_MAX; }

// H_pad = 64 and F <= KC: w1 and w2 stay in shared memory for the CTA's
// life (the paths' Q-nets: F = 6 or 14, H = 64).  H_pad > HP_SHARED: the
// activations go through the scratch (then H_pad >= 384, so layer 2's first
// step reads units that layer 1's first chunk wrote, not its last).
__host__ __device__ __forceinline__ int path_of(int f, int hp) {
  return hp == UC && f <= KC ? RESIDENT : hp <= HP_SHARED ? STREAMED : GLOBAL_H1;
}

// Shared memory of one CTA, in 4-byte words (every region a multiple of 4
// words, so 16-byte aligned):
//   h1 [hp][BM], but for the global path |
//   resident: 2 x [F][LDX] staged features | w1 [F][hp] | w2 [hp][hp] |
//   streamed, global: 2 x STAGE staged operands |
//   b1, b2, w3 [hp] | list 2 x K_pad (value, index) pairs, carry only |
//   candidates and sorted candidates, CAND pairs each | 16 words of warp
//   counts and flags.
__host__ __device__ inline size_t smem_words(int f, int hp, int k_pad) {
  const int path = path_of(f, hp);
  const size_t h1 = path == GLOBAL_H1 ? 0 : static_cast<size_t>(hp) * BM;
  const size_t operands = path == RESIDENT
                              ? 2 * static_cast<size_t>(f) * LDX + static_cast<size_t>(f) * hp +
                                    static_cast<size_t>(hp) * hp
                              : 2 * static_cast<size_t>(STAGE);
  const size_t list = is_carry(k_pad) ? 4 * static_cast<size_t>(k_pad) : 0;
  return h1 + operands + 3 * static_cast<size_t>(hp) + list + 4 * CAND + 16;
}

__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4-byte copy, zero-filled when !ok (src must still be a valid address)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Args {
  const float* feats;
  const float* mask;
  const float* bias;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* w3;
  const float* b3;
  int n, f, h, hp, k_pad, tiles, n_groups, vec_w;
  float2* pairs;       // carry: (grid + n_groups) x k_pad (value, index) pairs
  float* lists_v;      // tree: tiles x min(k_pad, BM) values, then indices
  int* lists_i;
  float* h1g;          // global path: grid x [hp][BM] activations
  unsigned* tickets;   // carry: n_groups + 1 of the TICKETS, zero on entry and on exit
  float* out_v;        // carry: k_pad entries
  long long* out_i;
};

// The thread's unit within a 64-unit chunk for its c-th sum (c = 0..7).
__device__ __forceinline__ int unit_of(int tx, int c) {
  return (c < 4 ? 0 : 32) + tx * 4 + (c & 3);
}

__device__ __forceinline__ void fma_k(float (&acc)[R][8], const float* a_row,
                                      const float* b_row, int tx) {
  const float4 v = *reinterpret_cast<const float4*>(a_row);
  const float a[R] = {v.x, v.y, v.z, v.w};
  const float4 b0 = *reinterpret_cast<const float4*>(b_row + tx * 4);
  const float4 b1 = *reinterpret_cast<const float4*>(b_row + 32 + tx * 4);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i][0] = fmaf(a[i], b0.x, acc[i][0]);
    acc[i][1] = fmaf(a[i], b0.y, acc[i][1]);
    acc[i][2] = fmaf(a[i], b0.z, acc[i][2]);
    acc[i][3] = fmaf(a[i], b0.w, acc[i][3]);
    acc[i][4] = fmaf(a[i], b1.x, acc[i][4]);
    acc[i][5] = fmaf(a[i], b1.y, acc[i][5]);
    acc[i][6] = fmaf(a[i], b1.z, acc[i][6]);
    acc[i][7] = fmaf(a[i], b1.w, acc[i][7]);
  }
}

// One staged step of a CTA's walk: tile, layer (1 or 2), unit chunk u and
// k-chunk kc.  A tile's steps: layer 1 (u, kc) for every u and the n_f
// chunks of F, then layer 2 (u, kc) for every u and the n_h chunks of H_pad.
struct Step {
  int tile, layer, u, kc;
};

struct Walk {
  int n_u, n_f, n_h;
  __device__ __forceinline__ void advance(Step& s) const {
    if (++s.kc < (s.layer == 1 ? n_f : n_h)) return;
    s.kc = 0;
    if (++s.u < n_u) return;
    s.u = 0;
    if (s.layer == 1) {
      s.layer = 2;
    } else {
      s.layer = 1;
      s.tile += gridDim.x;
    }
  }
};

// The CTA's slice of the global path's activations, [hp][BM].
__device__ __forceinline__ float* h1_slice(const Args& a) {
  return a.h1g + static_cast<size_t>(blockIdx.x) * a.hp * BM;
}

// Stages a step's operands into stage buffer st: layer 1 the tile's
// features transposed ([kc][LDX]) and w1's rows k0.. for the chunk's units
// ([kc][UC]); layer 2 w2's rows k0.. for the chunk's units and, on the
// global path, the activations of units k0.. ([KC][LDX]).
template <int PATH>
__device__ __forceinline__ void issue(const Args& a, const Step& s, float* st) {
  const int tid = threadIdx.x;
  float* xs = st;
  float* ws = st + KC * LDX;
  const int k0 = s.kc * KC;
  const int col0 = s.u * UC;
  const float* w = s.layer == 1 ? a.w1 : a.w2;
  const int krows = s.layer == 1 ? a.f : a.h;        // rows of w that exist
  const int klen = s.layer == 1 ? min(KC, a.f - k0) : KC;
  if (s.layer == 1) {   // consecutive threads on consecutive rows: no division
    const size_t row0 = static_cast<size_t>(s.tile) * BM;
    const float* x = a.feats + row0 * a.f + k0;
    for (int e = tid; e < klen * BM; e += THREADS) {
      const int r = e % BM, k = e / BM;
      const bool ok = row0 + r < static_cast<size_t>(a.n);
      cp_async4(xs + k * LDX + r, ok ? x + static_cast<size_t>(r) * a.f + k : a.feats, ok);
    }
  } else if constexpr (PATH == GLOBAL_H1) {
    const float* h = h1_slice(a) + static_cast<size_t>(k0) * BM;
    for (int e = tid; e < KC * (BM / 4); e += THREADS) {
      const int k = e / (BM / 4), r = (e % (BM / 4)) * 4;
      cp_async16(xs + k * LDX + r, h + k * BM + r, true);
    }
  }
  if (a.vec_w) {        // h % 4 == 0 and w 16-byte aligned: whole float4s in or out
    for (int e = tid; e < klen * (UC / 4); e += THREADS) {
      const int k = e / (UC / 4), j = (e % (UC / 4)) * 4;
      const bool ok = col0 + j < a.h && k0 + k < krows;
      cp_async16(ws + k * UC + j,
                 ok ? w + static_cast<size_t>(k0 + k) * a.h + col0 + j : w, ok);
    }
  } else {
    for (int e = tid; e < klen * UC; e += THREADS) {
      const int k = e / UC, j = e % UC;
      const bool ok = col0 + j < a.h && k0 + k < krows;
      cp_async4(ws + k * UC + j, ok ? w + static_cast<size_t>(k0 + k) * a.h + col0 + j : w, ok);
    }
  }
}

// A (value, index) pair as a float2, the index's bits in .y.
__device__ __forceinline__ float2 pair(float v, int i) { return make_float2(v, __int_as_float(i)); }
__device__ __forceinline__ int idx_of(float2 e) { return __float_as_int(e.y); }
__device__ __forceinline__ bool before(float2 a, float2 b) {
  return before(a.x, idx_of(a), b.x, idx_of(b));
}
__device__ __forceinline__ bool same(float2 a, float2 b) {
  return a.x == b.x && idx_of(a) == idx_of(b);
}

// Selection state in shared memory.
struct Sel {
  float2* l;        // the carried list (carry route), K_pad pairs
  float2* nl;       // the other list buffer
  float2* c;        // candidates, CAND
  float2* s;        // sorted candidates, CAND
  int* wcnt;        // [WARPS] admitted per warp, then flags
};

// Number of the first len pairs of a (sorted in before-order) that come
// before x.
__device__ __forceinline__ int count_before(const float2* a, int len, float2 x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(a[mid], x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over separate value and index arrays (the tree route's lists).
__device__ __forceinline__ int count_before(const float* av, const int* ai, int len,
                                            float x, int xi) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(av[mid], ai[mid], x, xi)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Rank of candidate k among c[0..m): pairs before it, and equal pairs at a
// lower position (so virgin duplicates get distinct ranks).
__device__ __forceinline__ int rank_of(const float2* c, int m, int k) {
  const float2 x = c[k];
  int r = 0;
#pragma unroll 4
  for (int j = 0; j < m; ++j) {
    const float2 y = c[j];
    r += before(y, x) || (same(y, x) && j < k);
  }
  return r;
}

// Merges the m sorted pairs S.s[0..m) into the carried list: every pair
// lands at its rank in the merged order (its position plus the pairs of the
// other list before it), ranks past K_pad dropped.  Ends with a barrier;
// all threads return with the new list in S.l.
__device__ void merge_sorted(Sel& S, int k_pad, int m) {
  const int tid = threadIdx.x;
  for (int p = tid; p < k_pad; p += THREADS) {
    const float2 x = S.l[p];
    const int q = p + count_before(S.s, m, x);
    if (q < k_pad) S.nl[q] = x;
  }
  for (int k = tid; k < m; k += THREADS) {
    const float2 x = S.s[k];
    const int q = k + count_before(S.l, k_pad, x);
    if (q < k_pad) S.nl[q] = x;
  }
  __syncthreads();
  float2* t = S.l; S.l = S.nl; S.nl = t;
}

// Every thread calls this with its own (admit, e); the admitted pairs are
// rank-sorted and merged into the carried list (all threads return with the
// new list in S.l).
__device__ void admit_and_merge(Sel& S, int k_pad, bool admit, float2 e) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, admit);
  if (lane == 0) S.wcnt[warp] = __popc(bal);
  const int m = __syncthreads_count(admit);
  if (m == 0) return;                           // most tiles: one barrier
  int off = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) off += w < warp ? S.wcnt[w] : 0;
  if (admit) S.c[off + __popc(bal & ((1u << lane) - 1u))] = e;
  __syncthreads();
  for (int k = tid; k < m; k += THREADS) S.s[rank_of(S.c, m, k)] = S.c[k];
  __syncthreads();
  merge_sorted(S, k_pad, m);
}

// Merges `count` sorted lists of k_pad pairs (list l at src + l * k_pad,
// the list `skip` left out) into the carried list, CAND / k_pad lists at a
// time, the next chunk's loads in flight while one is merged.  A chunk's
// lists go to S.c whole; an admitted pair (one before the carried K_pad-th)
// ranks among the chunk's admitted pairs at its position plus, for each
// other list, that list's pairs before it (a pair before an admitted one is
// admitted too), counted by a scan of at most CAND independent compares,
// which beats a binary search's chain of dependent loads here.
__device__ void merge_lists(Sel& S, int k_pad, const float2* src, int count, int skip) {
  const int tid = threadIdx.x;
  const int per = CAND / k_pad;                 // lists a chunk (k_pad <= CAND)
  const int others = count - 1;
  const int l = tid / k_pad, pos = tid % k_pad;
  auto load = [&](int first) {
    if (l < per && first + l < others) {
      const int from = first + l < skip ? first + l : first + l + 1;
      return __ldcg(src + static_cast<size_t>(from) * k_pad + pos);
    }
    return pair(NEG_INF, VIRGIN_IDX);           // never admitted
  };
  float2 e = load(0);
  for (int first = 0; first < others; first += per) {
    const float2 next = load(first + per);
    const int lists = min(per, others - first);
    if (l < lists) S.c[tid] = e;
    const bool admit = l < lists && before(e, S.l[k_pad - 1]);
    const int m = __syncthreads_count(admit);
    if (m > 0) {
      if (admit) {
        int r = pos;
        for (int b = 0; b < lists; ++b) {
          if (b == l) continue;
          const float2* lb = S.c + b * k_pad;
#pragma unroll 8
          for (int j = 0; j < k_pad; ++j) r += before(lb[j], e);
        }
        S.s[r] = e;
      }
      __syncthreads();
      merge_sorted(S, k_pad, m);
    }
    e = next;
  }
}

__device__ __forceinline__ void zero(float (&acc)[R][8]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
}

// The first layer's activations of unit chunk u, ReLU(acc + b1), into h1
// [unit][row] (BM rows a unit).  In shared memory each unit's blocks of 4
// rows are swizzled: block ty sits at ty ^ swz(unit), swz(unit) = (unit >>
// 2) & 7, which is tx for every unit of thread tx, so a quarter-warp's
// eight stores of one block go to eight bank groups (unswizzled, all eight
// hit one).  The global path's slice is not swizzled.
template <bool SWIZZLE>
__device__ __forceinline__ void store_h1(const float (&acc)[R][8], int u, const float* b1s,
                                         float* h1, int tx, int ty) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int unit = u * UC + unit_of(tx, c);
    const float bb = b1s[unit];
    float* dst = h1 + static_cast<size_t>(unit) * BM + (SWIZZLE ? ty ^ tx : ty) * R;
    *reinterpret_cast<float4*>(dst) = make_float4(
        fmaxf(acc[0][c] + bb, 0.f), fmaxf(acc[1][c] + bb, 0.f),
        fmaxf(acc[2][c] + bb, 0.f), fmaxf(acc[3][c] + bb, 0.f));
  }
}

// Thread row block ty of unit k in the shared h1 (k counted from a
// multiple of 32, so the swizzle is a constant of the unrolled loop).
__device__ __forceinline__ const float* h1_row(const float* h1s, int k, int ty) {
  return h1s + static_cast<size_t>(k) * BM + (ty ^ ((k >> 2) & 7)) * R;
}

// The second layer's ReLU(acc + b2) times w3, folded into each row's
// partial sum over the thread's units of chunk u, in the fixed order c.
__device__ __forceinline__ void fold_w3(const float (&acc)[R][8], int u, const float* b2s,
                                        const float* w3s, float (&s_part)[R], int tx) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int unit = u * UC + unit_of(tx, c);
    const float bb = b2s[unit], w = w3s[unit];
#pragma unroll
    for (int i = 0; i < R; ++i) s_part[i] = fmaf(fmaxf(acc[i][c] + bb, 0.f), w, s_part[i]);
  }
}

// A scored tile: each row's 8 threads sum their partials (xor-butterfly),
// thread tx < R owns row ty*R + tx, and the tile's rows go to the carried
// list (carry) or, rank-sorted, to the tile's scratch list (tree).
__device__ __forceinline__ void end_tile(const Args& a, Sel& S, const float (&s_part)[R],
                                         float mask_r, float bias_r, float b3, int tile,
                                         bool carry) {
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  float mine = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float t = s_part[i];
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    t += __shfl_xor_sync(0xffffffffu, t, 4);
    if (tx == i) mine = t;
  }
  const int row = tile * BM + ty * R + tx;
  const bool valid = tx < R && row < a.n;
  const float2 e = valid ? pair(mask_r > 0.f ? (mine + b3) + bias_r : NEG_INF, row)
                         : pair(NEG_INF, VIRGIN_IDX);
  if (carry) {
    admit_and_merge(S, a.k_pad, valid && before(e, S.l[a.k_pad - 1]), e);
    return;
  }
  const int len0 = a.k_pad < BM ? a.k_pad : BM;
  if (tx < R) S.c[ty * R + tx] = e;
  __syncthreads();
  if (tid < BM) {
    const int r = rank_of(S.c, BM, tid);
    if (r < len0) {
      const size_t at = static_cast<size_t>(tile) * len0 + r;
      a.lists_v[at] = S.c[tid].x;
      a.lists_i[at] = idx_of(S.c[tid]);
    }
  }
  __syncthreads();
}

// The first tile row's mask and bias for the owning thread.
__device__ __forceinline__ void row_inputs(const Args& a, int tile, float& mask_r,
                                           float& bias_r) {
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row = tile * BM + ty * R + tx;
  if (tx < R && row < a.n) {
    mask_r = __ldg(a.mask + row);
    bias_r = __ldg(a.bias + row);
  }
}

// Stages the features of tile `tile` transposed ([F][LDX]); resident path.
// Each warp copies the 16 rows of its own four row groups, the only rows
// its lanes read, so a warp needs no other warp's copies.
__device__ __forceinline__ void issue_x(const Args& a, int tile, float* xs) {
  constexpr int WROWS = 4 * R;                       // rows a warp
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * WROWS;
  const size_t row0 = static_cast<size_t>(tile) * BM + w0;
  const float* x = a.feats + row0 * a.f;
  for (int e = lane; e < a.f * WROWS; e += 32) {
    const int r = e % WROWS, k = e / WROWS;
    const bool ok = row0 + r < static_cast<size_t>(a.n);
    cp_async4(xs + k * LDX + w0 + r, ok ? x + static_cast<size_t>(r) * a.f + k : a.feats, ok);
  }
}

// The resident path fits 80 registers, so three CTAs share a SM (the
// streamed paths keep two).
template <int PATH>
__global__ void __launch_bounds__(THREADS, PATH == RESIDENT ? 3 : 2) select_topk_fused(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int hp = a.hp;
  const bool carry = is_carry(a.k_pad);

  // shared memory as smem_words lays it out
  float* h1s = sm;                                   // [hp][BM], none on the global path
  float* stage = h1s + (PATH == GLOBAL_H1 ? 0 : static_cast<size_t>(hp) * BM);
  const int xstage = a.f * LDX;                      // resident: one tile's features
  float* w1s = stage + 2 * xstage;                   // resident: [F][hp], then [hp][hp]
  float* w2s = w1s + a.f * hp;
  float* b1s = PATH == RESIDENT ? w2s + hp * hp : stage + 2 * STAGE;   // [hp]
  float* b2s = b1s + hp;
  float* w3s = b2s + hp;
  const int kl = carry ? a.k_pad : 0;
  Sel S;
  S.l = reinterpret_cast<float2*>(w3s + hp);
  S.nl = S.l + kl;
  S.c = S.nl + kl;
  S.s = S.c + CAND;
  S.wcnt = reinterpret_cast<int*>(S.s + CAND);

  // b1, b2, w3 and the empty list, written while the first copies fly (the
  // first barrier of either path orders them before their first use)
  auto stash = [&]() {
    for (int j = tid; j < hp; j += THREADS) {
      const bool live = j < a.h;
      b1s[j] = live ? __ldg(a.b1 + j) : 0.f;
      b2s[j] = live ? __ldg(a.b2 + j) : 0.f;
      w3s[j] = live ? __ldg(a.w3 + j) : 0.f;
    }
    for (int p = tid; p < kl; p += THREADS) S.l[p] = pair(NEG_INF, VIRGIN_IDX);
  };
  const float b3 = __ldg(a.b3);

  float acc[R][8];
  float s_part[R];
  float mask_r = 0.f, bias_r = 0.f;

  if constexpr (PATH == RESIDENT) {
    // H_pad = 64 and F <= KC: w1 and w2 staged once for the CTA's life, and
    // a tile's one staged copy (its features) prefetched a tile ahead.  A
    // row group's features, activations and sums belong to the 8 lanes of
    // one quarter-warp, so within a tile warps sync only with themselves;
    // the one block barrier a tile is end_tile's admit count.
    for (int e = tid; e < a.f * UC; e += THREADS) {
      const int k = e / UC, j = e % UC;
      const bool ok = j < a.h;
      cp_async4(w1s + k * hp + j, ok ? a.w1 + static_cast<size_t>(k) * a.h + j : a.w1, ok);
    }
    for (int e = tid; e < UC * UC; e += THREADS) {
      const int k = e / UC, j = e % UC;
      const bool ok = j < a.h && k < a.h;
      cp_async4(w2s + k * hp + j, ok ? a.w2 + static_cast<size_t>(k) * a.h + j : a.w2, ok);
    }
    int tile = blockIdx.x, buf = 0;
    issue_x(a, tile, stage);
    cp_commit();
    stash();
    for (bool first = true; tile < a.tiles; tile += gridDim.x, buf ^= 1, first = false) {
      const bool more = tile + static_cast<int>(gridDim.x) < a.tiles;
      if (more) {
        issue_x(a, tile + gridDim.x, stage + (buf ^ 1) * xstage);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      if (first) __syncthreads();          // the weights, copied by every thread
      else __syncwarp();
      row_inputs(a, tile, mask_r, bias_r);
      const float* xs = stage + buf * xstage + ty * R;
      zero(acc);
#pragma unroll 2
      for (int k = 0; k < a.f; ++k) fma_k(acc, xs + k * LDX, w1s + k * hp, tx);
      store_h1<true>(acc, 0, b1s, h1s, tx, ty);
      __syncwarp();
      zero(acc);
#pragma unroll 32
      for (int k = 0; k < UC; ++k) fma_k(acc, h1_row(h1s, k, ty), w2s + k * hp, tx);
#pragma unroll
      for (int i = 0; i < R; ++i) s_part[i] = 0.f;
      fold_w3(acc, 0, b2s, w3s, s_part, tx);
      end_tile(a, S, s_part, mask_r, bias_r, b3, tile, carry);
    }
  } else {
    // any F and H: every operand chunk staged by cp.async, double-buffered
    const Walk walk{hp / UC, (a.f + KC - 1) / KC, hp / KC};
    Step cur{static_cast<int>(blockIdx.x), 1, 0, 0};
    Step nxt = cur;
    walk.advance(nxt);
    int buf = 0;
    issue<PATH>(a, cur, stage);
    cp_commit();
    stash();
    for (;;) {
      const bool more = nxt.tile < a.tiles;
      if (more) {
        issue<PATH>(a, nxt, stage + (buf ^ 1) * STAGE);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* xs = stage + buf * STAGE;
      const float* ws = xs + KC * LDX;
      if (cur.kc == 0) zero(acc);
      if (cur.layer == 1) {
        if (cur.u == 0 && cur.kc == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i) s_part[i] = 0.f;
          row_inputs(a, cur.tile, mask_r, bias_r);
        }
        const int klen = min(KC, a.f - cur.kc * KC);
#pragma unroll 2
        for (int k = 0; k < klen; ++k) fma_k(acc, xs + k * LDX + ty * R, ws + k * UC, tx);
        if (cur.kc == walk.n_f - 1) {
          if constexpr (PATH == GLOBAL_H1) store_h1<false>(acc, cur.u, b1s, h1_slice(a), tx, ty);
          else store_h1<true>(acc, cur.u, b1s, h1s, tx, ty);
        }
      } else {
        if constexpr (PATH == GLOBAL_H1) {   // the staged activations of units kc*KC..
#pragma unroll
          for (int k = 0; k < KC; ++k) fma_k(acc, xs + k * LDX + ty * R, ws + k * UC, tx);
        } else {
          const float* hs = h1s + static_cast<size_t>(cur.kc) * KC * BM;
#pragma unroll
          for (int k = 0; k < KC; ++k) fma_k(acc, h1_row(hs, k, ty), ws + k * UC, tx);
        }
        if (cur.kc == walk.n_h - 1) fold_w3(acc, cur.u, b2s, w3s, s_part, tx);
      }
      __syncthreads();
      if (cur.layer == 2 && cur.u == walk.n_u - 1 && cur.kc == walk.n_h - 1) {
        end_tile(a, S, s_part, mask_r, bias_r, b3, cur.tile, carry);
      }
      if (!more) break;
      cur = nxt;
      walk.advance(nxt);
      buf ^= 1;
    }
  }
  if (!carry) return;

  // ---- the CTA's list is final: publish it, then the last CTA of the
  // group merges the group's lists, and the last group the groups' lists
  // (a grid of one CTA holds the answer already)
  const int k_pad = a.k_pad;
  if (gridDim.x == 1) {
    for (int p = tid; p < k_pad; p += THREADS) {
      a.out_v[p] = S.l[p].x;
      a.out_i[p] = idx_of(S.l[p]);
    }
    return;
  }
  const int grp = blockIdx.x / GROUP;
  const int grp_first = grp * GROUP;
  const int grp_size = min(GROUP, static_cast<int>(gridDim.x) - grp_first);
  int* flag = S.wcnt + WARPS;
  for (int p = tid; p < k_pad; p += THREADS) {
    a.pairs[static_cast<size_t>(blockIdx.x) * k_pad + p] = S.l[p];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(a.tickets + grp, 1u) == static_cast<unsigned>(grp_size - 1);
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  merge_lists(S, k_pad, a.pairs + static_cast<size_t>(grp_first) * k_pad, grp_size,
              blockIdx.x - grp_first);
  if (a.n_groups > 1) {
    float2* gl = a.pairs + static_cast<size_t>(gridDim.x) * k_pad;
    for (int p = tid; p < k_pad; p += THREADS) gl[static_cast<size_t>(grp) * k_pad + p] = S.l[p];
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      a.tickets[grp] = 0u;
      *flag = atomicAdd(a.tickets + a.n_groups, 1u) == static_cast<unsigned>(a.n_groups - 1);
    }
    __syncthreads();
    if (!*flag) return;
    __threadfence();
    merge_lists(S, k_pad, gl, a.n_groups, grp);
    if (tid == 0) a.tickets[a.n_groups] = 0u;
  } else if (tid == 0) {
    a.tickets[grp] = 0u;
  }
  for (int p = tid; p < k_pad; p += THREADS) {
    a.out_v[p] = S.l[p].x;
    a.out_i[p] = idx_of(S.l[p]);
  }
}

// Merges lists 2b and 2b+1 of src (in_len entries each, "before" order)
// into list b of dst, keeping the best out_len (<= 2 * in_len).  An odd list
// out is carried, padded with virgin slots.  With stage, the two lists are
// first copied to shared memory (4 * in_len words).  With dst_i64, indices
// go there as int64 (the last level).
__global__ void __launch_bounds__(MERGE_THREADS)
merge_pairs(const float* __restrict__ src_v, const int* __restrict__ src_i,
            int n_lists, int in_len, int out_len, int stage,
            float* __restrict__ dst_v, int* __restrict__ dst_i,
            long long* __restrict__ dst_i64) {
  extern __shared__ __align__(16) float msm[];
  const int a_list = 2 * blockIdx.x;
  const size_t a_off = static_cast<size_t>(a_list) * in_len;
  const size_t out = static_cast<size_t>(blockIdx.x) * out_len;
  auto put = [&](size_t at, float x, int xi) {
    dst_v[at] = x;
    if (dst_i64) dst_i64[at] = xi; else dst_i[at] = xi;
  };
  if (a_list + 1 >= n_lists) {
    for (int t = threadIdx.x; t < out_len; t += blockDim.x) {
      const bool live = t < in_len;
      put(out + t, live ? src_v[a_off + t] : NEG_INF, live ? src_i[a_off + t] : VIRGIN_IDX);
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
      const int r = t + count_before(bv, bi, in_len, x, xi);
      if (r < out_len) put(out + r, x, xi);
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
      if (r < out_len) put(out + r, x, xi);
    }
  }
}

int tiles_of(int n) { return (n + BM - 1) / BM; }

// Entries of each of the tree route's two ping-pong list buffers: the
// largest level of the merge tree.
long long tree_entries(int n, int k_pad) {
  int count = tiles_of(n);
  long long len = k_pad < BM ? k_pad : BM;
  long long most = count * len;
  while (count > 1) {
    count = (count + 1) / 2;
    len = 2 * len < k_pad ? 2 * len : k_pad;
    if (count * len > most) most = count * len;
  }
  return most;
}

// The selection's part of the scratch: carry, (grid + groups) lists of
// K_pad pairs; tree, two ping-pong list buffers.
long long selection_bytes(int n, int k_pad, int grid) {
  if (is_carry(k_pad)) {
    const long long groups = (grid + GROUP - 1) / GROUP;
    return 8LL * (grid + groups) * k_pad;
  }
  return 16LL * tree_entries(n, k_pad);
}

// The selection's part, then the global path's activations (grid slices of
// [hp][BM] floats).
long long scratch_need(int n, int f, int h, int k_pad, int grid) {
  const int hp = hp_of(h);
  const long long h1 = path_of(f, hp) == GLOBAL_H1 ? 4LL * grid * hp * BM : 0;
  return selection_bytes(n, k_pad, grid) + h1;
}

bool shape_ok(int n, int f, int h, int k_pad) {
  return n >= 1 && n <= INT_MAX - 256 && f >= 1 && h >= 1 && h <= INT_MAX - UC &&
         k_pad >= 8 && k_pad % 8 == 0 && k_pad <= (static_cast<long long>(n) + 7) / 8 * 8;
}

template <int PATH>
cudaError_t set_smem_attribute() {
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(select_topk_fused<PATH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return err;
}

template <int PATH>
cudaError_t occupancy(long long smem_bytes, int* per_sm, cudaFuncAttributes* attr) {
  cudaError_t err = set_smem_attribute<PATH>();
  if (err == cudaSuccess) err = cudaFuncGetAttributes(attr, select_topk_fused<PATH>);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, select_topk_fused<PATH>,
                                                        THREADS, static_cast<size_t>(smem_bytes));
  }
  return err;
}

template <int PATH>
cudaError_t launch_fused(const Args& a, int grid, size_t smem, cudaStream_t st) {
  const cudaError_t err = set_smem_attribute<PATH>();
  if (err != cudaSuccess) return err;
  select_topk_fused<PATH><<<grid, THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

int launch(const float* const* p, int n, int f, int h, int k_pad, int grid, void* scratch,
           long long scratch_bytes, void* tickets, float* out_v, long long* out_i,
           cudaStream_t st) {
  if (!shape_ok(n, f, h, k_pad)) return static_cast<int>(cudaErrorInvalidValue);
  const int hp = hp_of(h);
  const int tiles = tiles_of(n);
  const bool carry = is_carry(k_pad);
  const int path = path_of(f, hp);
  const size_t smem = 4 * smem_words(f, hp, k_pad);
  if (grid < 1 || grid > tiles || (!carry && tiles < 2) || smem > MAX_SMEM ||
      scratch == nullptr || scratch_bytes < scratch_need(n, f, h, k_pad, grid) ||
      (carry && (tickets == nullptr || (grid + GROUP - 1) / GROUP + 1 > TICKETS))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.feats = p[0]; a.mask = p[1]; a.bias = p[2]; a.w1 = p[3]; a.b1 = p[4];
  a.w2 = p[5]; a.b2 = p[6]; a.w3 = p[7]; a.b3 = p[8];
  a.n = n; a.f = f; a.h = h; a.hp = hp; a.k_pad = k_pad; a.tiles = tiles;
  a.n_groups = (grid + GROUP - 1) / GROUP;
  a.vec_w = h % 4 == 0 && reinterpret_cast<uintptr_t>(a.w1) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(a.w2) % 16 == 0;
  a.out_v = out_v;
  a.out_i = out_i;
  const long long entries = carry ? static_cast<long long>(grid + a.n_groups) * k_pad
                                  : tree_entries(n, k_pad);
  float* v0 = static_cast<float*>(scratch);
  int* i0 = reinterpret_cast<int*>(v0 + 2 * entries);
  a.pairs = static_cast<float2*>(scratch);
  a.lists_v = v0;
  a.lists_i = i0;
  a.h1g = path == GLOBAL_H1
              ? reinterpret_cast<float*>(static_cast<char*>(scratch) +
                                         selection_bytes(n, k_pad, grid))
              : nullptr;
  a.tickets = static_cast<unsigned*>(tickets);
  cudaError_t err = path == RESIDENT   ? launch_fused<RESIDENT>(a, grid, smem, st)
                    : path == STREAMED ? launch_fused<STREAMED>(a, grid, smem, st)
                                       : launch_fused<GLOBAL_H1>(a, grid, smem, st);
  if (err != cudaSuccess || carry) return static_cast<int>(err);

  // tree: the tiles' lists (len0 each) in v0/i0, merged level by level
  float* v1 = v0 + entries;
  int* i1 = i0 + entries;
  const float* cur_v = v0;
  const int* cur_i = i0;
  bool cur_in_first = true;
  int count = tiles;
  int len = k_pad < BM ? k_pad : BM;
  while (count > 1) {
    const int next = (count + 1) / 2;
    const int out_len = 2 * len < k_pad ? 2 * len : k_pad;
    float* dv = cur_in_first ? v1 : v0;
    int* di = cur_in_first ? i1 : i0;
    long long* d64 = nullptr;
    if (next == 1) { dv = out_v; di = nullptr; d64 = out_i; }
    const int stage = len <= MERGE_SMEM_LIST;
    const size_t msmem = stage ? static_cast<size_t>(4) * len * sizeof(float) : 0;
    const int threads = len < MERGE_THREADS ? ((len + 31) / 32) * 32 : MERGE_THREADS;
    merge_pairs<<<next, threads, msmem, st>>>(cur_v, cur_i, count, len, out_len, stage,
                                              dv, di, d64);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cur_v = dv;
    cur_i = di;
    cur_in_first = !cur_in_first;
    count = next;
    len = out_len;
  }
  return static_cast<int>(cudaSuccess);
}

}  // namespace

extern "C" {

// Shared-memory bytes of one CTA for feature width f, hidden width h and
// K_pad k_pad (the Python plan mirrors it).
long long select_topk_smem_bytes(int f, int h, int k_pad) {
  return 4LL * static_cast<long long>(smem_words(f, hp_of(h), k_pad));
}

// Scratch bytes of one launch: carry, (grid + groups) lists of K_pad
// (value, index) pairs; tree, two ping-pong list buffers; then, on the
// global path (H_pad > 320), grid slices of [H_pad][128] activations.  None
// needs zeroing.  The carry route also takes a ticket buffer of 1024 words,
// zero before its first launch (the kernel leaves it zero).
long long select_topk_scratch_bytes(int n, int f, int h, int k_pad, int grid) {
  return scratch_need(n, f, h, k_pad, grid);
}

// The scoring path (0 resident, 1 streamed, 2 global) at f and h.
int select_topk_path(int f, int h) { return path_of(f, hp_of(h)); }

// Resident CTAs per SM of the kernel on `path` (select_topk_path) at
// smem_bytes of shared memory, and its registers and local (spill) bytes
// per thread.  Returns 0 or a CUDA error.
int select_topk_occupancy(int path, long long smem_bytes, int* per_sm, int* regs,
                          int* local_bytes) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (path == RESIDENT) {
    err = occupancy<RESIDENT>(smem_bytes, per_sm, &attr);
  } else if (path == STREAMED) {
    err = occupancy<STREAMED>(smem_bytes, per_sm, &attr);
  } else if (path == GLOBAL_H1) {
    err = occupancy<GLOBAL_H1>(smem_bytes, per_sm, &attr);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return 0;
}

// feats (n, f), mask (n,), bias (n,) fp32 on the device; w1 (f, h), b1 (h,),
// w2 (h, h), b2 (h,), w3 (h,), b3 (1,) fp32, contiguous.  grid (1..tiles)
// as the plan gives it; scratch: select_topk_scratch_bytes; tickets: 1024
// words, zero.  Writes out_v (k_pad,) fp32 and out_i (k_pad,) int64.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success).
int select_topk_launch(const void* feats, const void* mask, const void* bias,
                       const void* w1, const void* b1, const void* w2,
                       const void* b2, const void* w3, const void* b3, int n,
                       int f, int h, int k_pad, int grid, void* scratch,
                       long long scratch_bytes, void* tickets, void* out_v, void* out_i,
                       void* stream) {
  const float* p[9] = {
      static_cast<const float*>(feats), static_cast<const float*>(mask),
      static_cast<const float*>(bias), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3)};
  return launch(p, n, f, h, k_pad, grid, scratch, scratch_bytes, tickets,
                static_cast<float*>(out_v), static_cast<long long*>(out_i),
                static_cast<cudaStream_t>(stream));
}

// The whole selection in one call: copies the record buffer (n * (f + 2)
// fp32: feats, then mask, then bias) from pinned host memory host_rec to
// dev_rec, launches, copies the k_pad values and k_pad int64 indices
// (dev_out: values then indices) into pinned host memory host_out, all on
// `stream`, then synchronises the stream.  Returns 0 or the first CUDA
// error.
int select_topk_run(const void* host_rec, void* dev_rec, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3, const void* b3,
                    int n, int f, int h, int k_pad, int grid, void* scratch,
                    long long scratch_bytes, void* tickets, void* dev_out, void* host_out,
                    void* stream) {
  if (!shape_ok(n, f, h, k_pad)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t rec = static_cast<size_t>(n) * (f + 2);
  cudaError_t err = cudaMemcpyAsync(dev_rec, host_rec, 4 * rec, cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* x = static_cast<const float*>(dev_rec);
  const float* p[9] = {
      x, x + static_cast<size_t>(n) * f, x + static_cast<size_t>(n) * (f + 1),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(w3), static_cast<const float*>(b3)};
  float* ov = static_cast<float*>(dev_out);
  const int rc = launch(p, n, f, h, k_pad, grid, scratch, scratch_bytes, tickets, ov,
                        reinterpret_cast<long long*>(ov + k_pad), st);
  if (rc != 0) return rc;
  err = cudaMemcpyAsync(host_out, dev_out, 12 * static_cast<size_t>(k_pad),
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamSynchronize(st));
}

}  // extern "C"
