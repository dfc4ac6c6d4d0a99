// Flash attention (prefill), written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:93,
// flash_attention_folded (body _kernel): for every query row, the softmax
// over the allowed keys of q . k * Dh^-0.5, applied to v, with grouped-query
// attention (G = H / KV query heads share one K/V head).  A key is allowed
// when kpos <= qpos (causal) and kpos > qpos - window (sliding window).
// Running max m, sum l and output accumulator are fp32; the output is
// written in the inputs' type.
//
// Contract (the plain version, kernels/flash_attention/ref.py, is held to
// it on the card by chip_smoke.py).  q (B, S, H, Dh), k and v (B, S, KV,
// Dh), all of one type (fp32 or bf16), read in place through their
// element strides (the last dimension contiguous); o (B, S, H, Dh)
// contiguous.  Masked scores are the reference's finite NEG_INF = -1e30, not
// -inf: a row whose first visited tile holds no allowed key accumulates
// exp(0) = 1 per masked key, and the correction exp(m_prev - m_new) of the
// first tile that holds one is exactly 0, which clears it (as in the TPU
// kernel).  Every real row has an allowed key (itself when causal; the
// wrapper refuses window < 1), so no output is junk.  The division is
// acc / max(l, 1e-30), as in the reference.
//
// Design.  The TPU kernel folds the G query heads of a group into the rows
// of its q tile ((B*KV, S*G, Dh)) so that its sequential grid loads each K/V
// tile once per group; it needs transposed copies of q, k and v.  Here one
// CTA takes one (batch, KV head, block of query positions) and all G heads
// of the group at once: its ROWS = 64 rows are (position, head) pairs,
// BQ = 64 / G positions (G <= 64), read from q in place (the G heads of one
// position are adjacent in memory).  The TPU's sequential kv grid dimension
// becomes a loop over key tiles inside the CTA, which skips tiles that lie
// wholly in the future of the block's last query or wholly before the
// window of its first (the TPU kernel's pl.when skip).  The last tile may be
// ragged: keys past S are loaded as zeros and masked, so any S >= 1 works
// (the Pallas wrapper requires S to be a multiple of its blocks).
//
// Each key tile (BK keys of K and V) is staged in shared memory as fp32 and
// used by all 64 rows.  256 threads: 8 lanes share two rows (rows ty and
// ty + 32); for scores lane tx takes keys tx + 8j, for the output it takes
// columns 4tx + 32j, so shared-memory reads are conflict-free float4s or
// broadcasts.  The 8 lanes of a row reduce max and sum with warp shuffles;
// P goes through shared memory to the P.V product.  All products are fp32
// FMAs on the CUDA cores (no tensor cores yet), so fp32 inputs get fp32
// arithmetic throughout.  Deterministic: no atomics, fixed summation order.
//
// Bound on the card: the operations, 4 * Dh per allowed (query row, key)
// pair (q.k and p.v, two each), over the tensor-core rate of the inputs'
// type (989 TFLOP/s bf16) or the fp32 rate (67 TFLOP/s), or the bytes
// (q, k, v read once, o written once) over 3.35 TB/s, whichever is larger;
// at Yi-6B's prefill (B=4, S=1024, 32 heads over 4, Dh=128, causal, bf16)
// the operations: 34.4 GFLOP, 35 us at the bf16 rate.  This kernel runs on
// the fp32 CUDA cores, so it cannot come near that: wgmma with TMA-fed
// tiles is the later step.
//
// Shared memory: (ROWS + 2 * BK) * (DMAX + 4) + ROWS * (BK + 1) floats:
// 68.9 KB (Dh <= 64, BK = 64), 76.0 KB (Dh <= 128, BK = 32), 141.6 KB
// (Dh <= 256, BK = 32).
//
// Two kernels, one entry.  flash_attention_launch takes a route that the
// wrapper chooses from the dtype and Dh alone (kernel.py, flash_route):
//   route 0, flash_fwd_kernel: fp32 inputs, and bf16 with 128 < Dh <= 256;
//     the CUDA-core design above.
//   route 1, flash_fwd_mma_kernel: bf16 inputs with Dh <= 128 (every served
//     model: Yi-6B 128, h2o-danube 120, Hymba 64), on the tensor cores.
// Each (dtype, Dh) has exactly one route: the entry refuses any other, so
// route 0 builds flash_fwd_kernel for bf16 only at Dh <= 256, and nothing
// falls back.
//
// The tensor-core kernel (FlashAttention-2's design, except for P).  The
// same grid and rows as above: one CTA per (batch, KV head, block of 64 / G
// positions), 64 (position, head) rows, all G heads of a group read from q
// in place, so one K/V tile serves the whole group.  128 threads, 4 warps of
// 16 rows each.  Q is loaded once with cp.async (rows past the block's end
// and columns Dh..Dh_pad zero, Dh_pad = 64 or 128, so h2o-danube's 120 pads
// to 128) and kept in registers as mma A fragments (ldmatrix) for the whole
// key loop.  K and V tiles of 64 keys stay bf16 in shared memory, rows
// padded by 8 elements (16 bytes) so that the 8 row addresses of an
// ldmatrix fall on distinct banks, and double-buffered with cp.async: tile
// j + 1 is in flight while tile j is computed; keys past S are zero-filled
// (cp.async with a source size of 0) and masked.  Each thread copies one
// fixed 16-byte column of every (128 / (Dh_pad / 8))-th row, so the copy
// loops hold no division.  Shared memory: 4 tiles of 64 x (Dh_pad + 8)
// bf16, Q staged in the second K buffer until tile 1 loads: 36 KB at
// Dh_pad 64, 68 KB at 128.  Occupancy hints: 2 CTAs an SM at Dh_pad 128
// (251 registers, no spills), 3 at 64 (168 registers, 24 bytes of spills):
// on the card they ran faster at Yi-6B's, h2o-danube's and Hymba's prefill
// than no hint (178 / 134 registers) and than 3 / 4 CTAs an SM (spills).
//   S = Q K^T: mma.sync m16n8k16 bf16 x bf16 -> fp32 (the products are exact
//     in fp32, the sums fp32), K's B fragments by ldmatrix without transpose.
//   Mask and online softmax in registers, in base 2 (log2(e) folded into the
//     scale, ex2.approx), with the reference's finite NEG_INF: a row's max and sum
//     over its 64 keys take two __shfl_xor_sync within the quad of lanes that
//     holds it; the rule above (a first visited tile with no allowed key is
//     cleared by exp(m_prev - m_new) = 0) holds as it stands.
//   O += P V with P split: the score accumulators are reused as the next
//     mma's A fragments (no shared-memory round trip), as P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), two mmas per k-step against the same V fragment
//     (ldmatrix.trans).  P_hi + P_lo carries 16 of P's 24 bits.  Rounding P
//     once to bf16, as FlashAttention-2 does, adds an error that scales with
//     the row's mass of v, not with |o|: emulated on the CPU in fp32 at
//     S=1024, G=8, Dh=128; S=2048, G=5, Dh=64, window 1024; S=1000, G=4,
//     Dh=120, window 64 (N(0, 1) inputs), it broke the card check's bf16
//     tolerance (2^-7 |ref| + 2e-5 per element) on 47k-103k elements by up
//     to 42x; with the split the error is that of rounding the output alone,
//     at most 0.49 of the tolerance (tests/test_torch_flash_attention.py
//     pins both at small shapes).  The split costs 1.5x the tensor-core work
//     of bf16 P.
//   Skipped key tiles, acc / max(l, 1e-30) rounded to bf16, no atomics and a
//     fixed order of sums, as above.
// Bound as above (34.4 GFLOP, 35 us at Yi-6B's prefill); this kernel does
// 1.5x that on the tensor cores with mma.sync, which reaches a part of the
// card's rate only: wgmma fed by TMA is the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int TX = 8;                 // lanes that share one row
constexpr int TY = THREADS / TX;      // 32 row groups
constexpr int RT = 2;                 // rows per thread: ty and ty + TY
constexpr int ROWS = TY * RT;         // 64 (position, head) rows per CTA
constexpr float NEG_INF = -1e30f;

struct Params {
  int S, H, KV, G, dh, bq, causal, window;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
};

// 16 bytes of the input type -> fp32
template <typename T> struct Chunk;

template <> struct Chunk<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* d) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  static __device__ __forceinline__ void store4(float* p, const float* s) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  }
};

// bf16: 16 bytes are four 32-bit words of two elements each,
// unpacked with bit operations (no type punning of registers)
template <> struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* d) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      d[2 * i] = __uint_as_float(w[i] << 16);            // exact widening
      d[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ unsigned pack(float a, float b) {
    return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a))) |
           (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b))) << 16);
  }
  static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float* s) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack(s[0], s[1]), pack(s[2], s[3]));
  }
};

// Copies `rows` rows of dh elements (16-byte chunks) from global memory to
// shared fp32 rows of stride ld; row r comes from src(r), or is zero when
// src(r) is null.
template <typename T, typename RowPtr>
__device__ __forceinline__ void stage_rows(float* dst, int ld, int rows, int dh,
                                           RowPtr src) {
  constexpr int N = Chunk<T>::N;
  const int cpr = dh / N;
  for (int c = threadIdx.x; c < rows * cpr; c += THREADS) {
    const int r = c / cpr, part = c - r * cpr;
    const T* p = src(r);
    float vals[N];
    if (p != nullptr) {
      Chunk<T>::load(p + part * N, vals);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] = 0.f;
    }
    float* d = dst + r * ld + part * N;
#pragma unroll
    for (int e = 0; e < N; e += 4) {
      *reinterpret_cast<float4*>(d + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
    }
  }
}

template <typename T, int DMAX, int BK>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, const Params p) {
  constexpr int LD = DMAX + 4;        // fp32 row stride of Q, K, V tiles
  constexpr int LP = BK + 1;          // row stride of P
  constexpr int KPT = BK / TX;        // keys per thread per tile
  constexpr int CPT = DMAX / 32;      // output float4 columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + ROWS * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = p.S, G = p.G, dh = p.dh;
  const int q0 = blockIdx.x * p.bq;
  const int q_last = min(q0 + p.bq, S) - 1;
  const int nrows = (q_last - q0 + 1) * G;

  const T* qbase = q + b * p.q_sb + (long long)kvh * G * p.q_sh;
  stage_rows<T>(Qs, LD, ROWS, dh, [=](int r) -> const T* {
    if (r >= nrows) return nullptr;
    const int qi = r / G;
    return qbase + (long long)(q0 + qi) * p.q_ss + (long long)(r - qi * G) * p.q_sh;
  });

  int qpos[RT];
  bool rvalid[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty + TY * i;
    rvalid[i] = r < nrows;
    qpos[i] = q0 + r / G;
  }
  float m[RT], l[RT], acc[RT][CPT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // key tiles that can hold an allowed key for some row of this block
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kend = p.causal ? q_last + 1 : S;
  const T* kbase = k + b * p.k_sb + (long long)kvh * p.k_sh;
  const T* vbase = v + b * p.v_sb + (long long)kvh * p.v_sh;

  for (int k0 = (kbeg / BK) * BK; k0 < kend; k0 += BK) {
    __syncthreads();                  // the last tile's readers are done
    stage_rows<T>(Ks, LD, BK, dh, [=](int r) -> const T* {
      return k0 + r < S ? kbase + (long long)(k0 + r) * p.k_ss : nullptr;
    });
    stage_rows<T>(Vs, LD, BK, dh, [=](int r) -> const T* {
      return k0 + r < S ? vbase + (long long)(k0 + r) * p.v_ss : nullptr;
    });
    __syncthreads();

    float s[RT][KPT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; d += 4) {
      float4 qv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (tx + TX * j) * LD + d);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv.x, a);
          a = fmaf(qv[i].y, kv.y, a);
          a = fmaf(qv[i].z, kv.z, a);
          a = fmaf(qv[i].w, kv.w, a);
          s[i][j] = a;
        }
      }
    }

    // mask, online softmax (the reference's arithmetic), P to shared memory
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kpos = k0 + tx + TX * j;
        const bool ok = rvalid[i] && kpos < S && (!p.causal || kpos <= qpos[i]) &&
                        (p.window <= 0 || kpos > qpos[i] - p.window);
        s[i][j] = ok ? s[i][j] * p.scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float pv = expf(s[i][j] - m_new);
        rs += pv;
        Ps[(ty + TY * i) * LP + tx + TX * j] = pv;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) pv[i] = Ps[(ty + TY * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = 4 * tx + 32 * j;
        if (c < dh) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * LD + c);
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            acc[i][j][0] = fmaf(pv[i], vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pv[i], vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pv[i], vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pv[i], vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    if (!rvalid[i]) continue;
    const int r = ty + TY * i, qi = r / G, g = r - qi * G;
    T* out = o + (((long long)b * S + q0 + qi) * p.H + (long long)kvh * G + g) * dh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = 4 * tx + 32 * j;
      if (c < dh) {
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) y[e] = acc[i][j][e] / den;
        Chunk<T>::store4(out + c, y);
      }
    }
  }
}

constexpr size_t smem_bytes(int dmax, int bk) {
  return sizeof(float) * ((size_t)(ROWS + 2 * bk) * (dmax + 4) + (size_t)ROWS * (bk + 1));
}

template <typename T, int DMAX, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B, int nqb,
           const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes(DMAX, BK);
  // per device, so set before every launch (a host call of ~1 us)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DMAX, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nqb, p.KV, B);
  flash_fwd_kernel<T, DMAX, BK><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

// route 0: fp32 at every Dh; bf16 only at 128 < Dh <= 256 (route 1 takes the
// rest), so bf16 has one build
int launch_fma(const void* q, const void* k, const void* v, void* o, int dtype,
               int B, int nqb, const Params& p, cudaStream_t stream) {
  if (dtype == 1) return launch<__nv_bfloat16, 256, 32>(q, k, v, o, B, nqb, p, stream);
  if (p.dh <= 64) return launch<float, 64, 64>(q, k, v, o, B, nqb, p, stream);
  if (p.dh <= 128) return launch<float, 128, 32>(q, k, v, o, B, nqb, p, stream);
  return launch<float, 256, 32>(q, k, v, o, B, nqb, p, stream);
}

// ---------------------------------------------------------------------------
// route 1: bf16, Dh <= 128, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;      // 4 warps x 16 rows = ROWS
constexpr int MMA_BK = 64;            // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d (16x8 fp32) += a (16x16 bf16, row) . b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (ex2.approx: 2 ulp; subnormal results flushed to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two fp32 -> bf16x2, round to nearest even; lo in the low half
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi); x - hi is exact in fp32
__device__ __forceinline__ void split_bf16x2(float x0, float x1, unsigned& hi,
                                             unsigned& lo) {
  hi = pack_bf16x2(x0, x1);
  lo = pack_bf16x2(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// DP: Dh padded to 64 or 128.  Fragment layouts are those of mma.m16n8k16:
// lane = 4 * gid + tig holds rows gid and gid + 8 of its warp's 16, and in
// each 8-column block the columns 2 tig and 2 tig + 1.
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS, DP == 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, const Params p) {
  constexpr int LDS = DP + 8;         // bf16 row stride in shared memory
  constexpr int TILE = MMA_BK * LDS;  // one K or V tile
  constexpr int NKS = DP / 16;        // k-steps of q.k over Dh
  constexpr int NDB = DP / 8;         // 8-column blocks of the output
  constexpr int NKB = MMA_BK / 8;     // 8-key blocks of a tile
  extern __shared__ uint4 smem_mma[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_mma);   // two tiles
  bf16* Vs = Ks + 2 * TILE;           // two tiles
  bf16* Qs = Ks + TILE;               // Q lives in K's second buffer until tile 1 loads

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int S = p.S, G = p.G, dh = p.dh;
  const int q0 = blockIdx.x * p.bq;
  const int q_last = min(q0 + p.bq, S) - 1;
  const int nrows = (q_last - q0 + 1) * G;
  const int cpr = dh / 8;             // 16-byte chunks per row

  // columns dh..DP of every row stay zero (cp.async writes only < dh)
  if (dh < DP) {
    const int pad = DP / 8 - cpr;
    for (int c = tid; c < 4 * MMA_BK * pad; c += MMA_THREADS) {
      const int r = c / pad;
      *reinterpret_cast<uint4*>(Ks + r * LDS + (cpr + c - r * pad) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // every thread copies the same 16-byte column `part` of rows r0 + i * RSTEP
  constexpr int CPR = DP / 8;                 // chunks per padded row
  constexpr int RSTEP = MMA_THREADS / CPR;    // rows a pass covers
  const int part = tid % CPR, r0 = tid / CPR;
  const bool col_in = part < cpr;
  const bf16* qbase = q + b * p.q_sb + (long long)kvh * G * p.q_sh + part * 8;
#pragma unroll
  for (int r = r0; r < ROWS; r += RSTEP) {
    if (!col_in) continue;
    const bf16* src = q;
    int bytes = 0;
    if (r < nrows) {
      const int qi = r / G;
      src = qbase + (long long)(q0 + qi) * p.q_ss + (long long)(r - qi * G) * p.q_sh;
      bytes = 16;
    }
    cp_async16(smem_addr(Qs + r * LDS + part * 8), src, bytes);
  }
  cp_async_commit();

  const bf16* kbase = k + b * p.k_sb + (long long)kvh * p.k_sh + part * 8;
  const bf16* vbase = v + b * p.v_sb + (long long)kvh * p.v_sh + part * 8;
  auto load_kv = [&](int k0, int buf) {
    if (col_in) {
      const unsigned kd = smem_addr(Ks + buf * TILE + r0 * LDS + part * 8);
      const unsigned vd = smem_addr(Vs + buf * TILE + r0 * LDS + part * 8);
#pragma unroll
      for (int i = 0; i < MMA_BK / RSTEP; ++i) {
        const int row = k0 + r0 + i * RSTEP;
        const bool in = row < S;
        const long long src = in ? row : 0;
        cp_async16(kd + i * RSTEP * LDS * 2, kbase + src * p.k_ss, in ? 16 : 0);
        cp_async16(vd + i * RSTEP * LDS * 2, vbase + src * p.v_ss, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // key tiles that can hold an allowed key for some row of this block
  const int kbeg = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kend = p.causal ? q_last + 1 : S;
  const int kfirst = (kbeg / MMA_BK) * MMA_BK;
  load_kv(kfirst, 0);

  cp_async_wait<1>();                 // Q has landed (tile 0 may be in flight)
  __syncthreads();
  unsigned qf[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks)
    ldmatrix_x4(qf[ks], smem_addr(Qs + (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                                  (lane >> 4) * 8));
  __syncthreads();                    // every warp holds Q before tile 1 overwrites it

  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = q0 + (warp * 16 + gid + 8 * i) / G;
  const float sc = p.scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NDB][4];
#pragma unroll
  for (int j = 0; j < NDB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  int buf = 0;
  for (int k0 = kfirst; k0 < kend; k0 += MMA_BK, buf ^= 1) {
    if (k0 + MMA_BK < kend) {
      load_kv(k0 + MMA_BK, buf ^ 1);  // the next tile flies while this one computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = Ks + buf * TILE;
    const bf16* vt = Vs + buf * TILE;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NKB][4];
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ks += 2) {
#pragma unroll
      for (int nb = 0; nb < NKB; ++nb) {
        unsigned kb[4];               // b0, b1 of k-steps ks and ks + 1
        ldmatrix_x4(kb, smem_addr(kt + (nb * 8 + (lane & 7)) * LDS + ks * 16 +
                                  (lane >> 3) * 8));
        mma_bf16(s[nb], qf[ks], kb[0], kb[1]);
        mma_bf16(s[nb], qf[ks + 1], kb[2], kb[3]);
      }
    }

    // mask (only where some key of the tile is not allowed for some row),
    // online softmax in base 2
    const bool need_mask = k0 + MMA_BK > S || (p.causal && k0 + MMA_BK - 1 > q0) ||
                           (p.window > 0 && k0 <= q_last - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = s[nb][e] * sc;
        if (need_mask) {
          const int kpos = k0 + nb * 8 + 2 * tig + (e & 1);
          const bool ok = kpos < S && (!p.causal || kpos <= qpos[i]) &&
                          (p.window <= 0 || kpos > qpos[i] - p.window);
          x = ok ? x : NEG_INF;
        }
        s[nb][e] = x;
        mx[i] = fmaxf(mx[i], x);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      const float corr = ex2(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
#pragma unroll
      for (int j = 0; j < NDB; ++j) {
        acc[j][2 * i] *= corr;
        acc[j][2 * i + 1] *= corr;
      }
    }
#pragma unroll
    for (int nb = 0; nb < NKB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = ex2(s[nb][e] - m[e >> 1]);
        s[nb][e] = pv;
        l[e >> 1] += pv;              // this lane's part of the row sum
      }

    // O += P_hi V + P_lo V, 16 keys a k-step; score blocks 2kk and 2kk + 1
    // are the A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int db = 0; db < NDB; db += 2) {
        unsigned vb[4];               // b0, b1 of column blocks db and db + 1
        ldmatrix_x4_trans(vb, smem_addr(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                 LDS + db * 8 + (lane >> 4) * 8));
        mma_bf16(acc[db], ph, vb[0], vb[1]);
        mma_bf16(acc[db], pl, vb[0], vb[1]);
        mma_bf16(acc[db + 1], ph, vb[2], vb[3]);
        mma_bf16(acc[db + 1], pl, vb[2], vb[3]);
      }
    }
    __syncthreads();                  // every warp is done with this buffer
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int r = warp * 16 + gid + 8 * i;
    if (r >= nrows) continue;
    const int qi = r / G, g = r - qi * G;
    bf16* out = o + (((long long)b * S + q0 + qi) * p.H + (long long)kvh * G + g) * dh;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NDB; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < dh)
        *reinterpret_cast<unsigned*>(out + c) =
            pack_bf16x2(acc[j][2 * i] / den, acc[j][2 * i + 1] / den);
    }
  }
}

constexpr size_t mma_smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(4 * MMA_BK) * (dp + 8);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B, int nqb,
               const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes(DP);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nqb, p.KV, B);
  flash_fwd_mma_kernel<DP><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q: (B, S, H, Dh) with element strides q_sb, q_ss, q_sh (and 1); k, v:
// (B, S, KV, Dh) likewise; o: (B, S, H, Dh) contiguous.  dtype: 0 fp32,
// 1 bf16.  causal: 0 or 1; window: 0 for none, else >= 1.  route: 1 the
// tensor-core kernel for bf16 with Dh <= 128, 0 the CUDA-core kernel for
// everything else; any other pairing is refused.
// The wrapper checks that H % KV == 0, H / KV <= 64, Dh <= 256, that rows,
// strides and pointers are 16-byte aligned and that B, KV <= 65535.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int dtype, int B, int S, int H, int KV, int dh,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           int causal, int window, int route, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > ROWS || dh < 4 ||
      dh > 256 || window < 0 || B > 65535 || KV > 65535 || dtype < 0 || dtype > 1 ||
      route != ((dtype == 1 && dh <= 128) ? 1 : 0) || (route == 1 && dh % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.S = S; p.H = H; p.KV = KV; p.G = H / KV; p.dh = dh;
  p.bq = ROWS / p.G;
  p.causal = causal; p.window = window;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));  // fp32(Dh^-0.5)
  const int nqb = (S + p.bq - 1) / p.bq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    return dh <= 64 ? launch_mma<64>(q, k, v, o, B, nqb, p, st)
                    : launch_mma<128>(q, k, v, o, B, nqb, p, st);
  }
  return launch_fma(q, k, v, o, dtype, B, nqb, p, st);
}

}  // extern "C"
