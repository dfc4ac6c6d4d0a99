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

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B, int nqb,
              const Params& p, cudaStream_t stream) {
  if (p.dh <= 64) return launch<T, 64, 64>(q, k, v, o, B, nqb, p, stream);
  if (p.dh <= 128) return launch<T, 128, 32>(q, k, v, o, B, nqb, p, stream);
  return launch<T, 256, 32>(q, k, v, o, B, nqb, p, stream);
}

}  // namespace

extern "C" {

// q: (B, S, H, Dh) with element strides q_sb, q_ss, q_sh (and 1); k, v:
// (B, S, KV, Dh) likewise; o: (B, S, H, Dh) contiguous.  dtype: 0 fp32,
// 1 bf16.  causal: 0 or 1; window: 0 for none, else >= 1.  The
// wrapper checks that H % KV == 0, H / KV <= 64, Dh <= 256, that rows,
// strides and pointers are 16-byte aligned and that B, KV <= 65535.
// Launches on `stream`, does not synchronise, returns cudaGetLastError()
// (0 on success).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                           int dtype, int B, int S, int H, int KV, int dh,
                           long long q_sb, long long q_ss, long long q_sh,
                           long long k_sb, long long k_ss, long long k_sh,
                           long long v_sb, long long v_ss, long long v_sh,
                           int causal, int window, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || H % KV != 0 || H / KV > ROWS || dh < 4 ||
      dh > 256 || window < 0 || B > 65535 || KV > 65535) {
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
  switch (dtype) {
    case 0: return launch_dh<float>(q, k, v, o, B, nqb, p, st);
    case 1: return launch_dh<__nv_bfloat16>(q, k, v, o, B, nqb, p, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
