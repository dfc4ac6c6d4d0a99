// RWKV6 ("Finch") WKV recurrence (forward), written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py:74, wkv6_pallas
// (body _kernel): per head of width n, with data-dependent decay
// w_t = exp(logw_t) (logw <= 0),
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// with the (n, n) state carried in from s0 and out as s_T, all in fp32.
//
// Contract (the plain version, kernels/rwkv6/ref.py, is held to it on the
// card by chip_smoke.py).  r, k, v, logw (B, T, H, n) fp32, read through
// their element strides: the model's projections in place, with no
// (B * H, T, n) transposed copies; u (B, H, n) through its strides (the
// model's u is shared by the batch: stride 0); s0 and s_T (B, H, n, n) and
// y (B, T, H, n) contiguous.  Any T >= 1, n <= 64.  Deterministic: no
// atomics, every sum in a fixed order.
//
// Why the recurrence.  The TPU kernel runs the chunked form: within a
// 64-token chunk it scales r by exp(cum_{t-1}) and k by exp(-cum_t), cum
// the running sum of logw, which turns the chunk into matrix products for
// the MXU.  exp(-cum) overflows fp32 once the decay summed over a chunk is
// large (logw = -7.4 over 64 tokens gives exp(470)).  The recurrence
// computes the same function and stays finite for any logw <= 0.  At n = 64
// its fp32 work is ~3 n^2 instructions a token and head, which the CUDA
// cores issue in about the time the bytes take (below), so a recurrence
// that keeps every SM busy is the design that fits this card.
//
// Design.  A head's (n, n) state is split over many threads: each thread
// holds a 4 x 4 register tile of S (rows 4 rg .. 4 rg + 3, columns 4 cg ..
// 4 cg + 3 of its CTA's slice).  At n = 64 a head's columns are split over
// 2 CTAs of 4 warps (columns of S are independent; each CTA reads r, k and
// w of every row): 160 heads (RWKV6-3B's prefill, B = 4) make 320 CTAs.
// With fewer heads than SMs (40 at B = 1) the tiles are 4 x 2, 2 CTAs of 8
// warps a head.  (Split over 4 CTAs of 2 warps instead, 40 heads ran
// slower: a CTA's per-chunk staging and pack are the same for fewer
// columns.)  Per token a thread reads its rows' r, k and w and its
// columns' v as four 16-byte shared loads and reuses each value across the
// tile: 16 FMAs for y's partial sums, 16 multiplies and 16 FMAs for S,
// eight tokens a loop trip.  y[j]'s sum over rows leaves the thread as a reduce-scatter over
// the warp's 4 row groups (3 shuffles for the 4 columns; 2 row groups and 1
// shuffle with 4 x 2 tiles), then the warps' partials meet in shared memory
// and are added in warp order once per 16-token chunk, by all threads.  The
// chunks are staged with cp.async, double-buffered: the next chunk's r, k,
// logw and v are in flight while the current one is consumed (16-byte
// copies where every row is 16-byte aligned, as the model's are, else
// 4-byte copies through the strides).  Once a chunk lands, all threads pack
// it, every token at once: exp(logw) in place, once per (token, row), and
// the bonus weight sum_i r[i] u[i] k[i] per token as THREADS / 16 threads'
// FMA chains and their butterfly; warp 0 adds bonus * v[j] to its partial.
// Rows and columns past n and tokens past T are zero-filled by the copies
// (logw = 0, so w = 1 and S stays as it is).  exp is the accurate expf (no
// fast-math flag).
//
// Bound on the card: the bytes, r, k, v, logw read once and y written once
// (20 B T H n), u (4 H n) and s0, s_T (8 B H n n), over 3.35 TB/s; at
// RWKV6-3B's prefill (B = 4, T = 1024, H = 40, n = 64) 215 MB, 64 us.  The
// operations, 5 n^2 per token and head (r.S; w * S + k v), plus O(n) for the
// bonus term and the exp, are 3.4 GFLOP, 51 us at 67 TFLOP/s.  What holds
// the kernel back after this design: latency, with 3 CTAs of 4 warps a SM
// (130 registers): a token's shared loads, FMAs and shuffles (four 16-byte
// loads and a quarter of a shuffle per 16 FMAs) and two barriers per 16
// tokens; the recurrence's own serial chain is one FMA a token.
//
// Shared memory at n = 64: 2 buffers x 16 tokens x (3 x 64 + 32) floats,
// the partials 16 x W x 32 floats (W = 4 warps, 8 with 4 x 2 tiles), u and
// the bonus weights: 36.3 KB, or 44.3 KB with 4 x 2 tiles.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TC = 16;     // tokens per staged chunk
constexpr int RT = 4;      // rows of S per thread

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* logw;
  const float* u;
  const float* s0;
  float* y;
  float* s_fin;
  int T, H, n, vec;
  long long r_sb, r_st, r_sh, r_si, k_sb, k_st, k_sh, k_si;
  long long v_sb, v_st, v_sh, v_si, w_sb, w_st, w_sh, w_si;
  long long u_sb, u_sh, u_si;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; src_bytes = 0 zero-fills the destination
// without reading the source.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A CTA takes NC = NMAX / CS columns of a head; a thread a tile of RT rows
// by CT columns (CT = 2 or 4), the warp's lanes CG column groups by RGW = CT
// row groups, so the reduce-scatter leaves each lane one column.
template <int NMAX, int CS, int CT>
struct Shape {
  static constexpr int NC = NMAX / CS;               // columns per CTA
  static constexpr int CG = NC / CT;                 // column groups
  static constexpr int RGS = NMAX / RT;              // row groups
  static constexpr int THREADS = RGS * CG;
  static constexpr int RGW = (32 / CG < RGS) ? 32 / CG : RGS;   // row groups a warp
  static constexpr int W = RGS / RGW;                // warps
  static_assert((CT == 2 || CT == 4) && RGW == CT, "a reduce-scatter of CT columns");
  static_assert(THREADS <= 32 || THREADS % 32 == 0, "whole warps");
};

template <int NMAX, int CS, int CT>
struct Smem {
  static constexpr int NC = Shape<NMAX, CS, CT>::NC;
  static constexpr int W = Shape<NMAX, CS, CT>::W;
  float r[2][TC][NMAX];
  float k[2][TC][NMAX];
  float w[2][TC][NMAX];      // logw as staged, exp(logw) once packed
  float v[2][TC][NC];
  float ypart[TC][W][NC];    // y's partial sums, one per warp
  float ruk[TC];             // sum_i r[i] u[i] k[i] per token
  float u[NMAX];
};

template <int NMAX, int CS, int CT>
__global__ void __launch_bounds__(Shape<NMAX, CS, CT>::THREADS, 2)
wkv6_kernel(const Args p) {
  using Sh = Shape<NMAX, CS, CT>;
  constexpr int NC = Sh::NC, CG = Sh::CG, RGW = Sh::RGW, W = Sh::W;
  constexpr int THREADS = Sh::THREADS;
  constexpr int PG = THREADS / TC;                   // threads a token in the pack
  static_assert(PG >= 1 && PG <= 32 && THREADS % TC == 0, "pack: whole token groups");
  constexpr unsigned MASK = THREADS < 32 ? (1u << THREADS) - 1u : 0xffffffffu;
  __shared__ __align__(16) Smem<NMAX, CS, CT> sm;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cg = lane % CG, gl = lane / CG;          // column group, row group in warp
  const int rg = warp * RGW + gl;                    // row group in the head
  const bool b0 = gl & 1, b1 = gl & 2;
  const int n = p.n;
  const long long bh = blockIdx.x / CS;
  const int col0 = static_cast<int>(blockIdx.x % CS) * NC;
  const long long b = bh / p.H, hh = bh % p.H;
  const long long r0 = b * p.r_sb + hh * p.r_sh, k0 = b * p.k_sb + hh * p.k_sh;
  const long long v0 = b * p.v_sb + hh * p.v_sh, w0 = b * p.w_sb + hh * p.w_sh;

  for (int i = tid; i < NMAX; i += THREADS) {
    sm.u[i] = i < n ? p.u[b * p.u_sb + hh * p.u_sh + i * p.u_si] : 0.f;
  }
  float S[RT][CT];
  const long long s_base = bh * n * n;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int row = RT * rg + i, col = col0 + CT * cg + c;
      S[i][c] = (row < n && col < n) ? p.s0[s_base + static_cast<long long>(row) * n + col]
                                     : 0.f;
    }
  }

  // Stage chunk `ch` into buffer `buf`: cp.async, committed as one group.
  auto stage = [&](int ch, int buf) {
    const int t0 = ch * TC, nt = min(TC, p.T - t0);
    if (p.vec) {
      for (int idx = tid; idx < TC * NMAX / 4; idx += THREADS) {
        const int tt = idx / (NMAX / 4), i = 4 * (idx % (NMAX / 4));
        const bool ok = tt < nt && i < n;
        const long long t = t0 + tt;
        cp_async16(&sm.r[buf][tt][i], ok ? p.r + r0 + t * p.r_st + i : p.r, ok);
        cp_async16(&sm.k[buf][tt][i], ok ? p.k + k0 + t * p.k_st + i : p.k, ok);
        cp_async16(&sm.w[buf][tt][i], ok ? p.logw + w0 + t * p.w_st + i : p.logw, ok);
      }
      for (int idx = tid; idx < TC * NC / 4; idx += THREADS) {
        const int tt = idx / (NC / 4), j = 4 * (idx % (NC / 4));
        const bool ok = tt < nt && col0 + j < n;
        const long long t = t0 + tt;
        cp_async16(&sm.v[buf][tt][j], ok ? p.v + v0 + t * p.v_st + col0 + j : p.v, ok);
      }
    } else {
      for (int idx = tid; idx < TC * NMAX; idx += THREADS) {
        const int tt = idx / NMAX, i = idx % NMAX;
        const bool ok = tt < nt && i < n;
        const long long t = t0 + tt;
        cp_async4(&sm.r[buf][tt][i], ok ? p.r + r0 + t * p.r_st + i * p.r_si : p.r, ok);
        cp_async4(&sm.k[buf][tt][i], ok ? p.k + k0 + t * p.k_st + i * p.k_si : p.k, ok);
        cp_async4(&sm.w[buf][tt][i],
                  ok ? p.logw + w0 + t * p.w_st + i * p.w_si : p.logw, ok);
      }
      for (int idx = tid; idx < TC * NC; idx += THREADS) {
        const int tt = idx / NC, j = idx % NC;
        const bool ok = tt < nt && col0 + j < n;
        const long long t = t0 + tt;
        cp_async4(&sm.v[buf][tt][j],
                  ok ? p.v + v0 + t * p.v_st + (col0 + j) * p.v_si : p.v, ok);
      }
    }
    cp_async_commit();
  };

  // y of chunk `ch`: the warps' partials added in warp order.
  auto reduce = [&](int ch) {
    const int t0 = ch * TC, nt = min(TC, p.T - t0);
    for (int idx = tid; idx < TC * NC; idx += THREADS) {
      const int tt = idx / NC, col = idx % NC;
      if (tt < nt && col0 + col < n) {
        float acc = sm.ypart[tt][0][col];
#pragma unroll
        for (int q = 1; q < W; ++q) acc += sm.ypart[tt][q][col];
        p.y[((b * p.T + t0 + tt) * p.H + hh) * n + col0 + col] = acc;
      }
    }
  };

  const int chunks = (p.T + TC - 1) / TC;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    cp_async_wait_all();
    __syncthreads();                 // chunk ch landed; chunk ch - 1 consumed
    if (ch + 1 < chunks) stage(ch + 1, buf ^ 1);
    if (ch > 0) reduce(ch - 1);
    // pack, all tokens at once: G = THREADS / TC threads a token, each
    // taking the float4s q = gi, gi + G, ... of its rows: exp(logw) in place,
    // and its FMA chain of r u k, then a butterfly over the G threads
    {
      const int tt = tid / PG, gi = tid % PG;
      float acc = 0.f;
#pragma unroll
      for (int q = gi; q < NMAX / 4; q += PG) {
        float4* wp = reinterpret_cast<float4*>(&sm.w[buf][tt][4 * q]);
        const float4 rq = *reinterpret_cast<const float4*>(&sm.r[buf][tt][4 * q]);
        const float4 kq = *reinterpret_cast<const float4*>(&sm.k[buf][tt][4 * q]);
        const float4 uq = *reinterpret_cast<const float4*>(&sm.u[4 * q]);
        float4 a = *wp;
        a.x = expf(a.x);
        a.y = expf(a.y);
        a.z = expf(a.z);
        a.w = expf(a.w);
        *wp = a;
        acc = fmaf(rq.x * uq.x, kq.x, acc);
        acc = fmaf(rq.y * uq.y, kq.y, acc);
        acc = fmaf(rq.z * uq.z, kq.z, acc);
        acc = fmaf(rq.w * uq.w, kq.w, acc);
      }
#pragma unroll
      for (int off = PG / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(MASK, acc, off);
      if (gi == 0) sm.ruk[tt] = acc;
    }
    __syncthreads();                 // the chunk is packed
    const int nt = min(TC, p.T - ch * TC);
    // eight tokens a trip: independent work for the scheduler across tokens
    // (the serial chain is one FMA a token)
#pragma unroll 8
    for (int tt = 0; tt < nt; ++tt) {
      const float4 rq = *reinterpret_cast<const float4*>(&sm.r[buf][tt][RT * rg]);
      const float4 kq = *reinterpret_cast<const float4*>(&sm.k[buf][tt][RT * rg]);
      const float4 wv = *reinterpret_cast<const float4*>(&sm.w[buf][tt][RT * rg]);
      float vv[CT];
      if constexpr (CT == 4) {
        const float4 vq = *reinterpret_cast<const float4*>(&sm.v[buf][tt][CT * cg]);
        vv[0] = vq.x, vv[1] = vq.y, vv[2] = vq.z, vv[3] = vq.w;
      } else {
        const float2 vq = *reinterpret_cast<const float2*>(&sm.v[buf][tt][CT * cg]);
        vv[0] = vq.x, vv[1] = vq.y;
      }
      const float rr[RT] = {rq.x, rq.y, rq.z, rq.w};
      const float kk[RT] = {kq.x, kq.y, kq.z, kq.w};
      const float ww[RT] = {wv.x, wv.y, wv.z, wv.w};
      float part[CT];
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        float a = rr[0] * S[0][c];
#pragma unroll
        for (int i = 1; i < RT; ++i) a = fmaf(rr[i], S[i][c], a);
        part[c] = a;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int c = 0; c < CT; ++c) S[i][c] = fmaf(ww[i], S[i][c], kk[i] * vv[c]);
      }
      // reduce-scatter over the warp's CT row groups: the lane pair that
      // differs in row-group bit 0 swaps CT / 2 columns, bit 1 (at CT = 4)
      // one; the lane keeps column cl of its group, summed over the groups
      float val, vcol;
      int cl;
      if constexpr (CT == 4) {
        const float s0 = b0 ? part[0] : part[2], s1 = b0 ? part[1] : part[3];
        float k0v = b0 ? part[2] : part[0], k1v = b0 ? part[3] : part[1];
        k0v += __shfl_xor_sync(MASK, s0, CG);
        k1v += __shfl_xor_sync(MASK, s1, CG);
        val = b1 ? k1v : k0v;
        val += __shfl_xor_sync(MASK, b1 ? k0v : k1v, 2 * CG);
        cl = 2 * b0 + b1;
        vcol = b0 ? (b1 ? vv[3] : vv[2]) : (b1 ? vv[1] : vv[0]);
      } else {
        val = (b0 ? part[1] : part[0]) + __shfl_xor_sync(MASK, b0 ? part[0] : part[1], CG);
        cl = b0;
        vcol = b0 ? vv[1] : vv[0];
      }
      if (warp == 0) val = fmaf(sm.ruk[tt], vcol, val);
      sm.ypart[tt][warp][CT * cg + cl] = val;
    }
  }
  __syncthreads();
  reduce(chunks - 1);

#pragma unroll
  for (int i = 0; i < RT; ++i) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const int row = RT * rg + i, col = col0 + CT * cg + c;
      if (row < n && col < n) p.s_fin[s_base + static_cast<long long>(row) * n + col] = S[i][c];
    }
  }
}

using KernelFn = void (*)(const Args);

struct Config {
  KernelFn fn;
  int nmax, cs, ct, threads;
};

template <int NMAX, int CS, int CT>
Config config() {
  return {wkv6_kernel<NMAX, CS, CT>, NMAX, CS, CT, Shape<NMAX, CS, CT>::THREADS};
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// The instantiation for width n and bh = batch * heads: 4 x 4 tiles; at
// n > 32 a head's columns go to 2 CTAs, and with fewer heads than SMs the
// tiles are 4 x 2, twice the warps a head.
Config choose(int n, long long bh) {
  if (n <= 16) return config<16, 1, 4>();
  if (n <= 32) return config<32, 1, 4>();
  return bh < sm_count() ? config<64, 2, 2>() : config<64, 2, 4>();
}

// Every (b, t, h) row of a (B, T, H, n) tensor is contiguous and 16-byte
// aligned, so 16-byte copies may stage it: n a multiple of 4, unit entry
// stride, the strides of the dimensions longer than 1 multiples of 4 floats
// and the data 16-byte aligned.
bool rows16(const void* ptr, int batch, int T, int H, int n, long long sb,
            long long st, long long sh, long long si) {
  return n % 4 == 0 && si == 1 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
         (batch == 1 || sb % 4 == 0) && (T == 1 || st % 4 == 0) && (H == 1 || sh % 4 == 0);
}

}  // namespace

extern "C" {

// r, k, v, logw: (B, T, H, n) fp32 with element strides (batch, time, head,
// entry); u: (B, H, n) with strides (batch, head, entry); s0 (B, H, n, n)
// contiguous.  Where every row of r, k, v and logw is 16-byte aligned
// (rows16) the chunks are staged with 16-byte copies, else with 4-byte ones.
// Writes y (B, T, H, n) and s_fin (B, H, n, n), contiguous fp32.  Launches
// on `stream`, does not synchronise, returns cudaGetLastError() (0 on
// success).
int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* s0, void* y, void* s_fin, int batch,
                int T, int H, int n, long long r_sb, long long r_st,
                long long r_sh, long long r_si, long long k_sb, long long k_st,
                long long k_sh, long long k_si, long long v_sb, long long v_st,
                long long v_sh, long long v_si, long long w_sb, long long w_st,
                long long w_sh, long long w_si, long long u_sb, long long u_sh,
                long long u_si, void* stream) {
  if (batch < 1 || T < 1 || H < 1 || n < 1 || n > 64 ||
      static_cast<long long>(batch) * H * 2 > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{static_cast<const float*>(r),    static_cast<const float*>(k),
         static_cast<const float*>(v),    static_cast<const float*>(logw),
         static_cast<const float*>(u),    static_cast<const float*>(s0),
         static_cast<float*>(y),          static_cast<float*>(s_fin),
         T, H, n,
         rows16(r, batch, T, H, n, r_sb, r_st, r_sh, r_si) &&
             rows16(k, batch, T, H, n, k_sb, k_st, k_sh, k_si) &&
             rows16(v, batch, T, H, n, v_sb, v_st, v_sh, v_si) &&
             rows16(logw, batch, T, H, n, w_sb, w_st, w_sh, w_si),
         r_sb, r_st, r_sh, r_si, k_sb, k_st, k_sh, k_si,
         v_sb, v_st, v_sh, v_si, w_sb, w_st, w_sh, w_si,
         u_sb, u_sh, u_si};
  const long long bh = static_cast<long long>(batch) * H;
  const Config c = choose(n, bh);
  c.fn<<<static_cast<unsigned>(bh * c.cs), c.threads, 0,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration for width n and bh = batch * heads, as
// out[0..6]: the row capacity NMAX, the column split, the tile's columns,
// threads per CTA, the resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the static shared memory
// per CTA in bytes and the registers per thread.  Returns a CUDA error code
// (0 on success).
int wkv6_occupancy(int n, long long bh, int* out) {
  if (n < 1 || n > 64 || bh < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Config c = choose(n, bh);
  int ctas = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, reinterpret_cast<const void*>(c.fn), c.threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(c.fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = c.nmax;
  out[1] = c.cs;
  out[2] = c.ct;
  out[3] = c.threads;
  out[4] = ctas;
  out[5] = static_cast<int>(attr.sharedSizeBytes);
  out[6] = attr.numRegs;
  return 0;
}

}  // extern "C"
