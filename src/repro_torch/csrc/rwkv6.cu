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
// y (B, T, H, n) contiguous.  Any T >= 1, n <= 64.
//
// Design.  The TPU kernel runs the chunked form: within a 64-token chunk it
// scales r by exp(cum_{t-1}) and k by exp(-cum_t), cum the running sum of
// logw, which turns the chunk into matrix products for the MXU.  exp(-cum)
// grows with the decay summed over the chunk and overflows fp32 once the
// log-decay is large (logw = -7.4 over 64 tokens gives exp(470)).  This
// kernel runs the recurrence, which computes the same function and stays
// finite for any logw <= 0 (the classic RWKV CUDA design).  One CTA per
// (batch, head) with NMAX >= n threads; thread j owns column j of S, n fp32
// values in registers.  Each TC = 32-token chunk of r, k, w = exp(logw) and
// v is staged in shared memory (r, k, w of one (token, row) packed in one
// float4, rows padded so that the per-token reductions are conflict-free),
// with the bonus term's weight sum_i r[i] u[i] k[i] per token, so that
//   y_t[j] = sum_i r[i] S[i][j] + v[j] * sum_i r[i] u[i] k[i]
// costs each thread one FMA per row for y and a multiply and an FMA per row
// for S.  Four partial sums break y's FMA chain.  Rows and columns past n
// are zeros with w = 1, which leaves them 0.  Deterministic: no atomics,
// fixed summation order.  The chunked tensor-core form, with an exponent
// split that stays finite, is later work.
//
// Bound on the card: the bytes, r, k, v, logw read once and y written once
// (20 B T H n), u (4 H n) and s0, s_T (8 B H n n), over 3.35 TB/s; at
// RWKV6-3B's prefill (B = 4, T = 1024, H = 40, n = 64) 215 MB, 64 us.  The
// operations, 5 n^2 per token and head (r.S; w * S + k v), plus O(n) for the
// bonus term and the exp, are 3.4 GFLOP, 51 us at 67 TFLOP/s.
//
// Shared memory: TC * (NMAX + 1) float4 + TC * NMAX + TC + NMAX floats:
// 41.9 KB at n = 64.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int TC = 32;     // tokens per staged chunk

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* logw;
  const float* u;
  const float* s0;
  float* y;
  float* s_fin;
  int T, H, n;
  long long r_sb, r_st, r_sh, r_si, k_sb, k_st, k_sh, k_si;
  long long v_sb, v_st, v_sh, v_si, w_sb, w_st, w_sh, w_si;
  long long u_sb, u_sh, u_si;
};

template <int NMAX>
__global__ void __launch_bounds__(NMAX) wkv6_kernel(const Args p) {
  __shared__ float4 rkw[TC][NMAX + 1];   // (r, k, exp(logw), 0) per (token, row)
  __shared__ float vs[TC][NMAX];
  __shared__ float ruk[TC];              // sum_i r[i] u[i] k[i] per token
  __shared__ float us[NMAX];

  const int j = threadIdx.x;
  const int n = p.n;
  const long long bh = blockIdx.x;
  const long long b = bh / p.H, hh = bh % p.H;
  const bool j_ok = j < n;

  us[j] = j_ok ? p.u[b * p.u_sb + hh * p.u_sh + j * p.u_si] : 0.f;
  float S[NMAX];
  const long long s_base = bh * n * n;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    S[i] = (i < n && j_ok) ? p.s0[s_base + static_cast<long long>(i) * n + j] : 0.f;
  }
  const long long r0 = b * p.r_sb + hh * p.r_sh, k0 = b * p.k_sb + hh * p.k_sh;
  const long long v0 = b * p.v_sb + hh * p.v_sh, w0 = b * p.w_sb + hh * p.w_sh;

  for (int t0 = 0; t0 < p.T; t0 += TC) {
    const int nt = min(TC, p.T - t0);
    __syncthreads();                     // the previous chunk is consumed
#pragma unroll 4
    for (int idx = j; idx < TC * NMAX; idx += NMAX) {
      const int tt = idx / NMAX, i = idx % NMAX;
      const long long t = t0 + tt;
      const bool ok = tt < nt && i < n;
      const float rv = ok ? p.r[r0 + t * p.r_st + i * p.r_si] : 0.f;
      const float kv = ok ? p.k[k0 + t * p.k_st + i * p.k_si] : 0.f;
      const float lw = ok ? p.logw[w0 + t * p.w_st + i * p.w_si] : 0.f;
      vs[tt][i] = ok ? p.v[v0 + t * p.v_st + i * p.v_si] : 0.f;
      rkw[tt][i] = make_float4(rv, kv, expf(lw), 0.f);
    }
    __syncthreads();
    for (int tt = j; tt < TC; tt += NMAX) {
      float acc = 0.f;
      for (int i = 0; i < n; ++i) {
        const float4 q = rkw[tt][i];
        acc += q.x * us[i] * q.y;
      }
      ruk[tt] = acc;
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float vj = vs[tt][j];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int i = 0; i < NMAX; i += 4) {
        const float4 q0 = rkw[tt][i], q1 = rkw[tt][i + 1];
        const float4 q2 = rkw[tt][i + 2], q3 = rkw[tt][i + 3];
        y0 = fmaf(q0.x, S[i], y0);
        y1 = fmaf(q1.x, S[i + 1], y1);
        y2 = fmaf(q2.x, S[i + 2], y2);
        y3 = fmaf(q3.x, S[i + 3], y3);
        S[i] = fmaf(q0.z, S[i], q0.y * vj);
        S[i + 1] = fmaf(q1.z, S[i + 1], q1.y * vj);
        S[i + 2] = fmaf(q2.z, S[i + 2], q2.y * vj);
        S[i + 3] = fmaf(q3.z, S[i + 3], q3.y * vj);
      }
      if (j_ok) {
        p.y[((b * p.T + t0 + tt) * p.H + hh) * n + j] =
            fmaf(ruk[tt], vj, (y0 + y1) + (y2 + y3));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    if (i < n && j_ok) p.s_fin[s_base + static_cast<long long>(i) * n + j] = S[i];
  }
}

template <int NMAX>
void launch(const Args& p, int bh, cudaStream_t stream) {
  wkv6_kernel<NMAX><<<bh, NMAX, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// r, k, v, logw: (B, T, H, n) fp32 with element strides (batch, time, head,
// entry); u: (B, H, n) with strides (batch, head, entry); s0 (B, H, n, n)
// contiguous.  Writes y (B, T, H, n) and s_fin (B, H, n, n), contiguous
// fp32.  Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (0 on success).
int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                const void* u, const void* s0, void* y, void* s_fin, int batch,
                int T, int H, int n, long long r_sb, long long r_st,
                long long r_sh, long long r_si, long long k_sb, long long k_st,
                long long k_sh, long long k_si, long long v_sb, long long v_st,
                long long v_sh, long long v_si, long long w_sb, long long w_st,
                long long w_sh, long long w_si, long long u_sb, long long u_sh,
                long long u_si, void* stream) {
  if (batch < 1 || T < 1 || H < 1 || n < 1 || n > 64 ||
      static_cast<long long>(batch) * H > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{static_cast<const float*>(r),    static_cast<const float*>(k),
         static_cast<const float*>(v),    static_cast<const float*>(logw),
         static_cast<const float*>(u),    static_cast<const float*>(s0),
         static_cast<float*>(y),          static_cast<float*>(s_fin),
         T, H, n,
         r_sb, r_st, r_sh, r_si, k_sb, k_st, k_sh, k_si,
         v_sb, v_st, v_sh, v_si, w_sb, w_st, w_sh, w_si,
         u_sb, u_sh, u_si};
  const int bh = batch * H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 16) {
    launch<16>(p, bh, s);
  } else if (n <= 32) {
    launch<32>(p, bh, s);
  } else {
    launch<64>(p, bh, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
