// Mamba-1 selective scan (forward), written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/mamba/kernel.py:68,
// selective_scan_pallas (body _kernel): for every sequence b and channel c,
//   h_t = exp(dt_t A_c) * h_{t-1} + (dt_t x_t) B_t      (state entries s)
//   y_t = sum_s h_t[s] C_t[s]
// with the state carried in from h0 and out as h_T, all in fp32.
//
// Contract (the plain version, kernels/mamba/ref.py, is held to it on the
// card by chip_smoke.py).  x, dt (B, T, inner) and Bm, Cm (B, T, state)
// fp32, read through their element strides: Hymba's B and C are column
// slices of x_proj's output, rows 2 * state + dt_rank floats apart, and are
// not copied.  A (inner, state) and h0 (B, inner, state) contiguous; y (B,
// T, inner) and h_T (B, inner, state) contiguous.  Any T >= 1 (the Pallas
// wrapper needs T to be a multiple of its chunk), any inner, state <= 64.
// exp is the accurate expf (no fast-math flag): the smoke's tolerance,
// 2e-5 of the row's scale, assumes it.
//
// Design.  The TPU kernel keeps an (inner block, state) slice of h in VMEM
// and walks chunks of T on a sequential grid axis.  Here the walk over T is
// a loop inside the CTA and h lives in registers.  Mamba-1's decay is per
// (channel, state entry), so the recurrence does not factor into matrix
// products; the work is elementwise and every (b, c, s) chain is
// independent.  One CTA takes CH = 32 channels of one sequence.  A channel's
// state entries are split over LANES adjacent lanes, NPT = 4 entries each
// (lane l holds entries l, l + LANES, ...), and y_t is their butterfly
// shuffle sum.  Why split: one thread per channel gives B * inner / 128
// CTAs of 128 threads, 50 at Hymba's B = 4, inner = 1600, on 132 SMs, each
// thread walking 16 exp chains in series; with 4 lanes per channel the same
// work is 200 CTAs and four times the warps to hide the exp and shuffle
// latency, for two shuffles per token.  Each TC = 32-token chunk of x and dt
// (coalesced along channels) and of B and C (read once per CTA, shared by
// all its channels) is staged in shared memory; each chunk of y is
// gathered there and leaves in coalesced rows.  Deterministic: no atomics,
// fixed summation order.
//
// Bound on the card: the bytes, x and dt read once (8 B T inner), B and C
// (8 B T state), A, h0 and h_T (4 inner state + 8 B inner state) and y
// written once (4 B T inner), over 3.35 TB/s.  At Hymba's prefill (B = 4,
// T = 2048, inner = 1600, state = 16) that is 159 MB, 47.6 us.  The
// operations, 7 per (b, t, c, s) with the exp counted as one, plus one per
// (b, t, c), are 1.47 GFLOP, 22 us at the fp32 rate of 67 TFLOP/s.
//
// Shared memory: 3 * TC * CH + 2 * TC * LANES * NPT floats, 12.3 KB + 4 KB
// at state <= 16, 28.7 KB at state <= 64.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CH = 32;     // channels per CTA
constexpr int TC = 32;     // tokens per staged chunk
constexpr int NPT = 4;     // state entries per lane

struct Args {
  const float* x;
  const float* dt;
  const float* bm;
  const float* cm;
  const float* a;
  const float* h0;
  float* y;
  float* h_fin;
  int T, inner, state;
  long long x_sb, x_st, x_sc, dt_sb, dt_st, dt_sc;
  long long b_sb, b_st, b_ss, c_sb, c_st, c_ss;
};

template <int LANES>
__global__ void __launch_bounds__(CH * LANES)
selective_scan_kernel(const Args p) {
  constexpr int THREADS = CH * LANES;
  constexpr int SMAX = LANES * NPT;
  __shared__ float xs[TC][CH];
  __shared__ float dts[TC][CH];
  __shared__ float ys[TC][CH];
  __shared__ float bs[TC][SMAX];
  __shared__ float cs[TC][SMAX];

  const int tid = threadIdx.x;
  const int cl = tid / LANES;             // this lane's channel in the CTA
  const int lane = tid % LANES;
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const long long b = blockIdx.y;
  const bool c_ok = c < p.inner;

  float av[NPT], h[NPT];
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int s = lane + LANES * e;
    const bool ok = c_ok && s < p.state;
    av[e] = ok ? p.a[static_cast<long long>(c) * p.state + s] : 0.f;
    h[e] = ok ? p.h0[(b * p.inner + c) * p.state + s] : 0.f;
  }

  for (int t0 = 0; t0 < p.T; t0 += TC) {
    const int nt = min(TC, p.T - t0);
    // stage the chunk (rows past T and channels past inner read as 0)
    for (int idx = tid; idx < TC * CH; idx += THREADS) {
      const int i = idx / CH, j = idx % CH;
      const long long t = t0 + i, cc = c0 + j;
      const bool ok = i < nt && cc < p.inner;
      xs[i][j] = ok ? p.x[b * p.x_sb + t * p.x_st + cc * p.x_sc] : 0.f;
      dts[i][j] = ok ? p.dt[b * p.dt_sb + t * p.dt_st + cc * p.dt_sc] : 0.f;
    }
    for (int idx = tid; idx < TC * SMAX; idx += THREADS) {
      const int i = idx / SMAX, s = idx % SMAX;
      const long long t = t0 + i;
      const bool ok = i < nt && s < p.state;
      bs[i][s] = ok ? p.bm[b * p.b_sb + t * p.b_st + s * p.b_ss] : 0.f;
      cs[i][s] = ok ? p.cm[b * p.c_sb + t * p.c_st + s * p.c_ss] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < nt; ++i) {
      const float dv = dts[i][cl];
      const float dtx = dv * xs[i][cl];
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < NPT; ++e) {
        const int s = lane + LANES * e;
        const float da = expf(dv * av[e]);
        h[e] = da * h[e] + dtx * bs[i][s];
        part += h[e] * cs[i][s];
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      if (lane == 0) ys[i][cl] = part;
    }
    __syncthreads();
    for (int idx = tid; idx < TC * CH; idx += THREADS) {
      const int i = idx / CH, j = idx % CH;
      const long long cc = c0 + j;
      if (i < nt && cc < p.inner) {
        p.y[(b * p.T + t0 + i) * p.inner + cc] = ys[i][j];
      }
    }
    // the next chunk's staging writes only xs, dts, bs, cs, which every
    // thread finished reading before the barrier above
  }

#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int s = lane + LANES * e;
    if (c_ok && s < p.state) p.h_fin[(b * p.inner + c) * p.state + s] = h[e];
  }
}

template <int LANES>
void launch(const Args& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.inner + CH - 1) / CH, batch);
  selective_scan_kernel<LANES><<<grid, CH * LANES, 0, stream>>>(p);
}

}  // namespace

extern "C" {

// x, dt: (B, T, inner); bm, cm: (B, T, state), all fp32, with element
// strides (batch, time, channel or entry); a (inner, state), h0 (B, inner,
// state) contiguous fp32.  Writes y (B, T, inner) and h_fin (B, inner,
// state), contiguous fp32.  Launches on `stream`, does not synchronise,
// returns cudaGetLastError() (0 on success).
int selective_scan_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* a, const void* h0,
                          void* y, void* h_fin, int batch, int T, int inner,
                          int state, long long x_sb, long long x_st,
                          long long x_sc, long long dt_sb, long long dt_st,
                          long long dt_sc, long long b_sb, long long b_st,
                          long long b_ss, long long c_sb, long long c_st,
                          long long c_ss, void* stream) {
  if (batch < 1 || batch > 65535 || T < 1 || inner < 1 || state < 1 ||
      state > 16 * NPT) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{static_cast<const float*>(x),  static_cast<const float*>(dt),
         static_cast<const float*>(bm), static_cast<const float*>(cm),
         static_cast<const float*>(a),  static_cast<const float*>(h0),
         static_cast<float*>(y),        static_cast<float*>(h_fin),
         T, inner, state,
         x_sb, x_st, x_sc, dt_sb, dt_st, dt_sc,
         b_sb, b_st, b_ss, c_sb, c_st, c_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (state <= NPT) {
    launch<1>(p, batch, s);
  } else if (state <= 2 * NPT) {
    launch<2>(p, batch, s);
  } else if (state <= 4 * NPT) {
    launch<4>(p, batch, s);
  } else if (state <= 8 * NPT) {
    launch<8>(p, batch, s);
  } else {
    launch<16>(p, batch, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
