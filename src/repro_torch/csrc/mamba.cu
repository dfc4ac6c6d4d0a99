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
// 2e-5 of the row's scale, assumes it.  Deterministic: no atomics, every sum
// in a fixed order.
//
// Design.  The TPU kernel keeps an (inner block, state) slice of h in VMEM
// and walks chunks of T on a sequential grid axis.  Here the walk over T is
// a loop inside the CTA and h lives in registers.  Mamba-1's decay is per
// (channel, state entry), so the recurrence does not factor into matrix
// products; every (b, c, s) chain is independent.  Each chain is one lane
// (two entries a lane past state 32): a channel's entries are LANES
// adjacent lanes, a CTA takes THREADS / LANES channels of one sequence.
// For 9 to 16 entries a lane takes several chains, which share its loads
// of x and dt and the reduction: at Hymba's prefill (B = 4, inner 1600,
// state 16) four chains a lane on 4 lanes, 16 channels a CTA of 2 warps
// (400 CTAs); where that grid has fewer CTAs than SMs (B = 1), two on 8
// lanes, 8 channels a CTA (200 CTAs).  A chunk of 16 tokens is worked in
// three steps: first, for all its tokens, da = expf(dt A) and dt x B,
// which are independent across tokens (instruction-level parallelism, and
// the special-function units kept busy); then the recurrence h = da h +
// dt x B, one FMA a token on the serial chain, and p_t = h C_t summed over
// the lane's chains; then y_t's sum over the lanes as a reduce-scatter
// (each level halves the tokens a lane keeps: 12 shuffles for 16 tokens
// over 4 lanes, where a butterfly per token takes 32), after which every
// lane writes y for its own tokens.  The chunks are staged with cp.async in a
// ring of three buffers (the next two chunks' x, dt, B and C in flight
// while one is worked), one barrier a chunk.  They are staged entry-major
// ([channel][token] for x and dt, [entry][token] for B and C), so that a
// lane reads four tokens of its values in one 16-byte shared load; that
// transposes in the copy, so every copy moves 4 bytes through the strides
// (B and C need no alignment).  A thread's copy slots are fixed, so their
// sources are set up once.  Tokens past T, channels past inner and entries
// past state are zero-filled (dt = 0 gives da = 1 and dt x B = 0: h stays
// as it is).
//
// Bound on the card: the bytes, x and dt read once (8 B T inner), B and C
// (8 B T state), A, h0 and h_T (4 inner state + 8 B inner state) and y
// written once (4 B T inner), over 3.35 TB/s: at Hymba's prefill (B = 4,
// T = 2048, inner = 1600, state = 16) 159 MB, 47.5 us.  The exps, one per
// (b, t, c, s), 209.7 M, at the special-function units' 16 a clock and SM
// (4.18e12 a second at 1.98 GHz): 50.2 us, the larger.  The other
// operations, 7 per (b, t, c, s) plus one per (b, t, c), are 1.47 GFLOP,
// 22 us at 67 TFLOP/s.  What holds the kernel back after this design: the
// accurate expf (a range reduction around one ex2.approx) is most of the
// instructions a (b, t, c, s) issues.
//
// Shared memory: 3 buffers x (2 x CH + 2 x LANES x NPT) rows of 20 floats:
// 15.4 KB for 4 lanes x 4 entries and 16 channels.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TC = 16;           // tokens per staged chunk
constexpr int TP = TC + 4;       // a staged row, padded: 16-byte loads conflict-free
constexpr int STAGES = 3;        // chunks in the ring: two in flight while one is worked

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 4 bytes; src_bytes = 0 zero-fills the destination without
// reading the source.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Reduce-scatter of pt[0 .. CNT) over the lanes l ^ OFF, l ^ OFF / 2, ...,
// 1 of a channel: at each level the lane with bit OFF set keeps the upper
// half of its tokens and adds its partner's, the other the lower half; once
// a lane keeps one token, the remaining levels are a butterfly.  `base`
// gathers the first token the lane keeps.
template <int OFF, int CNT>
__device__ __forceinline__ void reduce_scatter(float (&pt)[TC], int sl, int& base) {
  if constexpr (OFF >= 1) {
    if constexpr (CNT > 1) {
      constexpr int HALF = CNT / 2;
      const bool up = sl & OFF;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const float send = up ? pt[j] : pt[j + HALF];
        const float keep = up ? pt[j + HALF] : pt[j];
        pt[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += HALF;
      reduce_scatter<OFF / 2, HALF>(pt, sl, base);
    } else {
      pt[0] += __shfl_xor_sync(0xffffffffu, pt[0], OFF);
      reduce_scatter<OFF / 2, 1>(pt, sl, base);
    }
  }
}

template <int LANES, int NPT, int THREADS>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const Args p) {
  constexpr int CH = THREADS / LANES;               // channels per CTA
  constexpr int SMAX = LANES * NPT;                 // state entries staged
  constexpr int KEEP = TC / LANES > 1 ? TC / LANES : 1;     // tokens a lane writes
  constexpr int DUP = LANES > TC ? LANES / TC : 1;  // lanes holding the same sums
  __shared__ __align__(16) float xs[STAGES][CH][TP];
  __shared__ __align__(16) float dts[STAGES][CH][TP];
  __shared__ __align__(16) float bs[STAGES][SMAX][TP];
  __shared__ __align__(16) float cs[STAGES][SMAX][TP];

  const int tid = threadIdx.x;
  const int cl = tid / LANES;             // this lane's channel in the CTA
  const int sl = tid % LANES;             // its state entry (and sl + LANES)
  const int c0 = blockIdx.x * CH;
  const int c = c0 + cl;
  const long long b = blockIdx.y;
  const bool c_ok = c < p.inner;

  float av[NPT], h[NPT];
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int s = sl + LANES * e;
    const bool ok = c_ok && s < p.state;
    av[e] = ok ? p.a[static_cast<long long>(c) * p.state + s] : 0.f;
    h[e] = ok ? p.h0[(b * p.inner + c) * p.state + s] : 0.f;
  }

  // A thread's copy slots are the same in every chunk: the x and dt
  // elements (token, channel) and the B and C elements (token, entry) at
  // idx = tid + k * THREADS.  Their sources are set up once and move TC rows
  // a chunk (stage is called for chunks 0, 1, 2, ... in order), so a copy
  // costs the copy, a compare and a pointer add.
  constexpr int XK = (TC * CH + THREADS - 1) / THREADS;
  constexpr int BK = (TC * SMAX + THREADS - 1) / THREADS;
  const float* xsrc[XK];
  const float* dsrc[XK];
  const float* bsrc[BK];
  const float* csrc[BK];
  constexpr int NEVER = 1 << 30;            // the token index of a slot never copied
  int xtt[XK], btt[BK];
#pragma unroll
  for (int k = 0; k < XK; ++k) {
    const int idx = tid + k * THREADS;
    const long long cc = c0 + idx % CH;
    const bool ok = idx < TC * CH && cc < p.inner;
    const long long tt = ok ? idx / CH : 0;
    xtt[k] = ok ? static_cast<int>(tt) : NEVER;
    xsrc[k] = p.x + b * p.x_sb + tt * p.x_st + (ok ? cc : 0) * p.x_sc;
    dsrc[k] = p.dt + b * p.dt_sb + tt * p.dt_st + (ok ? cc : 0) * p.dt_sc;
  }
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const int idx = tid + k * THREADS;
    const bool ok = idx < TC * SMAX && idx % SMAX < p.state;
    const long long tt = ok ? idx / SMAX : 0, s = ok ? idx % SMAX : 0;
    btt[k] = ok ? static_cast<int>(tt) : NEVER;
    bsrc[k] = p.bm + b * p.b_sb + tt * p.b_st + s * p.b_ss;
    csrc[k] = p.cm + b * p.c_sb + tt * p.c_st + s * p.c_ss;
  }
  const long long x_step = TC * p.x_st, dt_step = TC * p.dt_st;
  const long long b_step = TC * p.b_st, c_step = TC * p.c_st;
  const int T = p.T;

  auto stage = [&](int ch, int buf) {
    const int left = T - ch * TC;            // tokens from this chunk on
    if (left > 0) {
#pragma unroll
      for (int k = 0; k < XK; ++k) {
        const int idx = tid + k * THREADS;
        if (idx < TC * CH) {
          const int j = idx % CH;              // consecutive threads, channels
          const bool ok = xtt[k] < left;
          cp_async4(&xs[buf][j][idx / CH], ok ? xsrc[k] : p.x, ok);
          cp_async4(&dts[buf][j][idx / CH], ok ? dsrc[k] : p.dt, ok);
          xsrc[k] += x_step;
          dsrc[k] += dt_step;
        }
      }
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const int idx = tid + k * THREADS;
        if (idx < TC * SMAX) {
          const int s = idx % SMAX;
          const bool ok = btt[k] < left;
          cp_async4(&bs[buf][s][idx / SMAX], ok ? bsrc[k] : p.bm, ok);
          cp_async4(&cs[buf][s][idx / SMAX], ok ? csrc[k] : p.cm, ok);
          bsrc[k] += b_step;
          csrc[k] += c_step;
        }
      }
    }
    cp_async_commit();
  };

  // A ring of STAGES buffers; one group is committed per chunk (empty past
  // the last), so chunk ch has landed once at most STAGES - 2 groups are
  // in flight.
  const int chunks = (T + TC - 1) / TC;
#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) stage(c, c);
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch % STAGES;
    cp_async_wait_group<STAGES - 2>();
    __syncthreads();                 // chunk ch landed; chunk ch - 1 consumed
    stage(ch + STAGES - 1, (ch + STAGES - 1) % STAGES);

    float pt[TC];
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      const int s = sl + LANES * e;
      float da[TC], hv[TC];
      // off the chain: the decays and the inputs of every token of the chunk
#pragma unroll
      for (int q = 0; q < TC; q += 4) {
        const float4 d4 = *reinterpret_cast<const float4*>(&dts[buf][cl][q]);
        const float4 x4 = *reinterpret_cast<const float4*>(&xs[buf][cl][q]);
        const float4 b4 = *reinterpret_cast<const float4*>(&bs[buf][s][q]);
        const float dv[4] = {d4.x, d4.y, d4.z, d4.w};
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          da[q + i] = expf(dv[i] * av[e]);
          hv[q + i] = (dv[i] * xv[i]) * bv[i];
        }
      }
      // the serial chain: one FMA a token
#pragma unroll
      for (int tt = 0; tt < TC; ++tt) {
        h[e] = fmaf(da[tt], h[e], hv[tt]);
        hv[tt] = h[e];
      }
#pragma unroll
      for (int q = 0; q < TC; q += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(&cs[buf][s][q]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[q + i] = e == 0 ? hv[q + i] * cv[i] : fmaf(hv[q + i], cv[i], pt[q + i]);
        }
      }
    }
    int base = 0;
    reduce_scatter<LANES / 2, TC>(pt, sl, base);
    const int t0 = ch * TC;
    if (c_ok && sl % DUP == 0) {
#pragma unroll
      for (int j = 0; j < KEEP; ++j) {
        const int t = t0 + base + j;
        if (t < p.T) p.y[(b * p.T + t) * p.inner + c] = pt[j];
      }
    }
  }

#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int s = sl + LANES * e;
    if (c_ok && s < p.state) p.h_fin[(b * p.inner + c) * p.state + s] = h[e];
  }
}

using KernelFn = void (*)(const Args);

struct Config {
  KernelFn fn;
  int lanes, npt, threads;
};

template <int LANES, int NPT, int THREADS>
Config config() {
  return {selective_scan_kernel<LANES, NPT, THREADS>, LANES, NPT, THREADS};
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

// One lane per state entry (4 to 32 lanes a channel), two entries a lane
// past 32.  For 9 to 16 entries (Hymba's 16) a lane takes several: four
// on 4 lanes, 16 channels a CTA of 2 warps, while that grid has a CTA for
// every SM; else two on 8 lanes, 8 channels a CTA.  A lane's chains share
// its loads of x and dt, and the reduce-scatter's work a chain shrinks.
Config choose(int state, int batch, int inner) {
  if (state <= 4) return config<4, 1, 128>();
  if (state <= 8) return config<8, 1, 128>();
  if (state <= 16) {
    const long long ctas = static_cast<long long>(batch) * ((inner + 15) / 16);
    return ctas >= sm_count() ? config<4, 4, 64>() : config<8, 2, 64>();
  }
  if (state <= 32) return config<32, 1, 128>();
  return config<32, 2, 128>();
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
  if (batch < 1 || batch > 65535 || T < 1 || inner < 1 || state < 1 || state > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args p{static_cast<const float*>(x),  static_cast<const float*>(dt),
         static_cast<const float*>(bm), static_cast<const float*>(cm),
         static_cast<const float*>(a),  static_cast<const float*>(h0),
         static_cast<float*>(y),        static_cast<float*>(h_fin),
         T, inner, state,
         x_sb, x_st, x_sc, dt_sb, dt_st, dt_sc,
         b_sb, b_st, b_ss, c_sb, c_st, c_ss};
  const Config c = choose(state, batch, inner);
  const int ch = c.threads / c.lanes;
  const dim3 grid((inner + ch - 1) / ch, batch);
  c.fn<<<grid, c.threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launch configuration for `state` entries, `batch` sequences and
// `inner` channels, as out[0..5]: lanes per channel, entries per lane,
// threads per CTA, the resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the static shared memory
// per CTA in bytes and the registers per thread.  Returns a CUDA error code
// (0 on success).
int selective_scan_occupancy(int state, int batch, int inner, int* out) {
  if (state < 1 || state > 64 || batch < 1 || inner < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Config c = choose(state, batch, inner);
  int ctas = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &ctas, reinterpret_cast<const void*>(c.fn), c.threads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(c.fn));
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = c.lanes;
  out[1] = c.npt;
  out[2] = c.threads;
  out[3] = ctas;
  out[4] = static_cast<int>(attr.sharedSizeBytes);
  out[5] = attr.numRegs;
  return 0;
}

}  // extern "C"
