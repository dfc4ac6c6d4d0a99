// One-pass SGD update of a stacked parameter leaf, written for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX reference's client step
// (src/repro/fl/client.py:157-159) is
//   p <- (p.astype(f32) - lr * g.astype(f32)).astype(p.dtype)
// inside the body of a lax.scan, where XLA fuses it into one pass over p
// and g.  The port's vmapped executor ran it as five PyTorch elementwise
// passes in fp32 (two casts up, the product, the difference, the cast
// down), and stepped every leaf past 2^26 elements client by client into
// its output, one more copy: 42 bytes moved an element of bf16.  This
// kernel is that fused pass.
//
// Contract (the plain version, kernels/sgd_update/ref.py, is held to it bit
// for bit on the card by chip_smoke.py).  For a leaf of K clients of n
// elements each, of type T (fp32, bf16 or fp16):
//   out[j][i] = T_rn(fsub_rn(float(a[j][i]), fmul_rn(lr, float(g[j][i]))))
// with lr the fp32 value PyTorch multiplies by (float(lr) of the Python
// float), the product and the difference rounded apart (__fmul_rn and
// __fsub_rn: no FMA contraction) and the result rounded to nearest even.
// a and g are read through a client stride each, in elements (a's is 0 when
// the clients start from one broadcast leaf); each client's block of n
// elements is contiguous.  out is (K, n) contiguous and aliases neither
// input: a may be the caller's initial params.
//
// Bound on the card: the bytes, a read once, g read once and out written
// once, over 3.35 TB/s; 6 B an element of bf16 in a stacked leaf (2 + 4 K
// B an element of the broadcast leaf).  Two fp32 operations an element are
// nothing against that.
//
// Design.  A memory-bound stream: every thread moves 16-byte vectors (8
// bf16, 4 fp32), UNROLL vectors of a and of g in flight before the first
// store, over a grid of as many CTAs as the SMs hold resident (132 SMs
// times the occupancy the runtime reports) walking the leaf in a
// grid-stride loop.  g is read exactly once, so its loads are streaming
// (ld.global.cs: evict first) and leave L2 to a.  Two variants, chosen by
// what the input shows, not by a setting:
//   * stacked a (its own client axis): a plain stream of a, g and out.
//     When both client strides equal n the leaf is one flat stream; else
//     blockIdx.y walks the clients.
//   * broadcast a (client stride 0, the first step of a bucket whose
//     clients start from the global params): a thread loads its vector of a
//     once and walks the K clients' g and out, UNROLL clients in flight:
//     (2 + 4 K) B an element of bf16 instead of 6 K.
// A scalar loop in the same kernel takes each client's ragged end (n not a
// multiple of the vector) and, where a pointer or a client stride is not
// 16-byte aligned, the whole leaf.  Deterministic: no atomics, no sums.
// ptxas gives the bf16 variants 50 (stacked) and 62 (broadcast) registers,
// 4 resident CTAs of 256 threads a SM, no local memory; on an H100 80GB
// HBM3 at 700 W they move 2.89 and 2.79 TB/s at Yi-6B's embedding over 10
// clients (86% and 83% of 3.35).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;      // 16-byte vectors (or clients) in flight a thread

template <typename T>
struct Conv;
template <>
struct Conv<float> {
  __device__ static float up(float x) { return x; }
  __device__ static float down(float x) { return x; }
};
template <>
struct Conv<__nv_bfloat16> {
  __device__ static float up(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 down(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Conv<__half> {
  __device__ static float up(__half x) { return __half2float(x); }
  __device__ static __half down(float x) { return __float2half_rn(x); }
};

template <typename T>
__device__ __forceinline__ T sgd(T a, T g, float lr) {
  return Conv<T>::down(__fsub_rn(Conv<T>::up(a), __fmul_rn(lr, Conv<T>::up(g))));
}

// 16 bytes of elements: out = sgd(a, g) element by element
template <typename T>
__device__ __forceinline__ uint4 sgd_vec(uint4 a, uint4 g, float lr) {
  constexpr int N = 16 / sizeof(T);
  const T* ae = reinterpret_cast<const T*>(&a);
  const T* ge = reinterpret_cast<const T*>(&g);
  uint4 o;
  T* oe = reinterpret_cast<T*>(&o);
#pragma unroll
  for (int i = 0; i < N; ++i) oe[i] = sgd(ae[i], ge[i], lr);
  return o;
}

// Stacked a.  Client j = blockIdx.y, blockIdx.y + gridDim.y, ...; its
// first nvec vectors by 16-byte accesses, elements nvec * N .. n - 1 one by
// one (all of them when nvec = 0).
template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_stacked(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ out,
            long long K, long long n, long long nvec, long long sa, long long sg,
            float lr) {
  constexpr int N = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  for (long long j = blockIdx.y; j < K; j += gridDim.y) {
    const T* aj = a + j * sa;
    const T* gj = g + j * sg;
    T* oj = out + j * n;
    const uint4* av = reinterpret_cast<const uint4*>(aj);
    const uint4* gv = reinterpret_cast<const uint4*>(gj);
    uint4* ov = reinterpret_cast<uint4*>(oj);
    long long v = t0;
    for (; v + (UNROLL - 1) * stride < nvec; v += UNROLL * stride) {
      uint4 ra[UNROLL], rg[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        ra[u] = av[v + u * stride];
        rg[u] = __ldcs(gv + v + u * stride);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) ov[v + u * stride] = sgd_vec<T>(ra[u], rg[u], lr);
    }
    for (; v < nvec; v += stride) ov[v] = sgd_vec<T>(av[v], __ldcs(gv + v), lr);
    for (long long e = nvec * N + t0; e < n; e += stride)
      oj[e] = sgd(aj[e], __ldcs(gj + e), lr);
  }
}

// Broadcast a (client stride 0): each vector (element) of a is loaded once
// and stepped for every client, UNROLL clients' g in flight.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_broadcast(const T* __restrict__ a, const T* __restrict__ g, T* __restrict__ out,
              long long K, long long n, long long nvec, long long sg, float lr) {
  constexpr int N = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long t0 = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const uint4* av = reinterpret_cast<const uint4*>(a);
  for (long long v = t0; v < nvec; v += stride) {
    const uint4 ra = av[v];
    long long j = 0;
    for (; j + UNROLL <= K; j += UNROLL) {
      uint4 rg[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        rg[u] = __ldcs(reinterpret_cast<const uint4*>(g + (j + u) * sg) + v);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        reinterpret_cast<uint4*>(out + (j + u) * n)[v] = sgd_vec<T>(ra, rg[u], lr);
    }
    for (; j < K; ++j)
      reinterpret_cast<uint4*>(out + j * n)[v] =
          sgd_vec<T>(ra, __ldcs(reinterpret_cast<const uint4*>(g + j * sg) + v), lr);
  }
  for (long long e = nvec * N + t0; e < n; e += stride) {
    const T x = a[e];
    for (long long j = 0; j < K; ++j) out[j * n + e] = sgd(x, __ldcs(g + j * sg + e), lr);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 132;
  return sms;
}

// resident CTAs a SM for kernel fn, asked of the runtime once
template <typename F>
int resident_ctas(F fn) {
  static int ctas = 0;
  if (ctas == 0) {
    int got = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&got, fn, THREADS, 0) != cudaSuccess ||
        got < 1)
      got = 1;
    ctas = got;
  }
  return ctas;
}

long long ceil_div(long long x, long long y) { return (x + y - 1) / y; }

template <typename T>
int launch(const T* a, const T* g, T* out, long long K, long long n, long long sa,
           long long sg, float lr, cudaStream_t stream) {
  constexpr int N = 16 / sizeof(T);
  const bool broadcast = sa == 0 && K > 1;
  if (!broadcast && sa == n && sg == n) {   // one flat stream
    n *= K;
    K = 1;
  }
  const auto addr16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const long long es = sizeof(T);
  const bool aligned = addr16(a) && addr16(g) && addr16(out) &&
                       (K == 1 || ((sa * es) % 16 == 0 && (sg * es) % 16 == 0 &&
                                   (n * es) % 16 == 0));
  const long long nvec = aligned ? n / N : 0;
  // threads a client's block needs: a vector (UNROLL of them when stacked)
  // or a tail element each
  const long long per_client = nvec > 0 ? nvec : n;
  if (broadcast) {
    const long long full = static_cast<long long>(sm_count()) * resident_ctas(sgd_broadcast<T>);
    const long long want = ceil_div(per_client, THREADS);
    const unsigned gx = static_cast<unsigned>(want < full ? want : full);
    sgd_broadcast<T><<<gx, THREADS, 0, stream>>>(a, g, out, K, n, nvec, sg, lr);
  } else {
    const long long full = static_cast<long long>(sm_count()) * resident_ctas(sgd_stacked<T>);
    const long long gy = K < 65535 ? K : 65535;
    const long long share = full / gy > 0 ? full / gy : 1;
    const long long want = ceil_div(per_client, static_cast<long long>(THREADS) *
                                                    (nvec > 0 ? UNROLL : 1));
    const unsigned gx = static_cast<unsigned>(want < share ? want : share);
    sgd_stacked<T><<<dim3(gx, static_cast<unsigned>(gy)), THREADS, 0, stream>>>(
        a, g, out, K, n, nvec, sa, sg, lr);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int config(int broadcast, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = broadcast ? cudaFuncGetAttributes(&attr, sgd_broadcast<T>)
                                    : cudaFuncGetAttributes(&attr, sgd_stacked<T>);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = THREADS;
  out[1] = broadcast ? resident_ctas(sgd_broadcast<T>) : resident_ctas(sgd_stacked<T>);
  out[2] = sm_count();
  out[3] = attr.numRegs;
  out[4] = static_cast<int>(attr.localSizeBytes);
  out[5] = 16 / sizeof(T);
  out[6] = UNROLL;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 fp32, 1 bf16, 2 fp16.  a, g: K clients of n elements, client
// strides sa, sg in elements (sa = 0: a broadcast), each client's block
// contiguous; out (K, n) contiguous.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (0 on success).
int sgd_update_launch(const void* a, const void* g, void* out, int dtype, long long K,
                      long long n, long long sa, long long sg, float lr, void* stream) {
  if (K < 1 || n < 1 || sa < 0 || sg < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch(static_cast<const float*>(a), static_cast<const float*>(g),
                    static_cast<float*>(out), K, n, sa, sg, lr, s);
    case 1:
      return launch(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(g),
                    static_cast<__nv_bfloat16*>(out), K, n, sa, sg, lr, s);
    case 2:
      return launch(static_cast<const __half*>(a), static_cast<const __half*>(g),
                    static_cast<__half*>(out), K, n, sa, sg, lr, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The launch configuration of a variant (broadcast 1, stacked 0) for dtype:
// threads a CTA, resident CTAs a SM, SMs, registers a thread, local bytes
// a thread, elements a vector, vectors in flight.
int sgd_update_config(int dtype, int broadcast, int* out) {
  switch (dtype) {
    case 0: return config<float>(broadcast, out);
    case 1: return config<__nv_bfloat16>(broadcast, out);
    case 2: return config<__half>(broadcast, out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
