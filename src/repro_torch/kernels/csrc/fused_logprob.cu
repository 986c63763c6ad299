// Fused token log-prob forward (K1) and backward (K2) for Hopper (sm_90a),
// bound to Python through a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py).
//
// K1 logprob_fwd_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/fused_logprob.py::_fwd_kernel (pallas_call in
//   _pallas_fwd, line 98).
// K2 logprob_bwd_kernel replaces
//   src/repro/kernels/fused_logprob.py::_bwd_kernel (pallas_call in
//   _pallas_bwd, line 142).
//
// What they compute (the same as their TPU kernels and as the twin
// chunked_logprob in fused_logprob.py), for logits x (T, V) read as float32
// and targets (T,) int32 already clamped to [0, V) by the wrapper:
//   K1: lse = m + log(max(l, 1e-30)) with m = max x, l = sum exp(x - m);
//       logp = x[tgt] - lse;  ent = lse - sum(exp(x - m) x) / l;
//       all three (T,) float32.
//   K2: dlogits = g_lp (onehot(tgt) - p) - g_ent p (x - mu), p = exp(x - lse),
//       mu = lse - ent, computed in float32 and rounded once to the logits
//       dtype.
//
// Design (simple first):
// - K1: one block of 256 threads per token row, threads striding over the
//   vocabulary. Each thread keeps the online triple (m, l, s1 = sum p x)
//   with the rescale alpha = exp(m_old - m_new) of _fwd_kernel; the triples
//   merge by warp shuffles, then across the 8 warps through shared memory.
//   Lane 0 of warp 0 reads x[tgt] once and writes the row's outputs.
// - K2: the same row-per-block walk, elementwise: every (row, column) is
//   independent, the row's lse, mu, g_lp, g_ent and target are read once.
// - Loads (and K2's stores) are 16 bytes wide when the row starts on a
//   16-byte boundary: 4 float32 or 8 bfloat16 values. A row that does not
//   (V not a multiple of 4 / 8) takes the scalar loop, as does every row's
//   ragged tail. All offsets into (T, V) are size_t: T * V passes 2^31 at
//   the learner's shapes.
//
// Bound on the H100 (3.35 TB/s; float32 math on the CUDA cores, 67 TFLOP/s):
// both kernels do a handful of float32 operations per element, so they are
// bound by bytes. K1 must read the logits once (4.98 GB at T 8184,
// V 152064, float32: 1.49 ms); K2 must read them and write dlogits
// (2 x 4.98 GB: 2.97 ms). The per-row vectors are O(T).
// What the simple design leaves on the table: one block per row with one
// 16-byte load in flight per thread per iteration relies on many resident
// blocks to hide latency (no cp.async/TMA pipeline); K1 spends two exp per
// 16-byte vector (one for the rescale); K2 recomputes exp(x - lse) instead
// of reading a saved p (which would cost another T x V of bytes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Triple {
  float m;   // running max
  float l;   // sum exp(x - m)
  float s;   // sum exp(x - m) * x
};

__device__ __forceinline__ void merge(Triple& a, const Triple& b) {
  const float m = fmaxf(a.m, b.m);
  const float ea = expf(a.m - m), eb = expf(b.m - m);
  a.l = a.l * ea + b.l * eb;
  a.s = a.s * ea + b.s * eb;
  a.m = m;
}

// absorb N values into the triple with one rescale (one tile of _fwd_kernel)
template <int N>
__device__ __forceinline__ void absorb(Triple& t, const float (&x)[N]) {
  float mx = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) mx = fmaxf(mx, x[i]);
  const float m = fmaxf(t.m, mx);
  const float alpha = expf(t.m - m);
  float l = 0.f, s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float p = expf(x[i] - m);
    l += p;
    s += p * x[i];
  }
  t.l = t.l * alpha + l;
  t.s = t.s * alpha + s;
  t.m = m;
}

template <typename T> struct Elt;
template <> struct Elt<float> {
  static constexpr int N = 4;     // values per 16 bytes
  __device__ static float get(float v) { return v; }
  __device__ static float put(float v) { return v; }
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store(float* p, const float (&x)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct Elt<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 put(float v) { return __float2bfloat16(v); }
  __device__ static void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&x)[8]) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
logprob_fwd_kernel(const T* __restrict__ logits, const int* __restrict__ tgt,
                   float* __restrict__ logp, float* __restrict__ ent,
                   float* __restrict__ lse_out, int V) {
  constexpr int N = Elt<T>::N;
  const size_t row = blockIdx.x;
  const T* x = logits + row * static_cast<size_t>(V);
  Triple t{kNegInf, 0.f, 0.f};
  int vec_end = 0;
  if (aligned16(x)) {
    vec_end = (V / N) * N;
#pragma unroll 4
    for (int c = threadIdx.x * N; c < vec_end; c += kThreads * N) {
      float v[N];
      Elt<T>::load(x + c, v);
      absorb<N>(t, v);
    }
  }
  for (int c = vec_end + threadIdx.x; c < V; c += kThreads) {
    const float v[1] = {Elt<T>::get(x[c])};
    absorb<1>(t, v);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Triple o{__shfl_xor_sync(kFull, t.m, off),
                   __shfl_xor_sync(kFull, t.l, off),
                   __shfl_xor_sync(kFull, t.s, off)};
    merge(t, o);
  }
  __shared__ Triple part[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (warp != 0) return;
  t = lane < kWarps ? part[lane] : Triple{kNegInf, 0.f, 0.f};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Triple o{__shfl_xor_sync(kFull, t.m, off),
                   __shfl_xor_sync(kFull, t.l, off),
                   __shfl_xor_sync(kFull, t.s, off)};
    merge(t, o);
  }
  if (lane == 0) {
    const float l = fmaxf(t.l, 1e-30f);
    const float lse = t.m + logf(l);
    logp[row] = Elt<T>::get(x[tgt[row]]) - lse;
    ent[row] = lse - t.s / l;          // H = lse - E_p[x]
    lse_out[row] = lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
logprob_bwd_kernel(const T* __restrict__ logits, const int* __restrict__ tgt,
                   const float* __restrict__ lse, const float* __restrict__ mu,
                   const float* __restrict__ g_lp,
                   const float* __restrict__ g_ent, T* __restrict__ dlogits,
                   int V) {
  constexpr int N = Elt<T>::N;
  const size_t row = blockIdx.x;
  const T* x = logits + row * static_cast<size_t>(V);
  T* d = dlogits + row * static_cast<size_t>(V);
  const float L = lse[row], M = mu[row], GL = g_lp[row], GE = g_ent[row];
  const int hit_col = tgt[row];
  int vec_end = 0;
  if (aligned16(x) && aligned16(d)) {
    vec_end = (V / N) * N;
#pragma unroll 4
    for (int c = threadIdx.x * N; c < vec_end; c += kThreads * N) {
      float v[N];
      Elt<T>::load(x + c, v);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float p = expf(v[i] - L);
        const float hit = (c + i == hit_col) ? 1.f : 0.f;
        v[i] = GL * (hit - p) - GE * p * (v[i] - M);
      }
      Elt<T>::store(d + c, v);
    }
  }
  for (int c = vec_end + threadIdx.x; c < V; c += kThreads) {
    const float xv = Elt<T>::get(x[c]);
    const float p = expf(xv - L);
    const float hit = (c == hit_col) ? 1.f : 0.f;
    d[c] = Elt<T>::put(GL * (hit - p) - GE * p * (xv - M));
  }
}

template <typename T>
int launch_fwd(const void* logits, const void* tgt, void* logp, void* ent,
               void* lse, int T_, int V, cudaStream_t stream) {
  if (T_ == 0) return int(cudaGetLastError());
  logprob_fwd_kernel<T><<<T_, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(tgt),
      static_cast<float*>(logp), static_cast<float*>(ent),
      static_cast<float*>(lse), V);
  return int(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* logits, const void* tgt, const void* lse,
               const void* mu, const void* g_lp, const void* g_ent,
               void* dlogits, int T_, int V, cudaStream_t stream) {
  if (T_ == 0) return int(cudaGetLastError());
  logprob_bwd_kernel<T><<<T_, kThreads, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<const int*>(tgt),
      static_cast<const float*>(lse), static_cast<const float*>(mu),
      static_cast<const float*>(g_lp), static_cast<const float*>(g_ent),
      static_cast<T*>(dlogits), V);
  return int(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 logits, 1 = bfloat16 logits. targets int32 in [0, V).
// Outputs logp, ent, lse: (T,) float32. Returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for an unknown dtype).
extern "C" int logprob_fwd_launch(const void* logits, const void* targets,
                                  void* logp, void* ent, void* lse, int T,
                                  int V, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fwd<float>(logits, targets, logp, ent, lse, T, V, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(logits, targets, logp, ent, lse, T, V, s);
  return int(cudaErrorInvalidValue);
}

// lse, mu, g_lp, g_ent: (T,) float32; dlogits (T, V) in the logits dtype.
extern "C" int logprob_bwd_launch(const void* logits, const void* targets,
                                  const void* lse, const void* mu,
                                  const void* g_lp, const void* g_ent,
                                  void* dlogits, int T, int V, int dtype,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(logits, targets, lse, mu, g_lp, g_ent, dlogits, T, V, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(logits, targets, lse, mu, g_lp, g_ent,
                                     dlogits, T, V, s);
  return int(cudaErrorInvalidValue);
}
