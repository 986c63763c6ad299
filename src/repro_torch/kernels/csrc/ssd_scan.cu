// Mamba2 SSD chunk scan (K6) for Hopper (sm_90a), bound to Python through a
// plain C interface loaded with ctypes (repro_torch/kernels/build.py).
//
// K6 ssd_scan_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::_kernel (pallas_call in ssd_scan,
//   line 87).
//
// What it computes (the same as its TPU kernel and as the twin
// ssd_scan_ref in ssd_scan.py): x (B, S, H, P), dt (B, S, H) float32,
// a (H,) float32 (negative), b, c (B, S, G, N); head h reads B/C group
// h / (H / G). Zero initial state, output y (B, S, H, P) only. For each
// (batch, head) the chunks of L rows are walked in order, carrying the
// float32 state (P, N). Within a chunk:
//   cum   = inclusive cumsum of a * dt (<= 0),  u = x * dt;
//   y     = [(C B^T) o exp(cum_t - cum_s)]_{t >= s} u + exp(cum) (C state^T);
//   state = state * exp(cum_L) + (u o exp(cum_L - cum))^T B.
// The exponent of the decay is positive above the diagonal, so the mask is
// applied before the exp (the TPU kernel's exp(where(mask, dec, 0))).
// Arithmetic is float32; y is written in x's dtype.
//
// Design (simple first):
// - the TPU grid is (B * H, n_chunks) with the state in VMEM scratch carried
//   along the sequential chunk axis. Here the chunk axis is a loop inside
//   one block of 256 threads; nothing is carried between blocks. A block
//   owns one (batch, head) and a slice of PB of the P state rows (the rows
//   are independent: y[:, p] reads only state[p, :]); the wrapper splits P
//   (PB = P / 2 or P / 4) when B * H blocks would not give every SM two,
//   and the C B^T scores are then recomputed per slice;
// - a chunk is cut into tiles of 64 rows. For each t tile: C_t is staged in
//   shared memory as float32, the carried state's term is added, then for
//   every s tile at or before it B_s and u_s (= x dt) are staged, the 64 x 64
//   masked, decayed scores are formed in registers and written to shared
//   memory, and y_t += W u_s. The last t tile walks every s tile of the
//   chunk, so it also accumulates the state update in registers;
// - cum is a warp scan of the chunk's a * dt (shuffles, 32 rows at a time);
//   exp(cum) and exp(cum_L - cum) are kept per row in shared memory;
// - thread (ty, tx) of a 16 x 16 grid owns score rows 4ty..4ty+3 and
//   columns tx + 16j, y rows 4ty..4ty+3 and state columns tx + 16k, and
//   state entries (ty + 16a, tx + 16b). Staged rows are padded to N + 4
//   floats, so the float4 reads of rows tx + 16j hit distinct banks.
//   Shared memory: 139 KB at PB 64, N 128, L 256 (set through
//   cudaFuncAttributeMaxDynamicSharedMemorySize); offsets are size_t.
//
// Bound on the H100 (3.35 TB/s; 989 TFLOP/s bf16 dense): x, dt, b, c read
// once and y written once, or 2 (L^2/2) N FLOPs per (batch, group, chunk)
// for the scores C B^T, which the heads of a group share, plus
// 2 (L^2/2 P + 2 L N P) per (batch, head, chunk): by bytes at both
// mamba2-1.3b shapes, ~0.084 ms at the recompute shape (B 16, S 1024,
// H 64, P 64, N 128, L 256; 281 MB), ~0.042 ms at B 1, S 8192 (140 MB).
// What the simple design leaves on the table: the products run on the
// CUDA cores in float32 instead of wgmma on bf16; no cp.async/TMA double
// buffering, so loads and math do not overlap; B tiles are restaged for
// every t tile; one block per SM at PB 64 (139 KB of shared memory).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kRows = 64;       // rows of a t or s tile
constexpr int kLDW = kRows + 4; // row stride of the score tile (floats)

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* dst, float x) {
    *dst = x;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* src,
                                              float* dst) {
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
  }
};

template <int PB, int N>
size_t smem_bytes(int L) {
  const size_t floats = 2 * size_t(kRows) * (N + 4)  // C_t, B_s
                        + size_t(PB) * (N + 4)       // state
                        + size_t(kRows) * PB         // u_s
                        + size_t(kRows) * kLDW       // scores
                        + 4 * size_t(L);             // dt, cum, exp(cum), w_end
  return floats * sizeof(float);
}

// Stage rows [0, n) of a (., COLS) slice into a (64, LD) float tile; row r
// is read at src + r * stride elements and multiplied by scale[r] when
// scale is given. Rows >= n are zeroed.
template <typename T, int COLS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int n,
                                      const float* scale) {
  constexpr int VN = Vec<T>::N;
  constexpr int CV = COLS / VN;
  for (int i = threadIdx.x; i < kRows * CV; i += kThreads) {
    const int r = i / CV, c = (i % CV) * VN;
    float t[VN];
    if (r < n) {
      Vec<T>::load(src + r * stride + c, t);
      if (scale != nullptr) {
        const float s = scale[r];
#pragma unroll
        for (int e = 0; e < VN; ++e) t[e] *= s;
      }
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + c + e) =
          make_float4(t[e], t[e + 1], t[e + 2], t[e + 3]);
  }
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <typename T, int PB, int N>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, int S, int H,
                int G, int P, int L, int nsplit) {
  constexpr int LDN = N + 4;
  constexpr int CP = PB / 16;   // y and state rows of p per thread
  constexpr int CN = N / 16;    // state columns of n per thread
  extern __shared__ float smem[];
  float* Cs = smem;                  // (64, LDN)
  float* Bs = Cs + kRows * LDN;      // (64, LDN)
  float* St = Bs + kRows * LDN;      // (PB, LDN), the carried state
  float* Us = St + PB * LDN;         // (64, PB)
  float* Ws = Us + kRows * PB;       // (64, kLDW)
  float* dts = Ws + kRows * kLDW;    // (L,)
  float* cum = dts + L;
  float* ecum = cum + L;
  float* wend = ecum + L;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float ah = a[h];
  const int nc = S / L, nt = (L + kRows - 1) / kRows;

  const size_t xrow = size_t(H) * P;          // x / y stride along S
  const size_t brow = size_t(G) * N;          // b / c stride along S
  const T* xb = x + (size_t(b) * S * H + h) * P + size_t(split) * PB;
  T* yb = y + (size_t(b) * S * H + h) * P + size_t(split) * PB;
  const float* dtb = dt + size_t(b) * S * H + h;
  const T* bb = bm + (size_t(b) * S * G + g) * N;
  const T* cb = cm + (size_t(b) * S * G + g) * N;

  for (int i = tid; i < PB * LDN; i += kThreads) St[i] = 0.f;

  for (int ic = 0; ic < nc; ++ic) {
    const size_t c0 = size_t(ic) * L;
    __syncthreads();   // the previous chunk is done with dts, cum, tiles
    for (int r = tid; r < L; r += kThreads) dts[r] = dtb[(c0 + r) * H];
    __syncthreads();
    if (warp == 0) {   // inclusive scan of a * dt, 32 rows at a time
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int r = base + lane;
        float v = r < L ? ah * dts[r] : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (r < L) cum[r] = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cl = cum[L - 1];
    for (int r = tid; r < L; r += kThreads) {
      ecum[r] = expf(cum[r]);
      wend[r] = expf(cl - cum[r]);
    }
    float dst[CP][CN];
#pragma unroll
    for (int i = 0; i < CP; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) dst[i][j] = 0.f;

    for (int it = 0; it < nt; ++it) {
      const int t0 = it * kRows;
      __syncthreads();   // C_t, B_s, u_s and W of the last tile are free
      stage<T, N, LDN>(Cs, cb + (c0 + t0) * brow, brow, min(kRows, L - t0),
                       nullptr);
      __syncthreads();
      float acc[4][CP];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < CP; ++k) acc[i][k] = 0.f;
      if (ic > 0) {      // the carried state's term: exp(cum_t) C_t state^T
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(Cs + (4 * ty + i) * LDN
                                                     + n);
#pragma unroll
          for (int k = 0; k < CP; ++k) {
            const float4 sv = *reinterpret_cast<const float4*>(
                St + (tx + 16 * k) * LDN + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][k] += dot4(cv[i], sv);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
          const float e = t < L ? ecum[min(t, L - 1)] : 0.f;
#pragma unroll
          for (int k = 0; k < CP; ++k) acc[i][k] *= e;
        }
      }
      const bool last = it == nt - 1;
      for (int js = 0; js <= it; ++js) {
        const int s0 = js * kRows;
        const int sn = min(kRows, L - s0);
        if (js > 0) __syncthreads();   // B_s, u_s and W of js - 1 are free
        stage<T, N, LDN>(Bs, bb + (c0 + s0) * brow, brow, sn, nullptr);
        stage<T, PB, PB>(Us, xb + (c0 + s0) * xrow, xrow, sn, dts + s0);
        __syncthreads();
        // scores C_t B_s^T, masked (s <= t < L) before the decay's exp
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 2
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(Cs + (4 * ty + i) * LDN
                                                     + n);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            bv[j] = *reinterpret_cast<const float4*>(Bs + (tx + 16 * j) * LDN
                                                     + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] += dot4(cv[i], bv[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * ty + i;
          // indices clamped: rows and columns past L are masked anyway
          const float ct = cum[min(t, L - 1)];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool keep = s <= t && t < L;
            const float dec = keep ? ct - cum[min(s, L - 1)] : 0.f;
            Ws[(4 * ty + i) * kLDW + tx + 16 * j] =
                keep ? sc[i][j] * expf(dec) : 0.f;
          }
        }
        __syncthreads();
        // y_t += W u_s
#pragma unroll 2
        for (int s = 0; s < kRows; s += 4) {
          float4 wv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wv[i] = *reinterpret_cast<const float4*>(Ws + (4 * ty + i) * kLDW
                                                     + s);
#pragma unroll
          for (int k = 0; k < CP; ++k) {
            const float u0 = Us[(s + 0) * PB + tx + 16 * k];
            const float u1 = Us[(s + 1) * PB + tx + 16 * k];
            const float u2 = Us[(s + 2) * PB + tx + 16 * k];
            const float u3 = Us[(s + 3) * PB + tx + 16 * k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[i][k] += wv[i].x * u0 + wv[i].y * u1 + wv[i].z * u2
                           + wv[i].w * u3;
          }
        }
        if (last) {      // state update: (u o exp(cum_L - cum))^T B
          for (int s = 0; s < sn; ++s) {
            const float we = wend[s0 + s];
            float uu[CP], bvals[CN];
#pragma unroll
            for (int k = 0; k < CP; ++k) uu[k] = Us[s * PB + ty + 16 * k] * we;
#pragma unroll
            for (int m = 0; m < CN; ++m) bvals[m] = Bs[s * LDN + tx + 16 * m];
#pragma unroll
            for (int k = 0; k < CP; ++k)
#pragma unroll
              for (int m = 0; m < CN; ++m) dst[k][m] += uu[k] * bvals[m];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + 4 * ty + i;
        if (t < L) {
#pragma unroll
          for (int k = 0; k < CP; ++k)
            Vec<T>::store(yb + (c0 + t) * xrow + tx + 16 * k, acc[i][k]);
        }
      }
    }
    // every thread has passed the barriers after its last read of St in
    // this chunk; each writes only its own entries
    const float dtot = expf(cl);
#pragma unroll
    for (int k = 0; k < CP; ++k)
#pragma unroll
      for (int m = 0; m < CN; ++m) {
        float* e = St + (ty + 16 * k) * LDN + tx + 16 * m;
        *e = *e * dtot + dst[k][m];
      }
  }
}

template <typename T, int PB, int N>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, int B, int S, int H, int G, int P, int L,
           int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes<PB, N>(L);
  auto kern = ssd_scan_kernel<T, PB, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || S == 0) return int(cudaGetLastError());
  kern<<<unsigned(size_t(B) * H * nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, G, P, L, nsplit);
  return int(cudaGetLastError());
}

template <typename T, int PB>
int dispatch_n(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, int B, int S, int H, int G, int P,
               int N, int L, int nsplit, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, PB, 16>(x, dt, a, b, c, y, B, S, H, G, P, L,
                                      nsplit, s);
    case 32: return launch<T, PB, 32>(x, dt, a, b, c, y, B, S, H, G, P, L,
                                      nsplit, s);
    case 64: return launch<T, PB, 64>(x, dt, a, b, c, y, B, S, H, G, P, L,
                                      nsplit, s);
    case 128: return launch<T, PB, 128>(x, dt, a, b, c, y, B, S, H, G, P, L,
                                        nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* x, const void* dt, const void* a, const void* b,
             const void* c, void* y, int B, int S, int H, int G, int P, int N,
             int L, int nsplit, cudaStream_t s) {
  switch (P / nsplit) {
    case 16: return dispatch_n<T, 16>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                                      nsplit, s);
    case 32: return dispatch_n<T, 32>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                                      nsplit, s);
    case 64: return dispatch_n<T, 64>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                                      nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, b, c, y: dtype 0 = float32, 1 = bfloat16; dt and a float32. All
// contiguous, 16-byte aligned. P / nsplit in {16, 32, 64}, N in {16, 32,
// 64, 128}, H % G == 0, S % L == 0. Returns cudaGetLastError() after the
// launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y, int B,
                               int S, int H, int G, int P, int N, int L,
                               int nsplit, int dtype, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      S % L != 0 || nsplit <= 0 || P % nsplit != 0 ||
      size_t(B) * H * nsplit > 0x7fffffffu)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, dt, a, b, c, y, B, S, H, G, P, N, L, nsplit, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                                   nsplit, s);
  return int(cudaErrorInvalidValue);
}
