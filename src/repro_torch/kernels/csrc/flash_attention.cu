// Dense flash-attention forward (K5) for Hopper (sm_90a), bound to Python
// through a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py).
//
// K5 replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::_kernel (pallas_call in
//   flash_attention, line 119), with one body per input dtype, chosen in
//   flash_attention_launch:
// - bfloat16: flash_attention_tc_kernel, the tensor-core tile core of
//   attention_tc.cuh (bf16 mma.sync, cp.async double-buffering, GQA-packed
//   tiles of 128 or 64 rows);
// - float32: flash_attention_kernel, float32 on the CUDA cores, the body
//   behind the tight float32 checks (2e-5 against the twin).
//
// What it computes (the same as its TPU kernel and as the twin
// flash_attention_ref in flash_attention.py): q (B, Sq, Hq, D) against
// k, v (B, Sk, Hkv, D), kv head = q head / (Hq / Hkv); row i and column j
// sit at positions i and j. Scores in float32, s = (q . k) * D^-0.5, then
// softcap * tanh(s / softcap), then the mask: causal keeps j <= i, the
// sliding window (causal only) keeps i - j < window, and columns past Sk
// are dropped; masked scores are -1e30. Online softmax (m, l, acc) over
// kv tiles; the output is acc / max(l, 1e-30) in q's dtype. The bf16 body
// rounds p to bf16 for the P.V product (attention_tc.cuh states its
// numerics).
//
// bf16 design: one block of 128 threads (4 warps) per (tile of M / rep
// tokens, b * Hkv + kv head), M = 128 rows at D <= 128 (each warp two
// blocks of 16 rows, so that every K/V fragment read from shared memory
// feeds two products) and 64 at D 256 (a warp's 16 x 256 float32
// accumulator alone takes 128 registers). Row r of the tile is token
// r / rep, head r % rep of the kv head, so the rep q heads of a kv head
// share every K/V tile read (at rep > M, groups of M heads take one block
// each). Heavy causal tiles (late rows) are scheduled first, and the kv
// loop is bounded by the tile's causal and window reach [lo, hi): the TPU
// kernel's pl.when(reachable) skip. K/V tiles of 64 keys at D 64, 32 at D
// 128 and 256 (registers); shared memory 55 KB at D 64, 70 KB at D 128,
// 101 KB at D 256, two blocks per SM (246-254 registers a thread).
//
// float32 design (simple first): one block of 256 threads per (64-row q
// tile, b * Hq + h); heavy tiles first; the q tile and 64-key K and V tiles
// staged in shared memory as float32 with 16-byte loads, rows padded to
// D + 4 floats; the P tile reuses K's space once the scores are in
// registers (52 KB at D 64, 101 KB at D 128, 195 KB at D 256); thread
// (ty, tx) of a 16 x 16 grid owns rows 4ty..4ty+3 and, for the scores, key
// columns tx + 16j (j < 4), for the output dims 4tx + 64j .. + 3; row max
// and row sum are shuffles over the 16 threads of a row; the same reach
// bound. Ragged Sq and Sk are masked rows and columns in both bodies (no
// divisibility requirement); offsets are size_t.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense): bytes (q, k, v
// read once, out written once) or 4 * D FLOPs per reachable (row, column)
// pair per q head, whichever is larger: ~49 us at the static engine's
// prefill (B 16, S 832, Hq 16, Hkv 8, D 128, causal, bytes), ~0.42 ms for
// a Gemma2-9B local layer (B 1, S 8192, Hq 16, D 256, window 4096,
// FLOPs). What the bf16 body leaves: mma.sync reaches only part of the
// card's bf16 rate (wgmma on 64-row warpgroup tiles, TMA loads and a
// producer warp with consumer warpgroups are the rest), the softmax and
// tanhf run between the two products in one instruction stream, and
// diagonal tiles compute their masked half.
//
// Head dims: both bodies are instantiated at a padded width DP and, with
// PAD, take the real head dim D (1 ... 256) at run time; the exact widths
// 64, 128 and 256 keep their own instantiations (PAD false: D is DP and
// the masks compile away). DP is the smallest width the body's layout
// allows: a multiple of 16 for the bf16 body (attention_tc.cuh states how
// it stages and stores D < DP), a multiple of 64 for the float32 body
// (thread tx owns output dims 4 tx + 64 j). The float32 body loads whole
// float4s where D % 4 == 0 (those past D as zeros), else elements below
// D; columns past D are zeros in q and k, and never stored.
//
// Build: kernels/build.py compiles this source once per part (the "nvcc
// parts" line below), one nvcc each, with -DREPRO_PART=<i>; without it
// every part is compiled: part 0 holds the exact widths, the float32
// padded ones and the C entry point; parts 1 and 2 the bf16 padded widths
// up to 128 and above, reached through namespace flash_parts.
// nvcc parts: 3

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

#ifdef REPRO_PART
#define PART(i) (REPRO_PART == (i))
#else
#define PART(i) 1
#endif

namespace flash_parts {
// the bf16 body at a padded width: D <= 128 (part 1) and above (part 2)
int launch_bf16_padded_lo(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                          int D, int causal, int window, float softcap,
                          void* stream);
int launch_bf16_padded_hi(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                          int D, int causal, int window, float softcap,
                          void* stream);
}  // namespace flash_parts

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key columns per tile
constexpr int kLDP = kBK + 4;   // row stride of the P tile (floats)
constexpr float kNegInf = -1e30f;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* src, float* dst) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  }
  __device__ __forceinline__ static void store4(float* dst, const float* x) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DP>
constexpr size_t smem_bytes() {
  return 3 * size_t(kBQ) * (DP + 4) * sizeof(float);
}

// Stage `rows` rows of a (., D) head slice into a (64, DP + 4) float tile;
// row r is read at src + r * stride elements. Rows >= n are zeroed, and
// with PAD the columns past D.
template <typename T, int DP, bool PAD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int n, int D) {
  constexpr int VN = Vec<T>::N;
  constexpr int DV = DP / VN;
  for (int i = threadIdx.x; i < kBQ * DV; i += kThreads) {
    const int r = i / DV, c = (i % DV) * VN;
    float t[VN];
    if (r < n && (!PAD || (D % VN == 0 && c < D))) {
      Vec<T>::load(src + r * stride + c, t);
    } else if (PAD && r < n && D % VN != 0) {
#pragma unroll
      for (int e = 0; e < VN; ++e)
        t[e] = c + e < D ? static_cast<float>(src[r * stride + c + e])
                         : 0.f;
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) t[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(dst + r * (DP + 4) + c + e) =
          make_float4(t[e], t[e + 1], t[e + 2], t[e + 3]);
  }
}

template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq,
                       int Sk, int Hq, int Hkv, int causal, int window,
                       float softcap, float scale, int d) {
  constexpr int LD = DP + 4;
  constexpr int NJ = DP / 64;           // output float4 groups per thread
  static_assert(DP % 64 == 0, "thread tx owns dims 4 tx + 64 j");
  const int D = PAD ? d : DP;           // the real head dim
  extern __shared__ float smem[];
  float* Qs = smem;                     // kBQ x LD
  float* Ks = Qs + kBQ * LD;            // kBK x LD; then P, kBQ x kLDP
  float* Vs = Ks + kBK * LD;            // kBK x LD
  float* Ps = Ks;

  const int tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = tile * kBQ;
  const int nq = min(kBQ, Sq - q0);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // kv reach of the tile: [lo, hi)
  int hi = Sk, lo = 0;
  if (causal) {
    hi = min(Sk, q0 + nq);
    if (window > 0) lo = max(0, q0 - window + 1);
  }

  const size_t q_stride = size_t(Hq) * D, kv_stride = size_t(Hkv) * D;
  const T* qb = q + (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
  stage<T, DP, PAD>(Qs, qb, q_stride, nq, D);

  float m[4], l[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  const T* kb = k + size_t(b) * Sk * kv_stride + size_t(kvh) * D;
  const T* vb = v + size_t(b) * Sk * kv_stride + size_t(kvh) * D;
  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    const int nk = min(kBK, Sk - k0);
    __syncthreads();               // previous P and V consumed
    stage<T, DP, PAD>(Ks, kb + size_t(k0) * kv_stride, kv_stride, nk, D);
    stage<T, DP, PAD>(Vs, vb + size_t(k0) * kv_stride, kv_stride, nk, D);
    __syncthreads();

    // scores: rows 4ty + i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int e = 0; e < DP; e += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * LD + e);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // scale, softcap, mask; online softmax per row
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        bool ok = col < Sk;
        if (causal) {
          ok = ok && col <= row;
          if (window > 0) ok = ok && row - col < window;
        }
        x = ok ? x : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        sum += p[i][j];
      }
      sum = half_warp_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] *= alpha;
    }

    __syncthreads();               // every thread done reading Ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(4 * ty + i) * kLDP + tx + 16 * j] =
          p[i][j];
    __syncthreads();

    // acc += P . V over the tile's live columns (V rows past Sk are 0)
    const int ncols = (nk + 3) & ~3;
    for (int c = 0; c < ncols; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (4 * ty + i) * kLDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              Vs + (c + cc) * LD + 4 * tx + 64 * j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pc = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y
                             : cc == 2 ? pv[i].z : pv[i].w;
            acc[i][j][0] = fmaf(pc, vv.x, acc[i][j][0]);
            acc[i][j][1] = fmaf(pc, vv.y, acc[i][j][1]);
            acc[i][j][2] = fmaf(pc, vv.z, acc[i][j][2]);
            acc[i][j][3] = fmaf(pc, vv.w, acc[i][j][3]);
          }
        }
      }
    }
  }

  T* ob = out + (size_t(b) * Sq + q0) * q_stride + size_t(h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = acc[i][j][e] * inv;
      if constexpr (PAD) {   // the columns below D
        const int c = 4 * tx + 64 * j;
        if (D % 4 == 0) {
          if (c < D) Vec<T>::store4(ob + r * q_stride + c, o);
        } else {
          for (int e = 0; e < 4 && c + e < D; ++e)
            ob[r * q_stride + c + e] = o[e];
        }
      } else {
        Vec<T>::store4(ob + r * q_stride + 4 * tx + 64 * j, o);
      }
    }
  }
}

// bf16 body: 4 warps of 2 x 16 rows (128 rows) at D 32 ... 128, of 16 rows
// (64) above (at D 256 a warp's 16 x 256 float32 accumulator alone takes
// 128 registers) and at D 16, where two blocks' scores of 64 keys (64
// registers) cost more than the shared K fragments save: ptxas fit that
// instantiation into 128 registers with a spill
template <int DP>
struct TcRows {
  static constexpr int MB = DP <= 128 && DP >= 32 ? 2 : 1;  // 16-row blocks
  static constexpr int M = 64 * MB;             // rows per block
};

template <int DP, bool PAD>
__global__ void __launch_bounds__(128)
flash_attention_tc_kernel(const attn_tc::bf16* __restrict__ q,
                          const attn_tc::bf16* __restrict__ k,
                          const attn_tc::bf16* __restrict__ v,
                          attn_tc::bf16* __restrict__ out, int Sq, int Sk,
                          int Hq, int Hkv, int causal, int window,
                          float softcap, float scale, int d) {
  const int D = PAD ? d : DP;
  const int rep = Hq / Hkv;
  constexpr int M = TcRows<DP>::M;
  const int hr = min(rep, M), ng = (rep + hr - 1) / hr, tq = M / hr;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int y = blockIdx.y;
  const int hg = y % ng, kvh = (y / ng) % Hkv, b = y / (ng * Hkv);
  const int tok0 = tile * tq;
  attn_tc::TileArgs a;
  const size_t head0 = size_t(kvh) * rep + size_t(hg) * hr;
  const size_t qoff = (size_t(b) * Sq + tok0) * Hq * D + head0 * D;
  a.q = q + qoff;
  a.out = out + qoff;
  a.tok_stride = size_t(Hq) * D;
  a.hr = hr;
  a.nh = min(hr, rep - hg * hr);
  a.ntok = min(tq, Sq - tok0);
  a.pos0 = tok0;
  a.nkeys = Sk;
  a.lo = 0;
  a.hi = Sk;
  if (causal) {
    a.hi = min(Sk, tok0 + a.ntok);
    if (window > 0) a.lo = max(0, tok0 - window + 1);
  }
  a.d = D;
  a.causal = causal;
  a.window = causal ? window : 0;
  a.softcap = softcap;
  a.scale = scale;
  const attn_tc::DenseKeys keys{
      size_t(b) * Sk * Hkv * D + size_t(kvh) * D, size_t(Hkv) * D};
  attn_tc::attend_tc<DP, 4, TcRows<DP>::MB, PAD>(a, k, v, keys);
}

template <int DP, bool PAD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, int D, int causal,
               int window, float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes<DP>();
  auto kern = flash_attention_kernel<float, DP, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || Sq == 0) return int(cudaGetLastError());
  kern<<<dim3((Sq + kBQ - 1) / kBQ, B * Hq), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq,
      Hkv, causal, window, softcap, 1.0f / sqrtf(float(D)), D);
  return int(cudaGetLastError());
}

template <int DP, bool PAD>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = attn_tc::smem_bytes<DP, 4, TcRows<DP>::MB>();
  auto kern = flash_attention_tc_kernel<DP, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || Sq == 0) return int(cudaGetLastError());
  const int rep = Hq / Hkv;
  constexpr int M = TcRows<DP>::M;
  const int hr = rep < M ? rep : M;
  const int tq = M / hr, ng = (rep + hr - 1) / hr;
  kern<<<dim3((Sq + tq - 1) / tq, B * Hkv * ng), 128, smem, stream>>>(
      static_cast<const attn_tc::bf16*>(q),
      static_cast<const attn_tc::bf16*>(k),
      static_cast<const attn_tc::bf16*>(v), static_cast<attn_tc::bf16*>(out),
      Sq, Sk, Hq, Hkv, causal, window, softcap, 1.0f / sqrtf(float(D)), D);
  return int(cudaGetLastError());
}

}  // namespace

// the bf16 body's padded widths, multiples of 16: up to 128 in part 1,
// above in part 2
#define K5_TC_WIDTHS_LO(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#define K5_TC_WIDTHS_HI(X) \
  X(144) X(160) X(176) X(192) X(208) X(224) X(240) X(256)
#define K5_CASE(W)                                                         \
  if (D <= W)                                                              \
    return launch_bf16<W, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,       \
                                causal, window, softcap,                   \
                                static_cast<cudaStream_t>(stream));

namespace flash_parts {
#if PART(1)
int launch_bf16_padded_lo(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                          int D, int causal, int window, float softcap,
                          void* stream) {
  K5_TC_WIDTHS_LO(K5_CASE)
  return int(cudaErrorInvalidValue);
}
#endif
#if PART(2)
int launch_bf16_padded_hi(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int Hq, int Hkv,
                          int D, int causal, int window, float softcap,
                          void* stream) {
  K5_TC_WIDTHS_HI(K5_CASE)
  return int(cudaErrorInvalidValue);
}
#endif
}  // namespace flash_parts

#if PART(0)
#define DISPATCH_D(FN)                                                    \
  switch (D) {                                                            \
    case 64: return FN<64, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,    \
                                  causal, window, softcap, s);            \
    case 128: return FN<128, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,  \
                                    causal, window, softcap, s);          \
    case 256: return FN<256, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,  \
                                    causal, window, softcap, s);          \
  }

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1. window <= 0: no
// sliding window (read only when causal). softcap <= 0: no softcap. D in
// 1 ... 256: 64, 128 and 256 run their exact instantiations, any other D
// a padded one (float32: 64, 128, 192, 256; bf16: a multiple of 16).
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D,
                                      int causal, int window, float softcap,
                                      int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B < 0 || Sq < 0 || Sk < 0 ||
      size_t(B) * Hq > 65535 || D < 1 || D > 256)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_D(launch_f32)
    if (D <= 64)
      return launch_f32<64, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                  causal, window, softcap, s);
    if (D <= 128)
      return launch_f32<128, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                   causal, window, softcap, s);
    if (D <= 192)
      return launch_f32<192, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                   causal, window, softcap, s);
    return launch_f32<256, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,
                                 causal, window, softcap, s);
  }
  if (dtype == 1) {
    DISPATCH_D(launch_bf16)
    if (D <= 128)
      return flash_parts::launch_bf16_padded_lo(q, k, v, out, B, Sq, Sk, Hq,
                                                Hkv, D, causal, window,
                                                softcap, stream);
    return flash_parts::launch_bf16_padded_hi(q, k, v, out, B, Sq, Sk, Hq,
                                              Hkv, D, causal, window,
                                              softcap, stream);
  }
  return int(cudaErrorInvalidValue);
}
#endif
