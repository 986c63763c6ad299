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
// - float32: flash_attention_kernel, the float32 tile core of
//   attention_f32.cuh (float32 FMAs on the CUDA cores, cp.async
//   double-buffering, GQA-packed tiles of 64 rows, a key split over a
//   cluster where the tiles leave the grid under a wave), the body behind
//   the tight float32 checks (2e-5 against the twin).
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
// float32 design: one block of 4 warps per (tile of 64 / hr tokens,
// b * Hkv + kv head, group of hr = min(rep, 64) of its q heads), the same
// GQA packing, heavy-tiles-first order and reach bound as the bf16 body;
// where the tiles leave the grid under one wave of 132 SMs, a cluster of
// 2, 4 or 8 blocks splits each tile's keys (flash_attention.py's f32_plan,
// passed as splits). attention_f32.cuh states the core's layout, split,
// numerics and bound. Ragged Sq and Sk are masked rows and columns in both
// bodies (no divisibility requirement); offsets are size_t.
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
// it stages and stores D < DP), a multiple of 32 for the float32 body (a
// lane owns DP / 8 output dims as float4s; attention_f32.cuh states how it
// stages and stores D < DP).
//
// Build: kernels/build.py compiles this source once per part (the "nvcc
// parts" line below), one nvcc each, with -DREPRO_PART=<i>; without it
// every part is compiled: part 0 holds the exact widths and the C entry
// point; parts 1 and 2 the bf16 padded widths up to 128 and above, part 3
// the float32 padded widths, reached through namespace flash_parts.
// nvcc parts: 4

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_f32.cuh"
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
// the float32 body at a padded width (part 3)
int launch_f32_padded(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int Hq, int Hkv, int D,
                      int causal, int window, float softcap, int splits,
                      void* stream);
}  // namespace flash_parts

namespace {

// float32 body: one block of 4 warps (64 rows) per (tile of 64 / hr
// tokens, b * Hkv + kv head, group of hr of its rep q heads), or a cluster
// of `splits` blocks splitting its keys, over the float32 tile core
template <int DP, bool PAD>
__global__ void
__launch_bounds__(128, attn_f32::Tile<DP>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int Sq, int Sk, int Hq, int Hkv, int causal,
                       int window, float softcap, float scale, int d,
                       int splits) {
  const int D = PAD ? d : DP;
  constexpr int M = attn_f32::kRows;
  const int rep = Hq / Hkv;
  const int hr = min(rep, M), ng = (rep + hr - 1) / hr, tq = M / hr;
  // heavy tiles first; the blocks of a cluster share one tile
  const int tile = gridDim.x / splits - 1 - blockIdx.x / splits;
  const int y = blockIdx.y;
  const int hg = y % ng, kvh = (y / ng) % Hkv, b = y / (ng * Hkv);
  const int tok0 = tile * tq;
  attn_f32::TileArgs a;
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
  a.splits = splits;
  const attn_f32::DenseKeys keys{
      size_t(b) * Sk * Hkv * D + size_t(kvh) * D, size_t(Hkv) * D};
  attn_f32::attend_f32<DP, PAD>(a, k, v, keys);
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

// splits (1, 2, 4 or 8: flash_attention.py's f32_plan) blocks of a cluster
// split each tile's keys; the grid is (tiles * splits, B * Hkv * head
// groups)
template <int DP, bool PAD>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Sq, int Sk, int Hq, int Hkv, int D, int causal,
               int window, float softcap, int splits, cudaStream_t stream) {
  auto kern = flash_attention_kernel<DP, PAD>;
  constexpr int M = attn_f32::kRows;
  const int rep = Hq / Hkv, hr = rep < M ? rep : M;
  const int tq = M / hr, ng = (rep + hr - 1) / hr;
  return attn_f32::launch(
      kern, dim3((Sq + tq - 1) / tq, B * Hkv * ng), splits,
      attn_f32::smem_bytes<DP>(), stream, B == 0 || Sq == 0,
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk, Hq,
      Hkv, causal, window, softcap, 1.0f / sqrtf(float(D)), D, splits);
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
// the float32 body's padded widths, multiples of 32 (part 3)
#define K5_F32_WIDTHS(X) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)
#define K5_F32_CASE(W)                                                     \
  if (D <= W)                                                              \
    return launch_f32<W, true>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,        \
                               causal, window, softcap, splits,            \
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
#if PART(3)
int launch_f32_padded(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int Hq, int Hkv, int D,
                      int causal, int window, float softcap, int splits,
                      void* stream) {
  K5_F32_WIDTHS(K5_F32_CASE)
  return int(cudaErrorInvalidValue);
}
#endif
}  // namespace flash_parts

#if PART(0)
#define DISPATCH_D(FN, ...)                                               \
  switch (D) {                                                            \
    case 64: return FN<64, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,    \
                                  causal, window, softcap, __VA_ARGS__);  \
    case 128: return FN<128, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,  \
                                    causal, window, softcap,              \
                                    __VA_ARGS__);                         \
    case 256: return FN<256, false>(q, k, v, out, B, Sq, Sk, Hq, Hkv, D,  \
                                    causal, window, softcap,              \
                                    __VA_ARGS__);                         \
  }

// dtype: 0 = float32, 1 = bfloat16. causal: 0 or 1. window <= 0: no
// sliding window (read only when causal). softcap <= 0: no softcap. D in
// 1 ... 256: 64, 128 and 256 run their exact instantiations, any other D
// a padded one (float32: a multiple of 32; bf16: a multiple of 16).
// splits (float32 only): blocks of a cluster splitting each tile's keys,
// 1, 2, 4 or 8. The grid's rows (65535 at most): B * Hkv * ceil(rep / 64)
// in float32, B * Hq in bf16. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B,
                                      int Sq, int Sk, int Hq, int Hkv, int D,
                                      int causal, int window, float softcap,
                                      int dtype, int splits, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B < 0 || Sq < 0 || Sk < 0 || D < 1 ||
      D > 256)
    return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int rep = Hq / Hkv, hr = rep < attn_f32::kRows ? rep
                                                         : attn_f32::kRows;
    if (size_t(B) * Hkv * ((rep + hr - 1) / hr) > 65535)
      return int(cudaErrorInvalidValue);
    DISPATCH_D(launch_f32, splits, s)
    return flash_parts::launch_f32_padded(q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                          D, causal, window, softcap, splits,
                                          stream);
  }
  if (size_t(B) * Hq > 65535) return int(cudaErrorInvalidValue);
  if (dtype == 1) {
    DISPATCH_D(launch_bf16, s)
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
