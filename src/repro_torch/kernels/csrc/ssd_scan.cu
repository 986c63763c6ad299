// Mamba2 SSD chunk scan (K6) for Hopper (sm_90a), bound to Python through a
// plain C interface loaded with ctypes (repro_torch/kernels/build.py).
//
// K6 (ssd_scan_tc_kernel for bf16, ssd_scan_kernel for float32) replaces
// the Pallas TPU kernel
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
// The cumsum, decays and state are float32; y is written in x's dtype.
//
// Two bodies, chosen by dtype in ssd_scan_launch:
// - bfloat16: ssd_scan_tc_kernel (below, namespace tc), the products on
//   the tensor cores;
// - float32: ssd_scan_kernel, float32 on the CUDA cores, the body behind
//   the float32 bar (RTOL 1e-5) and the float32 recompute.
// Both take the TPU grid (B * H, n_chunks), whose state sits in VMEM
// scratch carried along the sequential chunk axis, as a loop over the
// chunks inside one block; nothing is carried between blocks. A block owns
// one (batch, head) and a slice of PB of the P state rows (the rows are
// independent: y[:, p] reads only state[p, :]); the wrapper splits P
// (PB = P / 2 or P / 4, ssd_scan.p_splits) while twice the B * H blocks
// still fit one wave of one block per SM, and the C B^T scores are then
// recomputed per slice. The slices give the same bits.
//
// ssd_scan_tc_kernel (8 warps, one block per SM):
// - a chunk is cut into t tiles of 128 rows, 16 per warp, and s tiles of
//   64 rows. Per t tile, C_t is staged once (cp.async); each warp reads
//   its 16 rows of C as mma A fragments (ldmatrix) where a product needs
//   them. Then, for every s tile at or before it, with B_s and x_s
//   double-buffered by cp.async (the next tile's copy in flight while
//   this one is multiplied):
//     S = C_t B_s^T                         bf16 x bf16 -> float32, 32
//                                           columns at a time;
//     W' = S o exp(cum_t - cum_s) o dt_s    masked (s <= t < L) before
//                                           the exp, float32;
//     y_t += W' x_s                         W' as bf16 hi + lo, two
//                                           products, x_s exact;
//   the carried state's term y_t += exp(cum_t) (C_t state^T) comes first,
//   with the state as hi + lo. The last t tile walks every s tile, so it
//   also runs the state update
//     state = state exp(cum_L) + x'^T B_s,  x' = x o dt exp(cum_L - cum)
//   with x' as hi + lo (the float32 factor folded into x rather than B:
//   an s x PB tile instead of an s x N one); the state is float32 in the
//   registers of the warps that own its m16 x n8 tiles, and its hi + lo
//   copy in shared memory feeds the next chunk's state term;
// - all products are mma.sync.m16n8k16 bf16 with float32 accumulation, A
//   and B fragments from ldmatrix (.trans for x and x'^T); S stays in
//   registers and is re-packed as W''s A fragments (the accumulator and A
//   layouts agree per thread); n8 tiles and k16 steps wholly above the
//   causal diagonal are skipped;
// - why hi + lo: bf16 inputs C, B, x enter the products exactly, but a
//   float32 operand rounded once to bf16 errs by 2^-9 relative, ~100x the
//   bf16 bar (error_ratio in ssd_scan.py); hi = bf16(v), lo = bf16(v - hi)
//   carries v to ~2^-16, and the two products are summed in float32;
// - the cumsum, decays, mask and the carried state stay float32. Shared
//   memory: 145 KB at PB 64, N 128, L 256 (rows padded by 16 B so
//   ldmatrix phases hit distinct banks). The scores are recomputed per
//   head (and per P slice): the heads of a B/C group do not share them.
//
// ssd_scan_kernel (float32, simple first):
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
// What the tensor-core design leaves on the table: the hi + lo splits
// double three of the four products; the scores are computed per head
// (64x at mamba2-1.3b's G 1) and per P slice; C_t's copy and the chunk's
// dt/cumsum are not overlapped with math (prefetching them across tile
// and chunk boundaries, with a second C buffer, measured 8% slower); one
// block of 8 warps per SM.
//
// Widths: both bodies are instantiated at a padded slice PB (16, 32 or
// 64 state rows) and state width N (16, 32, 64 or 128: the state's m16 x
// n8 tiles divide over the tensor-core body's 8 warps only there) and,
// with PAD, take the slice's real rows and the real N (any P and N of 1
// ... 128) at run time; today's sizes (P / nsplit and N both in the sets)
// keep their own instantiations (PAD false: the masks compile away). A
// slice owns rows [split pb, split pb + pb) of P, pb = ceil(P / nsplit),
// the last slice fewer. Staging zero-fills the columns past the real N of
// B and C and past the slice's rows of x, so the scores, the state and y
// are unchanged; y is stored only below the slice's rows. The copies stay
// 16-byte ones (cp.async in the bf16 body, float4 loads in the float32
// one) where rows are whole aligned vectors, else element loads.
//
// Build: kernels/build.py compiles this source once per part (the "nvcc
// parts" line below), one nvcc each, with -DREPRO_PART=<i>; without it
// every part is compiled: part 0 holds today's sizes and the C entry
// point, part 1 the float32 padded body, part 2 the bf16 padded body,
// reached through namespace ssd_parts.
// nvcc parts: 3

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tc.cuh"

#ifdef REPRO_PART
#define PART(i) (REPRO_PART == (i))
#else
#define PART(i) 1
#endif

namespace ssd_parts {
// the padded bodies: float32 (part 1) and bf16 (part 2)
int padded_f32(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, int B, int S, int H, int G, int P,
               int N, int L, int nsplit, void* stream);
int padded_tc(const void* x, const void* dt, const void* a, const void* b,
              const void* c, void* y, int B, int S, int H, int G, int P,
              int N, int L, int nsplit, void* stream);
}  // namespace ssd_parts

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
// scale is given. Rows >= n are zeroed; with PAD, so are the columns past
// cols, and rows are read element by element unless vec (aligned whole
// vectors).
template <typename T, int COLS, int LD, bool PAD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      size_t stride, int n,
                                      const float* scale, int cols,
                                      bool vec) {
  constexpr int VN = Vec<T>::N;
  constexpr int CV = COLS / VN;
  for (int i = threadIdx.x; i < kRows * CV; i += kThreads) {
    const int r = i / CV, c = (i % CV) * VN;
    float t[VN];
    if (r < n && (!PAD || (vec && c < cols))) {
      Vec<T>::load(src + r * stride + c, t);
      if (scale != nullptr) {
        const float s = scale[r];
#pragma unroll
        for (int e = 0; e < VN; ++e) t[e] *= s;
      }
    } else if (PAD && r < n && !vec) {
      const float s = scale != nullptr ? scale[r] : 1.f;
#pragma unroll
      for (int e = 0; e < VN; ++e)
        t[e] = c + e < cols ? static_cast<float>(src[r * stride + c + e]) * s
                            : 0.f;
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

template <typename T, int PB, int N, bool PAD>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y, int S, int H,
                int G, int P, int L, int nsplit, int n, int pb) {
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
  // the real state width and this slice's rows of P (PB and N with PAD
  // false); rows and columns are read as whole aligned vectors when vec
  const int Nr = PAD ? n : N, rows = PAD ? pb : PB;
  const int pr = PAD ? min(pb, P - split * pb) : PB;
  constexpr int VN = Vec<T>::N;
  const bool xvec = !PAD || (P % VN == 0 && pb % VN == 0);
  const bool nvec = !PAD || Nr % VN == 0;

  const size_t xrow = size_t(H) * P;          // x / y stride along S
  const size_t brow = size_t(G) * Nr;         // b / c stride along S
  const T* xb = x + (size_t(b) * S * H + h) * P + size_t(split) * rows;
  T* yb = y + (size_t(b) * S * H + h) * P + size_t(split) * rows;
  const float* dtb = dt + size_t(b) * S * H + h;
  const T* bb = bm + (size_t(b) * S * G + g) * Nr;
  const T* cb = cm + (size_t(b) * S * G + g) * Nr;

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
      stage<T, N, LDN, PAD>(Cs, cb + (c0 + t0) * brow, brow,
                            min(kRows, L - t0), nullptr, Nr, nvec);
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
        stage<T, N, LDN, PAD>(Bs, bb + (c0 + s0) * brow, brow, sn, nullptr,
                              Nr, nvec);
        stage<T, PB, PB, PAD>(Us, xb + (c0 + s0) * xrow, xrow, sn, dts + s0,
                              pr, xvec);
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
            if (!PAD || tx + 16 * k < pr)
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

// ---------------------------------------------------------------------------
// bfloat16: ssd_scan_tc_kernel, the four products of a chunk on the tensor
// cores (mma.sync m16n8k16, bf16 in, float32 accumulation)

namespace tc {

using attn_tc::bf16;
using attn_tc::cp_async16;
using attn_tc::ldmatrix_x4;
using attn_tc::ldmatrix_x4_trans;
using attn_tc::mma_bf16;
using attn_tc::smem_u32;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int TT = 16 * kWarps;   // t rows of a tile: 16 per warp
constexpr int TS = 64;            // s rows (columns of W') of a tile

// shared memory, in bf16 elements; rows padded by 8 elements (16 B), so
// the eight rows an ldmatrix phase reads fall in distinct banks
template <int PB, int N>
struct Smem {
  static constexpr int LDN = N + 8, LDP = PB + 8;
  static constexpr int C = 0;                    // C_t       TT x LDN
  static constexpr int B = C + TT * LDN;         // B_s   2 x TS x LDN
  static constexpr int X = B + 2 * TS * LDN;     // x_s   2 x TS x LDP
  static constexpr int XH = X + 2 * TS * LDP;    // x' hi     TS x LDP
  static constexpr int XL = XH + TS * LDP;       // x' lo     TS x LDP
  static constexpr int SH = XL + TS * LDP;       // state hi  PB x LDN
  static constexpr int SL = SH + PB * LDN;       // state lo  PB x LDN
  static constexpr int END = SL + PB * LDN;      // then the row tables
  // row tables of Lp = L rounded up to whole t tiles: (cum, dt) pairs,
  // exp(cum) and dt exp(cum_L - cum); rows past L read (cum_L, 0), 0, 0
  __host__ __device__ static int padded(int L) {
    return (L + TT - 1) / TT * TT;
  }
  static size_t bytes(int L) {
    return size_t(END) * sizeof(bf16) +
           4 * size_t(padded(L)) * sizeof(float);
  }
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, "
               "[%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// a float32 pair as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi);
// hi + lo carries v to ~2^-16 relative (one bf16 rounding alone, 2^-9)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h),
                                                 b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// rows [0, n) of a (rows x COLS) bf16 slice into a padded tile by cp.async;
// rows >= n are zero-filled by the copy (src-size 0); with PAD, so are the
// columns past cols, and the rows are staged by attn_tc::copy_chunk (element
// loads unless vec: aligned rows of whole 16-byte pieces)
template <int ROWS, int COLS, int LD, bool PAD = false>
__device__ __forceinline__ void stage(bf16* dst, const bf16* __restrict__ src,
                                      size_t stride, int n, int cols = COLS,
                                      bool vec = true) {
  constexpr int CH = COLS / 8;            // 16 B pieces of a row
  for (int i = threadIdx.x; i < ROWS * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r < n;
    if constexpr (PAD) {
      attn_tc::copy_chunk(dst + r * LD + c,
                          ok ? src + size_t(r) * stride : src, c / 8, cols,
                          ok, vec);
    } else {
      cp_async16(smem_u32(dst + r * LD + c),
                 ok ? src + size_t(r) * stride + c : src, ok);
    }
  }
}

template <int PB, int N, bool PAD>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a, const bf16* __restrict__ bm,
                   const bf16* __restrict__ cm, bf16* __restrict__ y, int S,
                   int H, int G, int P, int L, int nsplit, int n, int pb) {
  using SM = Smem<PB, N>;
  constexpr int LDN = SM::LDN, LDP = SM::LDP;
  constexpr int NK = N / 16;              // k16 steps over N
  constexpr int NP = PB / 8;              // n8 tiles of a y row block
  constexpr int MT = PB / 16, NT = N / 8; // m16 x n8 tiles of the state
  constexpr int NPW = MT * NT >= kWarps ? MT * NT / kWarps : 1;
  static_assert(NP % 2 == 0 && NT % NPW == 0, "tile counts");
  extern __shared__ __align__(16) unsigned char ssd_tc_smem[];
  bf16* sm = reinterpret_cast<bf16*>(ssd_tc_smem);
  bf16* Cs = sm + SM::C;
  bf16* Bs = sm + SM::B;
  bf16* Xs = sm + SM::X;
  bf16* Xh = sm + SM::XH;
  bf16* Xl = sm + SM::XL;
  bf16* Sh = sm + SM::SH;
  bf16* Sl = sm + SM::SL;
  const int Lp = SM::padded(L);
  float2* cd = reinterpret_cast<float2*>(sm + SM::END);  // (cum, dt) x Lp
  float* ecum = reinterpret_cast<float*>(cd + Lp);       // exp(cum)
  float* fw = ecum + Lp;                // dt exp(cum_L - cum): x' = x fw

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;
  const int b = bh / H, h = bh % H;
  const int grp = h / (H / G);
  const float ah = a[h];
  const int nc = S / L;
  const int nt = (L + TT - 1) / TT;
  // the real state width and this slice's rows of P (as in the float32
  // body); x rows are whole 16-byte pieces when xvec
  const int Nr = PAD ? n : N, rows = PAD ? pb : PB;
  const int pr = PAD ? min(pb, P - split * pb) : PB;
  const bool xvec = !PAD || (P % 8 == 0 && pb % 8 == 0);
  const bool nvec = !PAD || Nr % 8 == 0;

  const size_t xrow = size_t(H) * P;          // x / y stride along S
  const size_t brow = size_t(G) * Nr;         // b / c stride along S
  const bf16* xb = x + (size_t(b) * S * H + h) * P + size_t(split) * rows;
  bf16* yb = y + (size_t(b) * S * H + h) * P + size_t(split) * rows;
  const float* dtb = dt + size_t(b) * S * H + h;
  const bf16* bb = bm + (size_t(b) * S * G + grp) * Nr;
  const bf16* cb = cm + (size_t(b) * S * G + grp) * Nr;

  // this warp's tiles of the carried state (float32, in registers): m16
  // tile sm0, n8 tiles sn0 .. sn0 + NPW - 1
  const int q0 = warp * NPW;
  const bool owns = q0 < MT * NT;
  const int sm0 = q0 / NT, sn0 = q0 % NT;
  float st[NPW][4];
#pragma unroll
  for (int i = 0; i < NPW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = 0.f;

  for (int ic = 0; ic < nc; ++ic) {
    const size_t c0 = size_t(ic) * L;
    __syncthreads();   // the previous chunk is done with every table
    for (int r = tid; r < Lp; r += kThreads)
      cd[r].y = r < L ? dtb[(c0 + r) * H] : 0.f;
    __syncthreads();
    if (warp == 0) {   // inclusive scan of a * dt, 32 rows at a time
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int r = base + lane;
        float v = r < L ? ah * cd[r].y : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (r < L) cd[r].x = v;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float cl = cd[L - 1].x;
    for (int r = tid; r < Lp; r += kThreads) {
      if (r < L) {
        ecum[r] = expf(cd[r].x);
        fw[r] = cd[r].y * expf(cl - cd[r].x);
      } else {
        cd[r].x = cl;
        ecum[r] = fw[r] = 0.f;
      }
    }
    // the state entering the update: state exp(cum_L); the update's
    // products accumulate onto it
    const float dtot = expf(cl);
#pragma unroll
    for (int i = 0; i < NPW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] *= dtot;

    for (int it = 0; it < nt; ++it) {
      const int t0 = it * TT;
      const bool last = it == nt - 1;   // walks every s tile of the chunk
      const int ns = (min(t0 + TT, L) + TS - 1) / TS;
      const int w0 = t0 + 16 * warp;    // this warp's first t row
      const bool live = w0 < L;
      __syncthreads();   // C_t, B_s, x_s, x' and the tables are visible
      stage<TT, N, LDN, PAD>(Cs, cb + (c0 + t0) * brow, brow,
                             min(TT, L - t0), Nr, nvec);
      stage<TS, N, LDN, PAD>(Bs, bb + c0 * brow, brow, L, Nr, nvec);
      stage<TS, PB, LDP, PAD>(Xs, xb + c0 * xrow, xrow, L, pr, xvec);
      attn_tc::cp_async_commit();

      float yacc[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[j][e] = 0.f;
      const int ta = w0 + g, tb = w0 + g + 8;
      // this warp's 16 rows of C_t, as the A fragment of k16 step kk
      const uint32_t c_frag = smem_u32(Cs + (16 * warp + lane % 16) * LDN +
                                       (lane / 16) * 8);

      for (int js = 0; js < ns; ++js) {
        const int s0 = js * TS;
        const int buf = js & 1;
        if (js + 1 < ns) {
          const int s1 = s0 + TS;
          stage<TS, N, LDN, PAD>(Bs + (buf ^ 1) * TS * LDN,
                                 bb + (c0 + s1) * brow, brow, L - s1, Nr,
                                 nvec);
          stage<TS, PB, LDP, PAD>(Xs + (buf ^ 1) * TS * LDP,
                                  xb + (c0 + s1) * xrow, xrow, L - s1, pr,
                                  xvec);
          attn_tc::cp_async_commit();
          attn_tc::cp_async_wait<1>();
        } else {
          attn_tc::cp_async_wait<0>();
        }
        __syncthreads();
        const bf16* Bt = Bs + buf * TS * LDN;
        const bf16* Xt = Xs + buf * TS * LDP;
        if (js == 0 && ic > 0 && live) {
          // the carried state's term: exp(cum_t) C_t state^T, the state as
          // hi + lo
#pragma unroll
          for (int kk = 0; kk < NK; ++kk) {
            uint32_t cf[4];
            ldmatrix_x4(cf, c_frag + kk * 32);
#pragma unroll
            for (int jp = 0; jp < NP; jp += 2) {
              const int mi = lane / 8;
              const int row = 8 * jp + lane % 8 + 8 * (mi / 2);
              const int col = kk * 16 + 8 * (mi % 2);
              uint32_t bh[4], bl[4];
              ldmatrix_x4(bh, smem_u32(Sh + row * LDN + col));
              ldmatrix_x4(bl, smem_u32(Sl + row * LDN + col));
              mma_bf16(yacc[jp], cf, bh[0], bh[1]);
              mma_bf16(yacc[jp], cf, bl[0], bl[1]);
              mma_bf16(yacc[jp + 1], cf, bh[2], bh[3]);
              mma_bf16(yacc[jp + 1], cf, bl[2], bl[3]);
            }
          }
          const float ea = ecum[ta], eb = ecum[tb];
#pragma unroll
          for (int j = 0; j < NP; ++j) {
            yacc[j][0] *= ea; yacc[j][1] *= ea;
            yacc[j][2] *= eb; yacc[j][3] *= eb;
          }
        }
        if (last) {
          // x' = x dt exp(cum_L - cum) as hi + lo, for the state update
          constexpr int PAIRS = TS * PB / 2;
          for (int i = tid; i < PAIRS; i += kThreads) {
            const int r = i / (PB / 2), c = (i % (PB / 2)) * 2;
            const float f = fw[s0 + r];
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(Xt + r * LDP + c));
            uint32_t hi, lo;
            split_pair(v.x * f, v.y * f, hi, lo);
            *reinterpret_cast<uint32_t*>(Xh + r * LDP + c) = hi;
            *reinterpret_cast<uint32_t*>(Xl + r * LDP + c) = lo;
          }
          __syncthreads();
        }
        // y_t += W' x_s, W' = (C_t B_s^T) o exp(cum_t - cum_s) dt_s on
        // s <= t < L (masked before the exp), W' as hi + lo
        const int reach = w0 + 16 - s0;   // columns s0 + [0, reach) kept
        if (live && reach > 0) {
          // rows: the decay's exponent cum_t - cum_s, and the mask, which
          // only a tile crossing the diagonal needs (rows past L are not
          // stored; columns past L have dt = 0)
          const float cta = cd[ta].x, ctb = cd[tb].x;
          const bool diag = s0 + TS > w0;
#pragma unroll
          for (int hc = 0; hc < 2; ++hc) {     // 32 columns at a time
            if (32 * hc >= reach) continue;
            // S = C_t B_s^T on columns s0 + 32 hc + [0, 32)
            float sacc[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) sacc[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < NK; ++kk) {
              uint32_t cf[4];
              ldmatrix_x4(cf, c_frag + kk * 32);
#pragma unroll
              for (int jp = 0; jp < 4; jp += 2) {
                if (32 * hc + 8 * jp < reach) {
                  const int mi = lane / 8;
                  const int row = 32 * hc + 8 * jp + lane % 8 + 8 * (mi / 2);
                  const int col = kk * 16 + 8 * (mi % 2);
                  uint32_t bf[4];
                  ldmatrix_x4(bf, smem_u32(Bt + row * LDN + col));
                  mma_bf16(sacc[jp], cf, bf[0], bf[1]);
                  mma_bf16(sacc[jp + 1], cf, bf[2], bf[3]);
                }
              }
            }
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {   // k16 steps over s
              const int c16 = 32 * hc + 16 * k2;
              if (c16 >= reach) continue;
              uint32_t ah[4], al[4];
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                const int j = 2 * k2 + half;
                const int sa = s0 + c16 + 8 * half + 2 * tq;  // sa, sa + 1
                // (cum, dt) of columns sa and sa + 1
                const float4 cs = *reinterpret_cast<const float4*>(cd + sa);
                float w[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float ct = e < 2 ? cta : ctb;
                  const float csum = e & 1 ? cs.z : cs.x;
                  const float dts = e & 1 ? cs.w : cs.y;
                  const bool keep =
                      !diag || sa + (e & 1) <= (e < 2 ? ta : tb);
                  const float dec = keep ? ct - csum : 0.f;
                  w[e] = keep ? sacc[j][e] *
                                    attn_tc::exp2_approx(dec *
                                                         attn_tc::kLog2e) *
                                    dts
                              : 0.f;
                }
                split_pair(w[0], w[1], ah[2 * half], al[2 * half]);
                split_pair(w[2], w[3], ah[2 * half + 1], al[2 * half + 1]);
              }
#pragma unroll
              for (int jp = 0; jp < NP; jp += 2) {
                const int mi = lane / 8;
                const int row = c16 + lane % 8 + 8 * (mi % 2);
                const int col = 8 * jp + 8 * (mi / 2);
                uint32_t xf[4];
                ldmatrix_x4_trans(xf, smem_u32(Xt + row * LDP + col));
                mma_bf16(yacc[jp], ah, xf[0], xf[1]);
                mma_bf16(yacc[jp], al, xf[0], xf[1]);
                mma_bf16(yacc[jp + 1], ah, xf[2], xf[3]);
                mma_bf16(yacc[jp + 1], al, xf[2], xf[3]);
              }
            }
          }
        }
        // state += x'^T B_s, x' as hi + lo
        if (last && owns) {
#pragma unroll
          for (int k2 = 0; k2 < TS / 16; ++k2) {
            const int mi = lane / 8;
            uint32_t xh[4], xl[4];
            const int arow = 16 * k2 + lane % 8 + 8 * (mi / 2);
            const int acol = 16 * sm0 + 8 * (mi % 2);
            ldmatrix_x4_trans(xh, smem_u32(Xh + arow * LDP + acol));
            ldmatrix_x4_trans(xl, smem_u32(Xl + arow * LDP + acol));
#pragma unroll
            for (int i = 0; i < NPW; ++i) {
              const int brow_ = 16 * k2 + lane % 8 + 8 * ((lane / 8) % 2);
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1,
                                smem_u32(Bt + brow_ * LDN + 8 * (sn0 + i)));
              mma_bf16(st[i], xh, b0, b1);
              mma_bf16(st[i], xl, b0, b1);
            }
          }
        }
        __syncthreads();   // buffer buf and x' are free for the next tile
      }
      if (live) {
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          const int col = 8 * j + 2 * tq;
          if constexpr (PAD) {   // element stores below the slice's rows
            const __nv_bfloat162 va =
                __floats2bfloat162_rn(yacc[j][0], yacc[j][1]);
            const __nv_bfloat162 vb =
                __floats2bfloat162_rn(yacc[j][2], yacc[j][3]);
            bf16* ra = yb + (c0 + ta) * xrow + col;
            bf16* rb = yb + (c0 + tb) * xrow + col;
            if (ta < L && col < pr) ra[0] = __low2bfloat16(va);
            if (ta < L && col + 1 < pr) ra[1] = __high2bfloat16(va);
            if (tb < L && col < pr) rb[0] = __low2bfloat16(vb);
            if (tb < L && col + 1 < pr) rb[1] = __high2bfloat16(vb);
          } else {
            if (ta < L)
              *reinterpret_cast<__nv_bfloat162*>(yb + (c0 + ta) * xrow +
                                                 col) =
                  __floats2bfloat162_rn(yacc[j][0], yacc[j][1]);
            if (tb < L)
              *reinterpret_cast<__nv_bfloat162*>(yb + (c0 + tb) * xrow +
                                                 col) =
                  __floats2bfloat162_rn(yacc[j][2], yacc[j][3]);
          }
        }
      }
    }
    // the new state as hi + lo for the next chunk's state term; every warp
    // read the old one before the last tile's first barrier
    if (owns) {
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int pr = 16 * sm0 + g, nn = 8 * (sn0 + i) + 2 * tq;
        uint32_t hi, lo;
        split_pair(st[i][0], st[i][1], hi, lo);
        *reinterpret_cast<uint32_t*>(Sh + pr * LDN + nn) = hi;
        *reinterpret_cast<uint32_t*>(Sl + pr * LDN + nn) = lo;
        split_pair(st[i][2], st[i][3], hi, lo);
        *reinterpret_cast<uint32_t*>(Sh + (pr + 8) * LDN + nn) = hi;
        *reinterpret_cast<uint32_t*>(Sl + (pr + 8) * LDN + nn) = lo;
      }
    }
  }
}

template <int PB, int N, bool PAD>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, int B, int S, int H, int G, int P, int n,
           int L, int nsplit, cudaStream_t stream) {
  const size_t smem = Smem<PB, N>::bytes(L);
  auto kern = ssd_scan_tc_kernel<PB, N, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || S == 0) return int(cudaGetLastError());
  kern<<<unsigned(size_t(B) * H * nsplit), kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const bf16*>(b),
      static_cast<const bf16*>(c), static_cast<bf16*>(y), S, H, G, P, L,
      nsplit, n, (P + nsplit - 1) / nsplit);
  return int(cudaGetLastError());
}

}  // namespace tc

template <typename T, int PB, int N, bool PAD>
int launch(const void* x, const void* dt, const void* a, const void* b,
           const void* c, void* y, int B, int S, int H, int G, int P, int n,
           int L, int nsplit, cudaStream_t stream) {
  const size_t smem = smem_bytes<PB, N>(L);
  auto kern = ssd_scan_kernel<T, PB, N, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || S == 0) return int(cudaGetLastError());
  kern<<<unsigned(size_t(B) * H * nsplit), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), S, H, G, P, L, nsplit, n,
      (P + nsplit - 1) / nsplit);
  return int(cudaGetLastError());
}

// float32: the CUDA-core body; bfloat16: the tensor-core body
template <typename T, int PB, int N, bool PAD>
int route(const void* x, const void* dt, const void* a, const void* b,
          const void* c, void* y, int B, int S, int H, int G, int P, int n,
          int L, int nsplit, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value)
    return launch<float, PB, N, PAD>(x, dt, a, b, c, y, B, S, H, G, P, n, L,
                                     nsplit, s);
  else
    return tc::launch<PB, N, PAD>(x, dt, a, b, c, y, B, S, H, G, P, n, L,
                                  nsplit, s);
}

// N: the real state width, padded to 16, 32, 64 or 128 with PAD; PB the
// slice's padded rows
template <typename T, int PB, bool PAD>
int dispatch_n(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, int B, int S, int H, int G, int P,
               int N, int L, int nsplit, cudaStream_t s) {
  const int nw = PAD ? (N <= 16 ? 16 : N <= 32 ? 32 : N <= 64 ? 64 : 128)
                     : N;
  switch (nw) {
    case 16: return route<T, PB, 16, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                          N, L, nsplit, s);
    case 32: return route<T, PB, 32, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                          N, L, nsplit, s);
    case 64: return route<T, PB, 64, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                          N, L, nsplit, s);
    case 128: return route<T, PB, 128, PAD>(x, dt, a, b, c, y, B, S, H, G,
                                            P, N, L, nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// PB: the slice's rows, ceil(P / nsplit), padded to 16, 32 or 64 with PAD
template <typename T, bool PAD>
int dispatch(const void* x, const void* dt, const void* a, const void* b,
             const void* c, void* y, int B, int S, int H, int G, int P, int N,
             int L, int nsplit, cudaStream_t s) {
  const int pb = (P + nsplit - 1) / nsplit;
  const int pw = PAD ? (pb <= 16 ? 16 : pb <= 32 ? 32 : 64) : pb;
  switch (pw) {
    case 16: return dispatch_n<T, 16, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                           N, L, nsplit, s);
    case 32: return dispatch_n<T, 32, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                           N, L, nsplit, s);
    case 64: return dispatch_n<T, 64, PAD>(x, dt, a, b, c, y, B, S, H, G, P,
                                           N, L, nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace ssd_parts {
#if PART(1)
int padded_f32(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, int B, int S, int H, int G, int P,
               int N, int L, int nsplit, void* stream) {
  return dispatch<float, true>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                               nsplit, static_cast<cudaStream_t>(stream));
}
#endif
#if PART(2)
int padded_tc(const void* x, const void* dt, const void* a, const void* b,
              const void* c, void* y, int B, int S, int H, int G, int P,
              int N, int L, int nsplit, void* stream) {
  return dispatch<__nv_bfloat16, true>(x, dt, a, b, c, y, B, S, H, G, P, N,
                                       L, nsplit,
                                       static_cast<cudaStream_t>(stream));
}
#endif
}  // namespace ssd_parts

#if PART(0)
// x, b, c, y: dtype 0 = float32, 1 = bfloat16; dt and a float32. All
// contiguous, 16-byte aligned. P and N in 1 ... 128, ceil(P / nsplit) <=
// 64 with no slice empty, H % G == 0, S % L == 0. P / nsplit in {16, 32,
// 64} and N in {16, 32, 64, 128} run their exact instantiations, any
// other sizes the padded ones. Returns cudaGetLastError() after the
// launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y, int B,
                               int S, int H, int G, int P, int N, int L,
                               int nsplit, int dtype, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      S % L != 0 || nsplit <= 0 || P < 1 || P > 128 || N < 1 || N > 128 ||
      (P + nsplit - 1) / nsplit > 64 ||
      (nsplit - 1) * ((P + nsplit - 1) / nsplit) >= P ||
      size_t(B) * H * nsplit > 0x7fffffffu || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  const int pb = P / nsplit;
  const bool exact = P % nsplit == 0 && (pb == 16 || pb == 32 || pb == 64) &&
                     (N == 16 || N == 32 || N == 64 || N == 128);
  if (!exact)
    return dtype == 0
               ? ssd_parts::padded_f32(x, dt, a, b, c, y, B, S, H, G, P, N,
                                       L, nsplit, stream)
               : ssd_parts::padded_tc(x, dt, a, b, c, y, B, S, H, G, P, N,
                                      L, nsplit, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, false>(x, dt, a, b, c, y, B, S, H, G, P, N, L,
                                  nsplit, s);
  return dispatch<__nv_bfloat16, false>(x, dt, a, b, c, y, B, S, H, G, P, N,
                                        L, nsplit, s);
}
#endif
