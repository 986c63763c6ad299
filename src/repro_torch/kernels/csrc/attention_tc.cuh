// The bf16 tensor-core tile core shared by the dense flash kernel K5
// (flash_attention.cu) and the paged-prefill kernel K4
// (paged_attention.cu), for Hopper (sm_90a).
//
// attend_tc attends an M-row bf16 query tile (M = 16 x MB x warps) against
// a stream of K/V tiles of BK keys (64, or 32 where MB x D > 128, so that
// the output accumulator and the scores fit the registers without
// spilling), with an online softmax. The caller supplies the key-row source
// (contiguous rows for K5, table_row[col / page_size] for K4, looked up
// per key column so that any page size works) and the reach [lo, hi) of
// the tile.
//
// Row r of the tile is token r / hr, head r % hr of the block's kv head
// (GQA packing: the rep query heads of one kv head share every K/V tile
// read); a row is live when its token < ntok and its head < nh. Key column
// col sits at absolute position col; row r at pos0 + r / hr.
//
// Widths: the tile is instantiated at a padded width DP (a multiple of 16,
// the depth of an m16n8k16 product and the width of an ldmatrix.x4.trans
// of V) and, with PAD, takes the real head dim D <= DP at run time
// (TileArgs.d): the staging reads columns [0, D) and zero-fills the rest,
// so q.k is unchanged and the extra columns of P V are 0 and never stored.
// Where a row's D bf16 elements are whole 16-byte chunks (D % 8 == 0) the
// copies stay 16-byte cp.async ones, whole chunks past D zero-filled;
// otherwise rows are not 16-byte aligned and each chunk is assembled from
// element loads and stored to shared memory in the same layout. Without
// PAD (the exact widths 64, 128, 256) D is DP and the masks compile away.
//
// Design:
// - warp w owns MB blocks of 16 rows (at MB 2 each K or V fragment read
//   from shared memory feeds two products, which halves those reads per
//   product). S = Q K^T and O += P V are
//   mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 with A from
//   ldmatrix (Q; kept in registers at MB 1 and D <= 128) and B from
//   ldmatrix (K) or ldmatrix.trans (V). Accumulation is float32 in
//   registers. The S accumulator fragments are re-packed as the bf16 A
//   fragments of P V in registers (the C and A layouts of m16n8k16 agree
//   per thread); row max and row sum are shuffles within a quad of lanes;
// - K/V tiles come in through cp.async (16 B, .cg), double-buffered, so
//   tile j + 1 is in flight while tile j is multiplied; one barrier per
//   tile. Shared rows are padded to D + 8 elements (16 B), so the eight
//   rows an ldmatrix phase reads fall in distinct banks. Key rows at or
//   past nkeys are zero-filled by the copy itself (src-size 0): junk past
//   Sk or past a slot's length (a NaN-poisoned scratch page) is never read;
// - the mask (key < nkeys; causal: key <= pos and pos - key < window) is
//   applied only on tiles that some (row, key) pair of the tile can fail.
//
// Numerics (the same function as the TPU kernels, in another order):
// - scores are bf16 x bf16 products summed in float32, times D^-0.5
//   log2(e) (the softmax in base 2, ex2.approx: ~2^-22 relative), or with a
//   softcap cap log2(e) tanhf(s D^-0.5 / cap): tanhf and not
//   tanh.approx.f32, which errs by ~2^-11, ~0.024 at a cap of 50;
// - masked scores are -1e30 by select, never -inf (-inf - -inf is NaN): a
//   row still fully masked gets p = 1 until a live key sets its max, and
//   then a weight of exp2(-1e30 - m) = 0 wipes that junk;
// - p is rounded to bf16 for the P V product (one rounding the float32
//   TPU kernel does not make: ~2^-9 relative per weight, below the
//   output's own bf16 rounding) and the row sum l adds the same rounded
//   weights, so the output is a convex combination of V rows;
// - the output is acc / max(l, 1e-30), rounded to bf16.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace attn_tc {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// keys per K/V tile: 64, or 32 where the float32 accumulators of a warp's
// rows (MB x 16 x D) would leave too few registers for 64 keys of scores
// (every width above the 128 of D 64 at MB 2 and D 128 at MB 1)
template <int D, int MB>
struct Tile {
  static constexpr int BK = D * MB > 128 ? 32 : 64;
  static constexpr int LD = D + 8;                // padded shared row
};

// dynamic shared memory of attend_tc<D, NW, MB, PAD>: the Q tile and two K/V
// tiles
template <int D, int NW, int MB>
constexpr size_t smem_bytes() {
  return size_t(16 * MB * NW + 4 * Tile<D, MB>::BK) * Tile<D, MB>::LD *
         sizeof(bf16);
}

struct TileArgs {
  const bf16* q;      // token 0, head 0 of the tile
  bf16* out;          // same layout as q
  size_t tok_stride;  // elements from one token to the next (Hq * D)
  int hr;             // rows per token (heads of the kv head in the block)
  int nh;             // live heads among them
  int ntok;           // live tokens in the tile
  int pos0;           // absolute position of token 0
  int nkeys;          // key rows [0, nkeys) exist
  int lo, hi;         // reach of the tile's live rows: keys [lo, hi)
  int d;              // the real head dim (<= the instantiated width)
  int causal;
  int window;         // <= 0: none (read only when causal)
  float softcap;      // <= 0: none
  float scale;        // D^-0.5
};

// K5: key row col of one (batch, kv head) in a (B, Sk, Hkv, D) tensor
struct DenseKeys {
  size_t base, stride;
  __device__ __forceinline__ size_t operator()(int col) const {
    return base + size_t(col) * stride;
  }
};

// K4: key row col of one slot and kv head in (P, page, Hkv, D) pools
struct PagedKeys {
  const int* table_row;
  int page_size;
  size_t head, stride;
  __device__ __forceinline__ size_t operator()(int col) const {
    return (size_t(table_row[col / page_size]) * page_size +
            col % page_size) * stride + head;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (MUFU.EX2; 2^-1e30 = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half; adds the rounded
// values to sum
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi,
                                              float& sum) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  sum += __low2float(h) + __high2float(h);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// f(row, chunk) for every 16-byte chunk of a ROWS-row tile of CH chunks a
// row, each once across the block's NT threads: thread t takes chunk t % CH
// of rows t / CH, t / CH + NT / CH, ... where NT % CH == 0 (every exact
// width), else the pairs t, t + NT, ... of the flattened tile
template <int ROWS, int CH, int NT, typename F>
__device__ __forceinline__ void for_chunks(F&& f) {
  if constexpr (NT % CH == 0) {
    const int cc = threadIdx.x % CH;
    for (int r = threadIdx.x / CH; r < ROWS; r += NT / CH) f(r, cc);
  } else {
    for (int i = threadIdx.x; i < ROWS * CH; i += NT) f(i / CH, i % CH);
  }
}

// chunk cc (elements 8 cc .. 8 cc + 7) of a row of D elements at src into
// shared memory at dst: a 16-byte cp.async when vec (src 16-byte aligned
// and D % 8 == 0; chunks past D zero-filled by the copy), else element
// loads past which zeros are stored, as one 16-byte store; ok false
// zero-fills the chunk
__device__ __forceinline__ void copy_chunk(bf16* dst, const bf16* src, int cc,
                                           int D, bool ok, bool vec) {
  if (vec) {
    const bool in = ok && cc * 8 < D;
    cp_async16(smem_u32(dst), in ? src + cc * 8 : src, in);
  } else {
    __align__(16) bf16 e[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = ok && cc * 8 + i < D ? src[cc * 8 + i] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
  }
}

template <int DP, int NW, int MB, bool PAD, typename Keys>
__device__ __forceinline__ void attend_tc(const TileArgs& a,
                                          const bf16* __restrict__ k,
                                          const bf16* __restrict__ v,
                                          const Keys& keys) {
  constexpr int NT = 32 * NW;           // threads
  constexpr int WR = 16 * MB;           // rows per warp
  constexpr int M = WR * NW;            // query rows
  constexpr int BK = Tile<DP, MB>::BK;
  constexpr int LD = Tile<DP, MB>::LD;
  constexpr int CH = DP / 8;            // 16-byte chunks per row
  constexpr int NS = BK / 8;            // 8-key score fragments per row
  constexpr int NO = DP / 8;            // 8-dim output fragments per row
  constexpr bool kQRegs = DP <= 128 && MB == 1;  // Q held in registers
  static_assert(DP % 16 == 0, "whole k16 steps and ldmatrix.x4 tiles");
  static_assert(PAD || NT % CH == 0, "a pass of the copy covers whole rows");
  const int D = PAD ? a.d : DP;         // the real head dim
  extern __shared__ __align__(16) unsigned char attn_tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(attn_tc_smem);   // M x LD
  bf16* Ks = Qs + M * LD;                             // 2 x BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                        // 2 x BK x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int cc = tid % CH;              // this thread's chunk of a row

  if constexpr (PAD) {
    for_chunks<M, CH, NT>([&](int r, int c) {
      const int t = r / a.hr, j = r % a.hr;
      const bool ok = t < a.ntok && j < a.nh;
      copy_chunk(Qs + r * LD + c * 8,
                 ok ? a.q + size_t(t) * a.tok_stride + j * D : a.q, c, D,
                 ok, D % 8 == 0);
    });
  } else {
    for (int r = tid / CH; r < M; r += NT / CH) {
      const int t = r / a.hr, j = r % a.hr;
      const bool ok = t < a.ntok && j < a.nh;
      const bf16* src = ok ? a.q + size_t(t) * a.tok_stride + j * D + cc * 8
                           : a.q;
      cp_async16(smem_u32(Qs + r * LD + cc * 8), src, ok);
    }
  }
  auto load_kv = [&](int k0, int buf) {
    bf16* kd = Ks + buf * BK * LD;
    bf16* vd = Vs + buf * BK * LD;
    if constexpr (PAD) {
      for_chunks<BK, CH, NT>([&](int r, int c) {
        const int col = k0 + r;
        const bool ok = col < a.nkeys;
        const size_t off = ok ? keys(col) : 0;
        copy_chunk(kd + r * LD + c * 8, k + off, c, D, ok, D % 8 == 0);
        copy_chunk(vd + r * LD + c * 8, v + off, c, D, ok, D % 8 == 0);
      });
    } else {
      for (int r = tid / CH; r < BK; r += NT / CH) {
        const int col = k0 + r;
        const bool ok = col < a.nkeys;
        const size_t off = ok ? keys(col) + cc * 8 : 0;
        cp_async16(smem_u32(kd + r * LD + cc * 8), k + off, ok);
        cp_async16(smem_u32(vd + r * LD + cc * 8), v + off, ok);
      }
    }
  };

  const int kfirst = (a.lo / BK) * BK;
  const int ntiles = a.hi > a.lo ? (a.hi - kfirst + BK - 1) / BK : 0;
  if (ntiles > 0) load_kv(kfirst, 0);
  cp_async_commit();

  const bool capped = a.softcap > 0.f;
  const float pre = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float post = capped ? a.softcap * kLog2e : 1.f;
  // this thread's rows: row + 16 i + 8 h for m-block i < MB and h < 2
  const int row = warp * WR + g;
  int pos[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pos[i][h] = a.pos0 + (row + 16 * i + 8 * h) / a.hr;

  float o[MB][NO][4], m[MB][2], l[MB][2];
#pragma unroll
  for (int i = 0; i < MB; ++i) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][n][e] = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[i][h] = kNegInf;
      l[i][h] = 0.f;
    }
  }
  uint32_t qf[kQRegs ? DP / 16 : 1][4];

  // ldmatrix lane offsets: A (Q) rows lane % 16, columns 8 (lane / 16);
  // B (K) keys lane % 8 + 8 (lane / 16), dims 8 ((lane / 8) % 2);
  // B (V, transposed) keys lane % 8 + 8 ((lane / 8) % 2), dims 8 (lane / 16)
  const uint32_t q_addr =
      smem_u32(Qs + (warp * WR + lane % 16) * LD + (lane / 16) * 8);
  const int k_lane = (lane % 8 + (lane / 16) * 8) * LD + ((lane / 8) % 2) * 8;
  const int v_lane = (lane % 8 + ((lane / 8) % 2) * 8) * LD + (lane / 16) * 8;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kfirst + it * BK;
    const int buf = it & 1;
    cp_async_wait<0>();                 // this thread's copies of tile it
    // tile it (and Q) visible to all; every warp is done with tile it - 1,
    // so its buffer takes tile it + 1, in flight while tile it is used
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv(k0 + BK, buf ^ 1);
      cp_async_commit();
    }
    const uint32_t kt = smem_u32(Ks + buf * BK * LD + k_lane);
    const uint32_t vt = smem_u32(Vs + buf * BK * LD + v_lane);
    if (kQRegs && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? DP / 16 : 1); ++kk)
        ldmatrix_x4(qf[kk], q_addr + kk * 32);
    }

    // S = Q K^T: s[i][n] holds keys 8n .. 8n + 7 of m-block i's rows
    float s[MB][NS][4];
#pragma unroll
    for (int i = 0; i < MB; ++i)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t af[MB][4];
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        if constexpr (kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) af[i][e] = qf[kk][e];
        } else {
          ldmatrix_x4(af[i], q_addr + (i * 16 * LD + kk * 16) * 2);
        }
      }
#pragma unroll
      for (int nn = 0; nn < BK / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4(b, kt + (nn * 16 * LD + kk * 16) * 2);
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          mma_bf16(s[i][2 * nn], af[i], b[0], b[1]);
          mma_bf16(s[i][2 * nn + 1], af[i], b[2], b[3]);
        }
      }
    }

    // scale (base 2), softcap, mask
    if (capped) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[i][n][e] = post * tanhf(s[i][n][e] * pre);
    } else {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][n][e] *= pre;
    }
    const bool edge =
        k0 + BK > a.nkeys ||
        (a.causal && (k0 + BK - 1 > a.pos0 ||
                      (a.window > 0 && k0 < a.pos0 + a.ntok - a.window)));
    if (edge) {
#pragma unroll
      for (int i = 0; i < MB; ++i)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + 8 * n + 2 * tq + (e & 1);
            const int p = pos[i][e >> 1];
            bool ok = col < a.nkeys;
            if (a.causal)
              ok = ok && col <= p && (a.window <= 0 || p - col < a.window);
            s[i][n][e] = ok ? s[i][n][e] : kNegInf;
          }
    }

    // online softmax: row max over the quad, rescale l and O; then P in
    // bf16, re-packed from the S fragments as the A fragments of P V:
    // pf[i][kk] = keys 16kk .. 16kk + 15 = score fragments 2kk, 2kk + 1
    uint32_t pf[MB][BK / 16][4];
#pragma unroll
    for (int i = 0; i < MB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mx = fmaxf(mx, fmaxf(s[i][n][2 * h], s[i][n][2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i][h], mx);
        const float alpha = exp2_approx(m[i][h] - m_new);
        m[i][h] = m_new;
        l[i][h] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[i][n][2 * h] *= alpha;
          o[i][n][2 * h + 1] *= alpha;
        }
      }
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        pf[i][n / 2][(n % 2) * 2] = pack_bf16(
            exp2_approx(s[i][n][0] - m[i][0]),
            exp2_approx(s[i][n][1] - m[i][0]), l[i][0]);
        pf[i][n / 2][(n % 2) * 2 + 1] = pack_bf16(
            exp2_approx(s[i][n][2] - m[i][1]),
            exp2_approx(s[i][n][3] - m[i][1]), l[i][1]);
      }
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nn = 0; nn < DP / 16; ++nn) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 * LD + nn * 16) * 2);
#pragma unroll
        for (int i = 0; i < MB; ++i) {
          mma_bf16(o[i][2 * nn], pf[i][kk], b[0], b[1]);
          mma_bf16(o[i][2 * nn + 1], pf[i][kk], b[2], b[3]);
        }
      }
  }
  cp_async_wait<0>();
  __syncthreads();                      // Q copies landed before reuse

  // epilogue: O / l in bf16, staged in the warp's own Q rows, then 16-byte
  // stores of the live rows (with PAD: the columns below D, element by
  // element where rows are not 16-byte aligned)
#pragma unroll
  for (int i = 0; i < MB; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[i][h];
      lh += __shfl_xor_sync(0xffffffffu, lh, 1);
      lh += __shfl_xor_sync(0xffffffffu, lh, 2);
      const float inv = 1.f / fmaxf(lh, 1e-30f);
      bf16* dst = Qs + (row + 16 * i + 8 * h) * LD + 2 * tq;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(o[i][n][2 * h] * inv,
                                  o[i][n][2 * h + 1] * inv);
    }
  __syncwarp();
  for (int i = lane; i < WR * CH; i += 32) {
    const int r = warp * WR + i / CH, c = i % CH;
    const int t = r / a.hr, j = r % a.hr;
    if constexpr (PAD) {
      if (!(t < a.ntok && j < a.nh)) continue;
      bf16* dst = a.out + size_t(t) * a.tok_stride + j * D + c * 8;
      const bf16* src = Qs + r * LD + c * 8;
      if (D % 8 == 0) {
        if (c * 8 < D)
          *reinterpret_cast<uint4*>(dst) =
              *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && c * 8 + e < D; ++e) dst[e] = src[e];
      }
    } else {
      if (t < a.ntok && j < a.nh)
        *reinterpret_cast<uint4*>(a.out + size_t(t) * a.tok_stride + j * D +
                                  c * 8) =
            *reinterpret_cast<const uint4*>(Qs + r * LD + c * 8);
    }
  }
}

}  // namespace attn_tc
