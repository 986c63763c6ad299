// The float32 tile core shared by the dense flash kernel K5
// (flash_attention.cu) and the paged-prefill kernel K4
// (paged_attention.cu) for float32 inputs, on Hopper's CUDA cores (sm_90a):
// the float32 counterpart of attention_tc.cuh, with its interface
// (TileArgs over float, the same DenseKeys / PagedKeys key-row sources).
//
// attend_f32 attends a 64-row float32 query tile (a block of 4 warps)
// against a stream of K/V tiles of BK keys with an online softmax. The
// caller supplies the key-row source (contiguous rows for K5,
// table_row[col / page_size] for K4, looked up per key column so that any
// page size works) and the reach [lo, hi) of the tile. Row r of the tile
// is token r / hr, head r % hr of the block's kv head (GQA packing: the hr
// query heads of one kv head share every K/V tile read); a row is live
// when its token < ntok and its head < nh. Key column col sits at
// absolute position col; row r at pos0 + r / hr.
//
// Widths: the tile is instantiated at a padded width DP (64, 128 and 256
// exact; otherwise a multiple of 32, since a lane owns DP / 8 output dims
// as float4s) and, with PAD, takes the real head dim D <= DP at run time
// (TileArgs.d): the staging reads columns [0, D) and zero-fills the rest,
// so q.k is unchanged and the extra columns of P V are 0 and never stored.
// Where D % 4 == 0 rows are whole 16-byte chunks and the copies stay
// cp.async ones (chunks past D zero-filled); otherwise each chunk is
// assembled from element loads and stored in the same layout.
//
// Design (all arithmetic float32 FMAs on the CUDA cores):
// - warp w owns rows 16 w .. 16 w + 15 for the whole key loop: its lanes
//   form 4 row groups g x 8 column groups j, lane (g, j) holding rows
//   g + 4 r (r < 4) against key columns j + 8 i (i < BK / 8) of S and dims
//   4 j + 32 c .. + 3 (c < DP / 32) of O, in registers (a 4 x 8 or 4 x 4
//   block of S and a 4 x DP / 8 block of O). S = Q K^T reads float4s of Q
//   and K rows; K and V rows are padded to DP + 4 floats, so the 8 key rows
//   (or the 4 query rows) one float4 load of a warp touches fall in
//   distinct banks. P goes to the warp's own rows of a shared P tile (rows
//   padded to BK + 8 floats: the scalar stores of a warp hit 32 distinct
//   banks), read back as float4s for O += P V: a __syncwarp, no block
//   barrier. Row max and row sum are shuffles among the 8 lanes of a row
//   group (the sum only once, at the end). A warp whose rows all lie past
//   the tile's tokens only copies and waits;
// - K/V tiles come in through cp.async (16 B, .cg), double-buffered, so
//   tile j + 1 is in flight while tile j is computed; one block barrier per
//   tile. Lane i of each warp looks up key rows i and i + 32 of a tile at
//   once, and the copying lanes take a row's offset by shuffle, so a
//   tile's page-table reads are in flight together. Key rows at or past
//   nkeys are zero-filled by the copy itself (src-size 0): junk past Sk or
//   past a slot's length (a NaN-poisoned scratch page) is never read;
// - the key loop is bounded by the tile's reach [lo, hi) (the TPU kernel's
//   pl.when(reachable)), the callers schedule heavy causal tiles first, and
//   the mask (key < nkeys; causal: key <= pos and pos - key < window) is
//   applied only on tiles that some (row, key) pair of the tile can fail;
// - a key split for grids under a wave (splits > 1, a thread-block cluster
//   of 2, 4 or 8 blocks on one tile, launch()): block q walks key tiles
//   [q n / S, (q + 1) n / S) of the reach's n, leaves (O, m, l) in its
//   K/V tiles, and after a cluster barrier combines rows [q 64 / S, (q +
//   1) 64 / S) over the blocks in rank order through distributed shared
//   memory, so one launch gives the same bits every time (K3's combine).
//   Splitting keys, and not shortening tiles, is the answer to a small
//   grid: a block's K/V copies cost the same whatever its rows, and on the
//   card 64-row tiles beat 32- and 16-row ones at every shape tried during
//   this design, grids under a wave included.
//
// Numerics (the same function as the TPU kernels, in another order):
// - scores are float32 dot products summed in float32 FMAs in dim order
//   (no TF32, no 3xTF32), times D^-0.5 log2(e) (the softmax in base 2,
//   exp2f: <= 2 ulp, as accurate as the expf it replaced), or with a
//   softcap cap log2(e) tanhf(s D^-0.5 / cap);
// - masked scores are -1e30 by select, never -inf (-inf - -inf is NaN): a
//   row still fully masked gets p = 1 until a live key sets its max, and
//   then a weight of exp2(-1e30 - m) = 0 wipes that junk;
// - the output is acc / max(l, 1e-30), a true division; a split sums its
//   blocks' (acc, l) in rank order first.
//
// Bound: 4 D float32 operations per reachable (row, key) pair against 67
// TFLOP/s outside the tensor cores, or the bytes of q, k, v and out,
// whichever is larger (chip_smoke.py's float32 rows print the time
// against it). A 4 x 4 block of S (BK 32) loads 4 + 4 float4s for 64 FMAs,
// which the shared memory's 128 bytes a clock cannot feed at the FMA rate.
// What it leaves: wider register tiles (4 x 8 of S at BK 64 needs one V
// buffer and 8 warps a block to keep two blocks' worth of warps on an SM),
// one block of 4 warps per SM past DP 128 (the Q tile takes 66 KB at DP
// 256), and the diagonal tiles' masked half.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_tc.cuh"

namespace attn_f32 {

namespace cg = cooperative_groups;

using attn_tc::DenseKeys;
using attn_tc::PagedKeys;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;               // query rows a block: 16 a warp
constexpr int kThreads = 128;
constexpr int kMaxSplits = 8;           // blocks of a cluster (portable)

// keys per K/V tile: 64 up to DP 64, else 32 (two blocks of 4 warps an SM
// up to DP 128); a lane's key columns (SC) and output dims (OC); the
// 4-warp blocks an SM holds by shared memory (the kernels' launch bounds,
// which cap the registers so that they fit too)
template <int DP>
struct Tile {
  static constexpr int BK = DP <= 64 ? 64 : 32;
  static constexpr int SC = BK / 8;
  static constexpr int OC = DP / 8;
  static constexpr int LD = DP + 4;     // padded Q, K, V row (floats)
  static constexpr int LDP = BK + 8;    // padded P row (floats)
  static constexpr int kMinBlocks = DP <= 32 ? 3 : DP <= 128 ? 2 : 1;
};

// dynamic shared memory of attend_f32<DP, PAD>: two K/V tiles (after the
// key loop, a split's partial O, m and l), the Q tile and the P tile
template <int DP>
constexpr size_t smem_bytes() {
  static_assert(kRows * (DP + 2) <= 4 * Tile<DP>::BK * Tile<DP>::LD,
                "the partials fit the K/V tiles");
  return (size_t(4 * Tile<DP>::BK) * Tile<DP>::LD +
          size_t(kRows) * (Tile<DP>::LD + Tile<DP>::LDP)) * sizeof(float);
}

struct TileArgs {
  const float* q;     // token 0, head 0 of the tile
  float* out;         // same layout as q
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
  int splits;         // blocks of the cluster splitting [lo, hi) (1: none)
};

// chunk c (elements 4 c .. 4 c + 3) of a row of D floats at src into shared
// memory at dst: a 16-byte cp.async when vec (D % 4 == 0; chunks past D
// zero-filled by the copy), else element loads past which zeros are stored,
// as one 16-byte store; ok false zero-fills the chunk
__device__ __forceinline__ void copy_chunk(float* dst, const float* src,
                                           int c, int D, bool ok, bool vec) {
  if (vec) {
    const bool in = ok && c * 4 < D;
    attn_tc::cp_async16(attn_tc::smem_u32(dst), in ? src + c * 4 : src, in);
  } else {
    float4 e;
    e.x = ok && c * 4 < D ? src[c * 4] : 0.f;
    e.y = ok && c * 4 + 1 < D ? src[c * 4 + 1] : 0.f;
    e.z = ok && c * 4 + 2 < D ? src[c * 4 + 2] : 0.f;
    e.w = ok && c * 4 + 3 < D ? src[c * 4 + 3] : 0.f;
    *reinterpret_cast<float4*>(dst) = e;
  }
}

__device__ __forceinline__ float fma4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// kern<<<(grid.x * splits, grid.y), kThreads, smem, stream>>>(args...),
// the blocks along x in clusters of `splits` when splits > 1; when
// `empty` only the shared-memory attribute is set. Returns the launch's
// error.
template <typename... KArgs, typename... Args>
int launch(void (*kern)(KArgs...), dim3 grid, int splits, size_t smem,
           cudaStream_t stream, bool empty, Args... args) {
  if (splits != 1 && splits != 2 && splits != 4 && splits != kMaxSplits)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (empty) return int(cudaGetLastError());
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid.x * splits, grid.y, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kern, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

template <int DP, bool PAD, typename Keys>
__device__ __forceinline__ void attend_f32(const TileArgs& a,
                                           const float* __restrict__ k,
                                           const float* __restrict__ v,
                                           const Keys& keys) {
  using T = Tile<DP>;
  constexpr int BK = T::BK, SC = T::SC, OC = T::OC, LD = T::LD;
  constexpr int LDP = T::LDP;
  constexpr int CH = DP / 4;            // 16-byte chunks per row
  static_assert(DP % 32 == 0, "a lane owns DP / 8 dims as float4s");
  const int D = PAD ? a.d : DP;         // the real head dim
  const bool vec = !PAD || D % 4 == 0;
  extern __shared__ __align__(16) float attn_f32_smem[];
  float* Ks = attn_f32_smem;            // 2 x BK x LD
  float* Vs = Ks + 2 * BK * LD;         // 2 x BK x LD
  float* Qs = Vs + 2 * BK * LD;         // kRows x LD
  float* Ps = Qs + kRows * LD;          // kRows x LDP

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 8, j = lane % 8;  // row group, column group

  for (int i = tid; i < kRows * CH; i += kThreads) {
    const int r = i / CH, c = i % CH;
    const int t = r / a.hr, h = r % a.hr;
    const bool ok = t < a.ntok && h < a.nh;
    copy_chunk(Qs + r * LD + c * 4,
               ok ? a.q + size_t(t) * a.tok_stride + h * D : a.q, c, D, ok,
               vec);
  }
  // K/V rows [k0, k0 + BK) into buffer buf: lane i of every warp looks up
  // the offsets of rows i and i + 32 (all of a tile's table reads in flight
  // at once, -1 at or past nkeys); a warp copies RW rows at a time, CW (a
  // power of two) lanes a row, each row's offset taken by shuffle
  constexpr int CW = CH >= 32 ? 32 : CH >= 16 ? 16 : 8;
  constexpr int RW = 32 / CW;
  auto load_kv = [&](int k0, int buf) {
    float* kd = Ks + buf * BK * LD;
    float* vd = Vs + buf * BK * LD;
    long long off[BK / 32];
#pragma unroll
    for (int h = 0; h < BK / 32; ++h) {
      const int col = k0 + 32 * h + lane;
      off[h] = col < a.nkeys ? static_cast<long long>(keys(col)) : -1;
    }
    for (int r0 = warp * RW; r0 < BK; r0 += (kThreads / 32) * RW) {
      const int r = r0 + lane / CW;
      const long long o = __shfl_sync(
          0xffffffffu, BK > 32 && r0 >= 32 ? off[BK / 32 - 1] : off[0],
          r % 32);
      const bool ok = o >= 0;
      for (int c = lane % CW; c < CH; c += CW) {
        copy_chunk(kd + r * LD + c * 4, ok ? k + o : k, c, D, ok, vec);
        copy_chunk(vd + r * LD + c * 4, ok ? v + o : v, c, D, ok, vec);
      }
    }
  };

  // the reach's key tiles; block q of a split takes tiles [q n / S,
  // (q + 1) n / S) of them (none when n < S)
  int kfirst = (a.lo / BK) * BK;
  int ntiles = a.hi > a.lo ? (a.hi - kfirst + BK - 1) / BK : 0;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = a.splits > 1 ? int(cluster.block_rank()) : 0;
  if (a.splits > 1) {
    const int t0 = rank * ntiles / a.splits;
    kfirst += t0 * BK;
    ntiles = (rank + 1) * ntiles / a.splits - t0;
  }
  if (ntiles > 0) load_kv(kfirst, 0);
  attn_tc::cp_async_commit();

  const bool capped = a.softcap > 0.f;
  const float pre = capped ? a.scale / a.softcap : a.scale * kLog2e;
  const float post = capped ? a.softcap * kLog2e : 1.f;
  // this lane's rows: row0 + 4 r; their positions
  const int row0 = warp * 16 + g;
  int pos[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) pos[r] = a.pos0 + (row0 + 4 * r) / a.hr;

  float o[4][OC], m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int e = 0; e < OC; ++e) o[r][e] = 0.f;
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const float* qrow = Qs + row0 * LD;         // + 4 r LD: row r
  float* prow = Ps + row0 * LDP;              // + 4 r LDP: row r
  // a warp whose rows all sit past the tile's tokens (a ragged last tile,
  // a short chunk) computes nothing
  const bool live = warp * 16 / a.hr < a.ntok;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kfirst + it * BK;
    const int buf = it & 1;
    attn_tc::cp_async_wait<0>();        // this thread's copies of tile it
    // tile it (and Q) visible to all; every warp is done with tile it - 1,
    // so its buffer takes tile it + 1, in flight while tile it is used
    __syncthreads();
    if (it + 1 < ntiles) {
      load_kv(k0 + BK, buf ^ 1);
      attn_tc::cp_async_commit();
    }
    if (!live) continue;                // the copies and barriers only
    const float* kt = Ks + buf * BK * LD + j * LD;   // + 8 i LD: column i
    const float* vt = Vs + buf * BK * LD + 4 * j;    // + n LD + 32 c

    // S = Q K^T: s[r][i] is row row0 + 4 r against key k0 + j + 8 i
    float s[4][SC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int i = 0; i < SC; ++i) s[r][i] = 0.f;
#pragma unroll 4
    for (int e = 0; e < DP; e += 4) {
      float4 qv[4], kv[SC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qrow + 4 * r * LD + e);
#pragma unroll
      for (int i = 0; i < SC; ++i)
        kv[i] = *reinterpret_cast<const float4*>(kt + 8 * i * LD + e);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i) s[r][i] = fma4(qv[r], kv[i], s[r][i]);
    }

    // scale (base 2), softcap, mask
    if (capped) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i) s[r][i] = post * tanhf(s[r][i] * pre);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i) s[r][i] *= pre;
    }
    const bool edge =
        k0 + BK > a.nkeys ||
        (a.causal && (k0 + BK - 1 > a.pos0 ||
                      (a.window > 0 && k0 < a.pos0 + a.ntok - a.window)));
    if (edge) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < SC; ++i) {
          const int col = k0 + j + 8 * i;
          bool ok = col < a.nkeys;
          if (a.causal)
            ok = ok && col <= pos[r] &&
                 (a.window <= 0 || pos[r] - col < a.window);
          s[r][i] = ok ? s[r][i] : kNegInf;
        }
    }

    // online softmax: the row max over the 8 lanes of the row group,
    // rescale O and this lane's part of l, then P to the warp's rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int i = 0; i < SC; ++i) mx = fmaxf(mx, s[r][i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < SC; ++i) {
        const float p = exp2f(s[r][i] - m_new);
        sum += p;
        prow[4 * r * LDP + j + 8 * i] = p;
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int e = 0; e < OC; ++e) o[r][e] *= alpha;
    }
    __syncwarp();                       // the warp's P rows written

    // O += P V: o[r][4 c + e] is dim 4 j + 32 c + e of row row0 + 4 r
#pragma unroll 2
    for (int n = 0; n < BK; n += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(prow + 4 * r * LDP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < OC / 4; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vt + (n + nn) * LD + 32 * c);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float p = nn == 0 ? pv[r].x : nn == 1 ? pv[r].y
                            : nn == 2 ? pv[r].z : pv[r].w;
            o[r][4 * c] = fmaf(p, vv.x, o[r][4 * c]);
            o[r][4 * c + 1] = fmaf(p, vv.y, o[r][4 * c + 1]);
            o[r][4 * c + 2] = fmaf(p, vv.z, o[r][4 * c + 2]);
            o[r][4 * c + 3] = fmaf(p, vv.w, o[r][4 * c + 3]);
          }
        }
      }
    }
  }
  attn_tc::cp_async_wait<0>();          // no copy in flight at exit
#pragma unroll
  for (int r = 0; r < 4; ++r) {         // l summed over the row group
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 4);
  }
  // out[row][d0 .. d0 + 3] = y (with PAD, the dims below D; element by
  // element where rows are not 16-byte aligned), live rows only
  auto store = [&](int rr, int d0, float4 y) {
    const int t = rr / a.hr, h = rr % a.hr;
    if (!(t < a.ntok && h < a.nh)) return;
    float* dst = a.out + size_t(t) * a.tok_stride + h * D + d0;
    if (!PAD || (vec && d0 < D)) {
      *reinterpret_cast<float4*>(dst) = y;
    } else if (!vec) {
      if (d0 < D) dst[0] = y.x;
      if (d0 + 1 < D) dst[1] = y.y;
      if (d0 + 2 < D) dst[2] = y.z;
      if (d0 + 3 < D) dst[3] = y.w;
    }
  };

  if (a.splits == 1) {                  // O / l from registers
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int c = 0; c < OC / 4; ++c)
        store(row0 + 4 * r, 4 * j + 32 * c,
              make_float4(o[r][4 * c] / den, o[r][4 * c + 1] / den,
                          o[r][4 * c + 2] / den, o[r][4 * c + 3] / den));
    }
    return;
  }
  // a split: each block leaves its partial (O unnormalised, m, l) in the
  // K/V tiles; block q combines rows [q R, q R + R) (R = kRows / S) over
  // the cluster's blocks in rank order, read through distributed shared
  // memory, so the bits repeat: M = max m_s, L = sum l_s 2^(m_s - M),
  // O = sum O_s 2^(m_s - M), out = O / max(L, 1e-30)
  __syncthreads();                      // every warp done with the tiles
  float* part = Ks;                     // kRows x DP, then m, l
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int rr = row0 + 4 * r;
#pragma unroll
    for (int c = 0; c < OC / 4; ++c)
      *reinterpret_cast<float4*>(part + rr * DP + 4 * j + 32 * c) =
          make_float4(o[r][4 * c], o[r][4 * c + 1], o[r][4 * c + 2],
                      o[r][4 * c + 3]);
    if (j == 0) {
      part[kRows * DP + rr] = m[r];
      part[kRows * DP + kRows + rr] = l[r];
    }
  }
  cluster.sync();                       // every block's partial written
  const int R = kRows / a.splits;
  for (int i = tid; i < R * (DP / 4); i += kThreads) {
    const int rr = rank * R + i / (DP / 4), d0 = 4 * (i % (DP / 4));
    float mx = kNegInf;
    for (int q = 0; q < a.splits; ++q)
      mx = fmaxf(mx, cluster.map_shared_rank(part, q)[kRows * DP + rr]);
    float den = 0.f;
    float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < a.splits; ++q) {
      const float* pq = cluster.map_shared_rank(part, q);
      const float w = exp2f(pq[kRows * DP + rr] - mx);
      den = fmaf(pq[kRows * DP + kRows + rr], w, den);
      const float4 oq = *reinterpret_cast<const float4*>(pq + rr * DP + d0);
      y.x = fmaf(oq.x, w, y.x);
      y.y = fmaf(oq.y, w, y.y);
      y.z = fmaf(oq.z, w, y.z);
      y.w = fmaf(oq.w, w, y.w);
    }
    den = fmaxf(den, 1e-30f);
    store(rr, d0, make_float4(y.x / den, y.y / den, y.z / den, y.w / den));
  }
  cluster.sync();                       // partials read before any exit
}

}  // namespace attn_f32
