// Paged-attention decode (K3) and chunked-prefill (K4) kernels for Hopper
// (sm_90a), bound to Python through a plain C interface loaded with ctypes
// (repro_torch/kernels/build.py).
//
// K3 paged_decode_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::_kernel (pallas_call in
//   paged_attention, line 177).
// K4 paged_prefill_kernel replaces
//   src/repro/kernels/paged_attention.py::_prefill_kernel (pallas_call in
//   paged_prefill, line 376).
//
// What they compute (the same as their TPU kernels and as the twins
// paged_decode_ref / paged_prefill_ref in paged_attention.py): attention of
// q rows against K/V read in place from page pools (P, page, Hkv, D)
// through a block table, online softmax (m, l, acc) over the pages, GQA
// (the rep = Hq/Hkv query heads of one kv head share every page read),
// scores in float32 scaled by D^-0.5, then softcap, then the causal and
// sliding-window band; masked V is zeroed by a select (or zero-filled by
// the copy) so NaN or garbage in unwritten page tails (the scratch page
// included) never reaches an output. The output is acc / max(l, 1e-30) in
// the q dtype.
//
// K3, paged_decode_kernel (one body for float32 and bfloat16 pools):
// - split-K: each live slot's reach [first, length) (first = length -
//   window under a sliding window, else 0) is cut into kSplits = 8 equal
//   key ranges, one block each; the 8 blocks of one (slot, kv head) form a
//   thread-block cluster (grid (8, Hkv, B), __cluster_dims__(8, 1, 1)). At
//   8 slots and Hkv 8 that is 512 blocks of 8 warps on 132 SMs (64 for
//   one slot);
// - inside a block each warp walks its own contiguous run of chunks of KT
//   keys (2 KB of K and 2 KB of V per chunk: KT = 8 at D 128 in bf16), 64
//   workers per (slot, kv head). A warp keeps a private ring of 3 chunk
//   stages in shared memory, filled by cp.async (16 B, .cg; each key row's
//   page looked up as table_row[col / page_size], so page sizes 1-64 work;
//   rows at or past length zero-filled by the copy, src-size 0), so two
//   chunks are in flight while one is consumed; lane i looks key i of a
//   chunk up a chunk ahead and the copy's pieces take the offsets by
//   shuffle; only __syncwarp, no block barrier, inside the key loop;
// - a warp holds the q rows of up to RG heads (RG 2 for rep <= 2, else 8;
//   larger rep runs in row groups) and their float32 accumulators in
//   registers, lanes across D; a score is a float32 dot of bf16 (or
//   float32) pairs, summed across lanes by shuffles (the RG x KS scores
//   of a step at once: reduce-scatter, then all-gather); masked keys get
//   s = -1e30 and p = 0, so a worker with no live key ends with m = -1e30,
//   l = 0, acc = 0;
// - the combine, in two levels and a fixed order (never arrival order),
//   so the bits repeat: every warp leaves (m, l, acc) in shared memory;
//   each block combines its warps in warp order, M = max m_i,
//   L = sum l_i exp(m_i - M), A = sum acc_i exp(m_i - M); cluster.sync();
//   then block q reads the 8 block partials through distributed shared
//   memory, in split order, for its D / 8 output columns and writes
//   A / max(L, 1e-30). One launch per call, no workspace;
// - a dead slot (length = width * page + 1, past its table) reads no page
//   and writes zeros.
//
// K4 has one body per input dtype, chosen in paged_prefill_launch:
// - bfloat16: paged_prefill_tc_kernel, the tensor-core tile core of
//   attention_tc.cuh (bf16 mma.sync, cp.async double-buffering; each key
//   row's page looked up per column, so any page size 1-64 works; rows at
//   or past the slot's length zero-filled by the copy). One block of 64
//   threads (2 warps, 32 rows = 32 / rep tokens x rep heads) per (tile,
//   slot, kv head): a chunk of C 512 at rep 2 is 32 tiles x 8 kv heads =
//   256 blocks, more than one wave on 132 SMs;
// - float32: paged_prefill_kernel, the float32 tile core of
//   attention_f32.cuh (float32 FMAs on the CUDA cores, the same cp.async
//   double-buffering, per-column page lookup and zero-filled rows past the
//   length), the body behind the tight float32 checks (1e-5 against the
//   twin). A cluster of 2 blocks of 4 warps per (tile of 64 / hr tokens x
//   hr heads, slot, kv head, head group) splits the tile's keys and
//   combines in rank order (paged_attention.K4_F32_SPLITS, the same at
//   every shape, so that a launch folded over layers, or at a rank's
//   heads, gives the bits of the per-layer or whole launch).
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
// - K3 is memory-bound. Per layer it must read the live KV,
//   2 * sum_slots len * Hkv * D * 2 bytes (4 KiB per token per layer at
//   Qwen3-1.7B: Hkv 8, D 128, bf16), at ~1 FLOP per byte: what it needs is
//   bytes in flight on every SM, which split-K and the copy rings give;
// - K4 is bound by FLOPs or bytes, whichever is larger: 4 * Hq * D FLOPs
//   per (query, attended key) pair against the pages of starts + C.
// What the designs leave on the table: K3's scores still reduce across
// lanes by shuffles (2 per (key, head)); a short slot still takes 8
// blocks. K4's
// bf16 body walks up to starts + C keys serially in each block (1536 at
// start 1024, C 512).
//
// Head dims: every body is instantiated at a padded width DP and, with
// PAD, takes the real head dim D (1 ... 256) at run time; the exact widths
// 64, 128 and 256 keep their own instantiations (PAD false: D is DP and
// every mask below compiles away). DP is the smallest width the body's
// layout allows: 32, 64, 128 or 256 for K3 (a lane holds DP / 32 elements
// of a row), a multiple of 16 for K4's tensor-core body (attention_tc.cuh)
// and a multiple of 32 for its float32 body (attention_f32.cuh: a lane
// owns DP / 8 output dims as float4s). Reads past D are zero-filled, so
// q.k is unchanged, and the extra columns of P.V are never stored. K3 keeps
// its 16-byte cp.async copies where a row's D elements are whole 16-byte
// pieces (the pieces past D zero-filled by the copy) and otherwise stages
// a chunk with element loads into the same shared layout (bf16 at an odd
// D / 8: 24- or 40-byte rows are not 16-byte aligned).
//
// Build: kernels/build.py compiles this source once per part (the
// "nvcc parts" line below), one nvcc each, with -DREPRO_PART=<i>; without
// it (nvcc on the file alone) every part is compiled. Part 0 holds the
// exact widths and the C entry points, parts 1-5 the padded
// instantiations (K3 float32, K3 bf16, K4 float32, K4 bf16 up to 128 and
// above), which part 0 reaches through namespace paged_parts.
// nvcc parts: 6

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "attention_f32.cuh"
#include "attention_tc.cuh"

#ifdef REPRO_PART
#define PART(i) (REPRO_PART == (i))
#else
#define PART(i) 1
#endif

namespace paged_parts {
// the padded instantiations (parts 1-5), dispatched on the padded width:
// K3 in float32 (part 1) and bf16 (part 2)
int decode_padded_f32(const void* q, const void* kp, const void* vp,
                      const void* table, const void* lengths, void* out,
                      int B, int Hq, int Hkv, int D, int page_size,
                      int npages, int window, float softcap, void* stream);
int decode_padded_bf16(const void* q, const void* kp, const void* vp,
                       const void* table, const void* lengths, void* out,
                       int B, int Hq, int Hkv, int D, int page_size,
                       int npages, int window, float softcap, void* stream);
int prefill_padded_f32(const void* q, const void* kp, const void* vp,
                       const void* table, const void* lengths,
                       const void* starts, void* out, int B, int C, int Hq,
                       int Hkv, int D, int page_size, int npages, int window,
                       float softcap, int splits, void* stream);
// K4's float32 body (part 3), its tensor-core body at D <= 128 (part 4)
// and above (part 5)
int prefill_padded_tc_lo(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths,
                         const void* starts, void* out, int B, int C, int Hq,
                         int Hkv, int D, int page_size, int npages,
                         int window, float softcap, void* stream);
int prefill_padded_tc_hi(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths,
                         const void* starts, void* out, int B, int C, int Hq,
                         int Hkv, int D, int page_size, int npages,
                         int window, float softcap, void* stream);
}  // namespace paged_parts

namespace {

constexpr int kMaxRep = 32;     // query heads per kv head (shape_ok)
constexpr int kMaxPage = 64;    // rows of a page (shape_ok)
constexpr float kNegInf = -1e30f;

// a float32 value stored as T
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  __device__ __forceinline__ static float store(float x) { return x; }
};

template <>
struct Vec<__nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

// ---------------------------------------------------------------------------
// K3: split-K decode, one cluster of kSplits blocks per (slot, kv head)

namespace cg = cooperative_groups;

constexpr int kSplits = 8;         // blocks (one cluster) per (slot, kv head)
constexpr int kDecWarps = 8;       // workers per block
constexpr int kDecStages = 3;      // chunk stages in each warp's ring
constexpr int kChunkBytes = 2048;  // bytes of K (and of V) in one chunk

// KT keys of DP elements of T per chunk (a staged row is DP wide); a lane
// holds E = DP / 32 elements of every row; a softmax step takes KS keys at
// a time, so that the scores of a step (RG x KS) stay at 16 registers
template <typename T, int DP, int RG>
struct DecodeShape {
  static constexpr int RB = DP * int(sizeof(T));  // bytes of a staged row
  static constexpr int KT = kChunkBytes / RB;
  static constexpr int E = DP / 32;
  static constexpr int KS = KT < 16 / RG ? KT : 16 / RG;
  static constexpr int PIECES = kChunkBytes / 16;  // 16 B copies of K
  static_assert(KT >= 1 && KT <= 32 && KT % KS == 0,
                "a lane per key; a chunk of whole softmax steps");
  static_assert(PIECES % 32 == 0, "whole copies per lane");
  // the partials (acc, m, l of RG rows) reuse the warp's ring
  static_assert(RG * (DP + 2) * 4 <= kDecStages * 2 * kChunkBytes,
                "partials fit the ring");
};

// each warp's ring, then the block's partial (acc, m, l of RG rows)
template <int DP, int RG>
constexpr size_t decode_smem_bytes() {
  return size_t(kDecWarps) * kDecStages * 2 * kChunkBytes +
         (size_t(RG) * (DP + 2) * 4 + 15) / 16 * 16;
}

// E consecutive elements at p (16 B aligned for E * sizeof(T) >= 16) as
// float32
template <int E>
__device__ __forceinline__ void load_row(const float* p, float (&o)[E]) {
  if constexpr (E == 1) {
    o[0] = *p;
  } else if constexpr (E % 4 == 0) {
#pragma unroll
    for (int i = 0; i < E; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      o[i] = v.x; o[i + 1] = v.y; o[i + 2] = v.z; o[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + i);
      o[i] = v.x; o[i + 1] = v.y;
    }
  }
}

template <int E>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p,
                                         float (&o)[E]) {
  if constexpr (E == 1) {                 // DP 32: one element a lane
    o[0] = __bfloat162float(*p);
    return;
  }
  static_assert(E == 1 || E % 2 == 0, "bf16 pairs");
  uint32_t w[E == 1 ? 1 : E / 2];
  if constexpr (E % 8 == 0) {
#pragma unroll
    for (int i = 0; i < E / 2; i += 4)
      *reinterpret_cast<uint4*>(w + i) =
          *reinterpret_cast<const uint4*>(p + 2 * i);
  } else if constexpr (E == 4) {
    *reinterpret_cast<uint2*>(w) = *reinterpret_cast<const uint2*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < E / 2; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + i));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// every lane's v[i] becomes the sum of v[i] over the warp, in a fixed
// order: a reduce-scatter (NV - 1 shuffles: at each offset a lane keeps
// half of its values and adds its partner's copy of that half), a
// butterfly on the one value left, then an all-gather (NV shuffles), in
// place of NV butterflies of 5 shuffles each
template <int NV>
__device__ __forceinline__ void warp_sum_all(float (&v)[NV]) {
  constexpr int LOG = NV == 1 ? 0 : NV == 2 ? 1 : NV == 4 ? 2
                      : NV == 8 ? 3 : 4;
  static_assert((1 << LOG) == NV, "NV in 1, 2, 4, 8, 16");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int step = 0; step < LOG; ++step) {
    const int o = 16 >> step, half = NV >> (step + 1);
    const bool upper = lane & o;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = upper ? v[i] : v[i + half];
      const float keep = upper ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
  // v[0]: value lane >> (5 - LOG), summed over the lanes that share the
  // low 5 - LOG bits of this one; add the others
#pragma unroll
  for (int o = 16 >> LOG; o > 0; o >>= 1)
    v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  const float mine = v[0];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    v[i] = __shfl_sync(0xffffffffu, mine, i << (5 - LOG));
}

template <typename T, int DP, int RG, bool PAD>
__global__ void __cluster_dims__(kSplits, 1, 1)
__launch_bounds__(kDecWarps * 32, RG == 2 ? 2 : 1)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Hq, int Hkv, int page_size, int npages, int window,
                    float softcap, float scale, int d) {
  using Sh = DecodeShape<T, DP, RG>;
  constexpr int KT = Sh::KT, E = Sh::E, KS = Sh::KS, RB = Sh::RB;
  constexpr int NT = kDecWarps * 32;
  constexpr int NW = kSplits * kDecWarps;         // workers per cluster
  constexpr int DS = DP / kSplits;                // output columns a block
  constexpr int RING = kDecStages * 2 * kChunkBytes;
  constexpr int EP = 16 / int(sizeof(T));         // elements of a 16 B piece
  extern __shared__ __align__(16) unsigned char dec_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int D = PAD ? d : DP;                     // the real head dim
  // a row's D elements are whole 16-byte pieces: the copies stay cp.async
  const bool pieces = !PAD || D % EP == 0;

  const int rank = int(cluster.block_rank());      // split: blockIdx.x
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rep = Hq / Hkv;
  const int length = lengths[b];
  const size_t qoff = (size_t(b) * Hq + size_t(kvh) * rep) * D;
  // A dead slot (finished or inactive) sits at length = width * page + 1,
  // past its table: its output is discarded, so it walks no page and
  // writes zeros (the twin's row for it is junk of the scratch page). The
  // whole cluster returns here, before any cluster barrier.
  if (length > npages * page_size) {
    for (int i = rank * NT + tid; i < rep * D; i += kSplits * NT)
      out[qoff + i] = Vec<T>::store(0.f);
    return;
  }
  const int first = window >= 0 ? max(length - window, 0) : 0;
  const int nchunks = (max(length - first, 0) + KT - 1) / KT;
  const int u = rank * kDecWarps + warp;           // worker, split-major
  const int c_lo = u * nchunks / NW, c_hi = (u + 1) * nchunks / NW;
  const int* table_row = table + size_t(b) * npages;
  const size_t row_stride = size_t(Hkv) * D;
  unsigned char* ring = dec_smem + warp * RING;
  float* part = reinterpret_cast<float*>(ring);    // after the key loop
  float* bpart = reinterpret_cast<float*>(dec_smem + kDecWarps * RING);

  // the pool offset (elements) of key `lane` of chunk c, its page looked
  // up in the table, or -1 at or past the slot's length (KT <= 32)
  auto key_row = [&](int c) -> long long {
    const int col = first + c * KT + lane;
    if (lane >= KT || c >= c_hi || col >= length) return -1;
    return static_cast<long long>(
        (size_t(table_row[col / page_size]) * page_size + col % page_size) *
            row_stride +
        size_t(kvh) * D);
  };
  // stage a chunk in ring slot st, K then V, from the key offsets `rows`
  // (key_row of the chunk): each 16-byte piece takes its key's offset from
  // the lane that holds it; keys at or past length, and with PAD the
  // pieces past D, are zero-filled. Where D elements are not whole pieces
  // (PAD only), lanes load element by element into the same layout.
  auto fetch = [&](int st, long long rows) {
    unsigned char* dst = ring + st * 2 * kChunkBytes;
    if (pieces) {
#pragma unroll
      for (int i = 0; i < Sh::PIECES / 32; ++i) {
        const int j = lane + 32 * i;
        const int key = j / (RB / 16), off = j % (RB / 16);
        const long long at = __shfl_sync(0xffffffffu, rows, key);
        const bool ok = at >= 0 && (!PAD || off * EP < D);
        const size_t e = ok ? size_t(at) + off * (16 / sizeof(T)) : 0;
        const uint32_t sd = attn_tc::smem_u32(dst + key * RB + off * 16);
        attn_tc::cp_async16(sd, kp + e, ok);
        attn_tc::cp_async16(sd + kChunkBytes, vp + e, ok);
      }
    } else if constexpr (PAD) {
      T* ks = reinterpret_cast<T*>(dst);
      T* vs = reinterpret_cast<T*>(dst + kChunkBytes);
#pragma unroll 4
      for (int i = 0; i < KT * DP / 32; ++i) {
        const int j = lane + 32 * i;
        const int key = j / DP, e = j % DP;
        const long long at = __shfl_sync(0xffffffffu, rows, key);
        const bool ok = at >= 0 && e < D;
        ks[j] = ok ? kp[at + e] : T(0.f);
        vs[j] = ok ? vp[at + e] : T(0.f);
      }
    }
    attn_tc::cp_async_commit();
  };

  for (int r0 = 0; r0 < rep; r0 += RG) {
    const int nr = min(RG, rep - r0);
    float qr[RG][E], acc[RG][E], m[RG], l[RG];
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = acc[r][e] = 0.f;
      if constexpr (PAD) {
        const T* qp = q + qoff + size_t(r0 + r) * D + lane * E;
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (r < nr && lane * E + e < D)
            qr[r][e] = static_cast<float>(qp[e]);
      } else {
        if (r < nr) load_row<E>(q + qoff + size_t(r0 + r) * D + lane * E,
                                qr[r]);
      }
      m[r] = kNegInf;
      l[r] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kDecStages - 1; ++i) {
      if (c_lo + i < c_hi) fetch(i, key_row(c_lo + i));
      else attn_tc::cp_async_commit();
    }
    // the offsets of the chunk staged next are loaded a chunk ahead, so the
    // table lookups are not on the copy's path
    long long rows_next = key_row(c_lo + kDecStages - 1);
    for (int c = c_lo; c < c_hi; ++c) {
      const int i = c - c_lo;
      __syncwarp();        // every lane is done with the slot refilled next
      if (c + kDecStages - 1 < c_hi)
        fetch((i + kDecStages - 1) % kDecStages, rows_next);
      else
        attn_tc::cp_async_commit();
      rows_next = key_row(c + kDecStages);
      attn_tc::cp_async_wait<kDecStages - 1>();
      __syncwarp();        // chunk c's copies, from every lane, visible
      const T* Ks = reinterpret_cast<const T*>(
          ring + (i % kDecStages) * 2 * kChunkBytes);
      const T* Vs = Ks + KT * DP;
      const int col0 = first + c * KT;
#pragma unroll
      for (int k0 = 0; k0 < KT; k0 += KS) {
        float s[RG][KS];
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float kv[E];
          load_row<E>(Ks + (k0 + kk) * DP + lane * E, kv);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            float d = 0.f;
            if (r < nr) {
#pragma unroll
              for (int e = 0; e < E; ++e) d = fmaf(qr[r][e], kv[e], d);
            }
            s[r][kk] = d;
          }
        }
        warp_sum_all<RG * KS>(reinterpret_cast<float(&)[RG * KS]>(s));
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          if (r >= nr) continue;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            float v = s[r][kk] * scale;
            if (softcap > 0.f) v = softcap * tanhf(v / softcap);
            s[r][kk] = col0 + k0 + kk < length ? v : kNegInf;
          }
          float mc = kNegInf;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) mc = fmaxf(mc, s[r][kk]);
          const float m_new = fmaxf(m[r], mc);
          const float alpha =
              attn_tc::exp2_approx((m[r] - m_new) * attn_tc::kLog2e);
          float sum = 0.f;
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const float p = col0 + k0 + kk < length
                                ? attn_tc::exp2_approx((s[r][kk] - m_new) *
                                                       attn_tc::kLog2e)
                                : 0.f;
            s[r][kk] = p;
            sum += p;
          }
          l[r] = l[r] * alpha + sum;
          m[r] = m_new;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[r][e] *= alpha;
        }
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          float vv[E];
          load_row<E>(Vs + (k0 + kk) * DP + lane * E, vv);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            if (r >= nr) continue;
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[r][e] = fmaf(s[r][kk], vv[e], acc[r][e]);
          }
        }
      }
    }
    attn_tc::cp_async_wait<0>();   // only empty groups can be pending
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RG; ++r) {
#pragma unroll
      for (int e = 0; e < E; ++e) part[r * DP + lane * E + e] = acc[r][e];
      if (lane == 0) {
        part[RG * DP + r] = m[r];
        part[RG * DP + RG + r] = l[r];
      }
    }
    __syncthreads();               // every warp's partial written
    // the block's partial: its warps combined in warp order
    for (int i = tid; i < nr * DP; i += NT) {
      const int r = i / DP, d = i % DP;
      float mw[kDecWarps], mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        mw[w] = reinterpret_cast<const float*>(dec_smem + w * RING)[RG * DP +
                                                                   r];
        mx = fmaxf(mx, mw[w]);
      }
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        const float* pw = reinterpret_cast<const float*>(dec_smem + w * RING);
        const float wt =
            attn_tc::exp2_approx((mw[w] - mx) * attn_tc::kLog2e);
        lsum = fmaf(pw[RG * DP + RG + r], wt, lsum);
        o = fmaf(pw[r * DP + d], wt, o);
      }
      bpart[r * DP + d] = o;
      if (d == 0) {
        bpart[RG * DP + r] = mx;
        bpart[RG * DP + RG + r] = lsum;
      }
    }
    cluster.sync();                // every block's partial written
    // the outputs: block `rank` takes columns [rank DS, rank DS + DS) of
    // every row (with PAD, those below D) and combines the cluster's
    // blocks in rank order, reading their partials through distributed
    // shared memory
    for (int i = tid; i < nr * DS; i += NT) {
      const int r = i / DS, d = rank * DS + i % DS;
      if (PAD && d >= D) continue;
      float mb[kSplits], lb[kSplits], ab[kSplits], mx = kNegInf;
#pragma unroll
      for (int q = 0; q < kSplits; ++q) {
        const float* pb = cluster.map_shared_rank(bpart, q);
        mb[q] = pb[RG * DP + r];
        lb[q] = pb[RG * DP + RG + r];
        ab[q] = pb[r * DP + d];
      }
#pragma unroll
      for (int q = 0; q < kSplits; ++q) mx = fmaxf(mx, mb[q]);
      float lsum = 0.f, o = 0.f;
#pragma unroll
      for (int q = 0; q < kSplits; ++q) {
        const float wt =
            attn_tc::exp2_approx((mb[q] - mx) * attn_tc::kLog2e);
        lsum = fmaf(lb[q], wt, lsum);
        o = fmaf(ab[q], wt, o);
      }
      out[qoff + size_t(r0 + r) * D + d] =
          Vec<T>::store(o / fmaxf(lsum, 1e-30f));
    }
    cluster.sync();                // partials read before they are reused
  }
}

// K4's float32 body: one block of 4 warps (64 rows) per (tile of 64 / hr
// tokens, slot, kv head, group of hr of its rep heads), or a cluster of
// `splits` blocks splitting its keys, over the float32 tile core
template <int DP, bool PAD>
__global__ void
__launch_bounds__(128, attn_f32::Tile<DP>::kMinBlocks)
paged_prefill_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                     const float* __restrict__ vp,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths,
                     const int* __restrict__ starts, float* __restrict__ out,
                     int C, int Hq, int Hkv, int page_size, int npages,
                     int window, float softcap, float scale, int d,
                     int splits) {
  const int D = PAD ? d : DP;
  constexpr int M = attn_f32::kRows;
  const int rep = Hq / Hkv, hr = min(rep, M), ng = (rep + hr - 1) / hr;
  const int tq = M / hr;
  // heavy tiles first; the blocks of a cluster share one tile
  const int tile = gridDim.x / splits - 1 - blockIdx.x / splits;
  const int y = blockIdx.y;
  const int hg = y % ng, kvh = (y / ng) % Hkv, b = y / (ng * Hkv);
  const int tok0 = tile * tq;
  attn_f32::TileArgs a;
  const size_t qoff = ((size_t(b) * C + tok0) * Hq + size_t(kvh) * rep +
                       size_t(hg) * hr) * D;
  a.q = q + qoff;
  a.out = out + qoff;
  a.tok_stride = size_t(Hq) * D;
  a.hr = hr;
  a.nh = min(hr, rep - hg * hr);
  a.ntok = min(tq, C - tok0);
  a.pos0 = starts[b] + tok0;
  a.nkeys = min(lengths[b], npages * page_size);
  a.hi = min(a.nkeys, a.pos0 + a.ntok);
  a.lo = window > 0 ? max(0, a.pos0 - window + 1) : 0;
  a.d = D;
  a.causal = 1;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  a.splits = splits;
  const attn_tc::PagedKeys keys{table + size_t(b) * npages, page_size,
                                size_t(kvh) * D, size_t(Hkv) * D};
  attn_f32::attend_f32<DP, PAD>(a, kp, vp, keys);
}

template <int DP, bool PAD>
__global__ void __launch_bounds__(64)
paged_prefill_tc_kernel(const attn_tc::bf16* __restrict__ q,
                        const attn_tc::bf16* __restrict__ kp,
                        const attn_tc::bf16* __restrict__ vp,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        const int* __restrict__ starts,
                        attn_tc::bf16* __restrict__ out, int C, int Hq,
                        int Hkv, int page_size, int npages, int window,
                        float softcap, float scale, int d) {
  const int D = PAD ? d : DP;
  const int rep = Hq / Hkv, tq = 32 / rep;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heavy tiles first
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int tok0 = tile * tq;
  attn_tc::TileArgs a;
  const size_t qoff = ((size_t(b) * C + tok0) * Hq + size_t(kvh) * rep) * D;
  a.q = q + qoff;
  a.out = out + qoff;
  a.tok_stride = size_t(Hq) * D;
  a.hr = rep;
  a.nh = rep;
  a.ntok = min(tq, C - tok0);
  a.pos0 = starts[b] + tok0;
  a.nkeys = min(lengths[b], npages * page_size);
  a.hi = min(a.nkeys, a.pos0 + a.ntok);
  a.lo = window > 0 ? max(0, a.pos0 - window + 1) : 0;
  a.d = D;
  a.causal = 1;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  const attn_tc::PagedKeys keys{table + size_t(b) * npages, page_size,
                                size_t(kvh) * D, size_t(Hkv) * D};
  attn_tc::attend_tc<DP, 2, 1, PAD>(a, kp, vp, keys);
}

bool shape_ok(int Hq, int Hkv, int D, int page_size) {
  return Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= kMaxRep && D >= 1 &&
         D <= 256 && page_size >= 1 && page_size <= kMaxPage;
}

bool exact_width(int D) { return D == 64 || D == 128 || D == 256; }

template <typename T, int DP, int RG, bool PAD>
int launch_decode_rg(const void* q, const void* kp, const void* vp,
                     const void* table, const void* lengths, void* out,
                     int B, int Hq, int Hkv, int D, int page_size,
                     int npages, int window, float softcap,
                     cudaStream_t stream) {
  constexpr size_t smem = decode_smem_bytes<DP, RG>();
  auto kern = paged_decode_kernel<T, DP, RG, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0) return int(cudaGetLastError());
  kern<<<dim3(kSplits, Hkv, B), kDecWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), Hq, Hkv,
      page_size, npages, window, softcap, 1.0f / sqrtf(float(D)), D);
  return int(cudaGetLastError());
}

// rows of query heads a warp holds: 2 when rep <= 2 (Qwen3, Gemma2), else
// 8 (larger rep in groups of 8)
template <typename T, int DP, bool PAD>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* table, const void* lengths, void* out, int B,
                  int Hq, int Hkv, int D, int page_size, int npages,
                  int window, float softcap, cudaStream_t stream) {
  if (Hq / Hkv <= 2)
    return launch_decode_rg<T, DP, 2, PAD>(q, kp, vp, table, lengths, out,
                                           B, Hq, Hkv, D, page_size, npages,
                                           window, softcap, stream);
  return launch_decode_rg<T, DP, 8, PAD>(q, kp, vp, table, lengths, out, B,
                                         Hq, Hkv, D, page_size, npages,
                                         window, softcap, stream);
}

// float32: splits (paged_attention.py's K4_F32_SPLITS) blocks of a cluster
// split each tile's keys; the grid is (tiles * splits, B * Hkv * head
// groups)
template <int DP, bool PAD>
int launch_prefill_f32(const void* q, const void* kp, const void* vp,
                       const void* table, const void* lengths,
                       const void* starts, void* out, int B, int C, int Hq,
                       int Hkv, int D, int page_size, int npages, int window,
                       float softcap, int splits, cudaStream_t stream) {
  auto kern = paged_prefill_kernel<DP, PAD>;
  constexpr int M = attn_f32::kRows;
  const int rep = Hq / Hkv, hr = rep < M ? rep : M;
  const int tq = M / hr, ng = (rep + hr - 1) / hr;
  return attn_f32::launch(
      kern, dim3((C + tq - 1) / tq, B * Hkv * ng), splits,
      attn_f32::smem_bytes<DP>(), stream, B == 0 || C == 0,
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<float*>(out), C, Hq, Hkv, page_size, npages, window,
      softcap, 1.0f / sqrtf(float(D)), D, splits);
}

// bfloat16 only
template <int DP, bool PAD>
int launch_prefill_tc(const void* q, const void* kp, const void* vp,
                      const void* table, const void* lengths,
                      const void* starts, void* out, int B, int C, int Hq,
                      int Hkv, int D, int page_size, int npages, int window,
                      float softcap, cudaStream_t stream) {
  constexpr size_t smem = attn_tc::smem_bytes<DP, 2, 1>();
  auto kern = paged_prefill_tc_kernel<DP, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || C == 0) return int(cudaGetLastError());
  const int tq = 32 / (Hq / Hkv);
  kern<<<dim3((C + tq - 1) / tq, B * Hkv), 64, smem, stream>>>(
      static_cast<const attn_tc::bf16*>(q),
      static_cast<const attn_tc::bf16*>(kp),
      static_cast<const attn_tc::bf16*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<attn_tc::bf16*>(out), C, Hq, Hkv, page_size, npages,
      window, softcap, 1.0f / sqrtf(float(D)), D);
  return int(cudaGetLastError());
}

}  // namespace

// the padded widths: K3 32, 64, 128, 256; K4's float32 body multiples of
// 32; its tensor-core body multiples of 16 (the low half in part 4, the
// high half in part 5)
#define K3_WIDTHS(X) X(32) X(64) X(128) X(256)
#define K4_F32_WIDTHS(X) X(32) X(64) X(96) X(128) X(160) X(192) X(224) X(256)
#define K4_TC_WIDTHS_LO(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)
#define K4_TC_WIDTHS_HI(X) \
  X(144) X(160) X(176) X(192) X(208) X(224) X(240) X(256)

namespace paged_parts {

#define K3_CASE(T, W)                                                    \
  if (D <= W)                                                            \
    return launch_decode<T, W, true>(q, kp, vp, table, lengths, out, B, Hq, \
                                     Hkv, D, page_size, npages, window,     \
                                     softcap,                               \
                                     static_cast<cudaStream_t>(stream));
#if PART(1)
int decode_padded_f32(const void* q, const void* kp, const void* vp,
                      const void* table, const void* lengths, void* out,
                      int B, int Hq, int Hkv, int D, int page_size,
                      int npages, int window, float softcap, void* stream) {
#define CASE(W) K3_CASE(float, W)
  K3_WIDTHS(CASE)
#undef CASE
  return int(cudaErrorInvalidValue);
}
#endif

#if PART(2)
int decode_padded_bf16(const void* q, const void* kp, const void* vp,
                       const void* table, const void* lengths, void* out,
                       int B, int Hq, int Hkv, int D, int page_size,
                       int npages, int window, float softcap, void* stream) {
#define CASE(W) K3_CASE(__nv_bfloat16, W)
  K3_WIDTHS(CASE)
#undef CASE
  return int(cudaErrorInvalidValue);
}
#endif

#if PART(3)
int prefill_padded_f32(const void* q, const void* kp, const void* vp,
                       const void* table, const void* lengths,
                       const void* starts, void* out, int B, int C, int Hq,
                       int Hkv, int D, int page_size, int npages, int window,
                       float softcap, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CASE(W)                                                            \
  if (D <= W)                                                              \
    return launch_prefill_f32<W, true>(q, kp, vp, table, lengths, starts,  \
                                       out, B, C, Hq, Hkv, D, page_size,   \
                                       npages, window, softcap, splits, s);
  K4_F32_WIDTHS(CASE)
#undef CASE
  return int(cudaErrorInvalidValue);
}
#endif

#define K4_TC_CASE(W)                                                        \
  if (D <= W)                                                              \
    return launch_prefill_tc<W, true>(q, kp, vp, table, lengths, starts,   \
                                      out, B, C, Hq, Hkv, D, page_size,    \
                                      npages, window, softcap,             \
                                      static_cast<cudaStream_t>(stream));
#if PART(4)
int prefill_padded_tc_lo(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths,
                         const void* starts, void* out, int B, int C, int Hq,
                         int Hkv, int D, int page_size, int npages,
                         int window, float softcap, void* stream) {
  K4_TC_WIDTHS_LO(K4_TC_CASE)
  return int(cudaErrorInvalidValue);
}
#endif
#if PART(5)
int prefill_padded_tc_hi(const void* q, const void* kp, const void* vp,
                         const void* table, const void* lengths,
                         const void* starts, void* out, int B, int C, int Hq,
                         int Hkv, int D, int page_size, int npages,
                         int window, float softcap, void* stream) {
  K4_TC_WIDTHS_HI(K4_TC_CASE)
  return int(cudaErrorInvalidValue);
}
#endif

}  // namespace paged_parts

#if PART(0)
#define DISPATCH_D(T, FN, ...)                                   \
  switch (D) {                                                   \
    case 64: return FN<T, 64, false>(__VA_ARGS__);               \
    case 128: return FN<T, 128, false>(__VA_ARGS__);             \
    case 256: return FN<T, 256, false>(__VA_ARGS__);             \
    default: return int(cudaErrorInvalidValue);                 \
  }

// dtype: 0 = float32, 1 = bfloat16. window < 0: no sliding window.
// softcap <= 0: no softcap. D in 1 ... 256: 64, 128 and 256 run their
// exact instantiations, any other D a padded one. splits (prefill, float32
// only): blocks of a cluster splitting each tile's keys, 1, 2, 4 or 8.
// Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* table,
                                   const void* lengths, void* out, int B,
                                   int Hq, int Hkv, int D, int page_size,
                                   int npages, int window, float softcap,
                                   int dtype, void* stream) {
  if (!shape_ok(Hq, Hkv, D, page_size) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (!exact_width(D))
    return dtype == 0
               ? paged_parts::decode_padded_f32(q, kp, vp, table, lengths,
                                                out, B, Hq, Hkv, D, page_size,
                                                npages, window, softcap,
                                                stream)
               : paged_parts::decode_padded_bf16(q, kp, vp, table, lengths,
                                                 out, B, Hq, Hkv, D,
                                                 page_size, npages, window,
                                                 softcap, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_D(float, launch_decode, q, kp, vp, table, lengths, out, B, Hq,
               Hkv, D, page_size, npages, window, softcap, s)
  }
  DISPATCH_D(__nv_bfloat16, launch_decode, q, kp, vp, table, lengths, out,
             B, Hq, Hkv, D, page_size, npages, window, softcap, s)
}

extern "C" int paged_prefill_launch(const void* q, const void* kp,
                                    const void* vp, const void* table,
                                    const void* lengths, const void* starts,
                                    void* out, int B, int C, int Hq, int Hkv,
                                    int D, int page_size, int npages,
                                    int window, float softcap, int dtype,
                                    int splits, void* stream) {
  if (!shape_ok(Hq, Hkv, D, page_size) || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (!exact_width(D)) {
    if (dtype == 0)
      return paged_parts::prefill_padded_f32(
          q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D,
          page_size, npages, window, softcap, splits, stream);
    if (D <= 128)
      return paged_parts::prefill_padded_tc_lo(
          q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D,
          page_size, npages, window, softcap, stream);
    return paged_parts::prefill_padded_tc_hi(
        q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page_size,
        npages, window, softcap, stream);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
      case 64: return launch_prefill_f32<64, false>(
          q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D,
          page_size, npages, window, softcap, splits, s);
      case 128: return launch_prefill_f32<128, false>(
          q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D,
          page_size, npages, window, softcap, splits, s);
      default: return launch_prefill_f32<256, false>(
          q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D,
          page_size, npages, window, softcap, splits, s);
    }
  }
  switch (D) {
    case 64: return launch_prefill_tc<64, false>(
        q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page_size,
        npages, window, softcap, s);
    case 128: return launch_prefill_tc<128, false>(
        q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page_size,
        npages, window, softcap, s);
    default: return launch_prefill_tc<256, false>(
        q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page_size,
        npages, window, softcap, s);
  }
}
#endif
