// Mamba2 SSD chunk scan (K6) for Hopper (sm_90a), bound to Python through a
// plain C interface loaded with ctypes (repro_torch/kernels/build.py).
//
// K6 (ssd_scan_tc_kernel for bf16; ssd_state_kernel, ssd_pass_kernel and
// ssd_chunk_scan_kernel for float32) replaces the Pallas TPU kernel
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
// Two routes, chosen by dtype in ssd_scan_launch:
// - bfloat16: ssd_scan_tc_kernel (below, namespace tc), the products on
//   the tensor cores. It takes the TPU grid (B * H, n_chunks), whose state
//   sits in VMEM scratch carried along the sequential chunk axis, as a loop
//   over the chunks inside one block; nothing is carried between blocks. A
//   block owns one (batch, head) and a slice of PB of the P state rows (the
//   rows are independent: y[:, p] reads only state[p, :]); the wrapper
//   splits P (PB = P / 2 or P / 4, ssd_scan.p_splits) while twice the
//   B * H blocks still fit one wave of one block per SM, and the C B^T
//   scores are then recomputed per slice. The slices give the same bits.
// - float32: three steps on the CUDA cores (namespace f32, below), the
//   route behind the float32 bar (RTOL 1e-5) and the float32 recompute.
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
// The float32 route: the SSD algorithm's chunk-parallel form, three
// launches on torch's stream, every product a float32 FMA on the CUDA
// cores (no TF32, no tensor cores). The TPU kernel's sequential chunk
// axis is gone: no block waits on a chunk it does not own. Steps B and C
// are launched as programmatic dependents of the step before them, so
// their blocks are scheduled while it drains and wait in griddepcontrol
// for its writes.
// - Step A, ssd_state_kernel (4 warps a block, at least 4 blocks an SM),
//   two kinds of block in one grid:
//   * (batch, head, chunk, P slice): the chunk's cumsum of a dt (a warp
//     scan), written with dt to the scratch as (cum, dt) pairs; then, for
//     every chunk but the last, its own end state
//       D_c = (x o dt exp(cum_L - cum))^T B     (N x PB, float32)
//     x' = x dt exp(cum_L - cum) is folded into the x rows as they are
//     read. B and x come in 32 rows a stage (64 where a B row and an x
//     row hold at most 96 floats) through 16-byte cp.async copies,
//     double-buffered; lane (rg, cg) of warp w owns state rows
//     32 w + 8 rg .. + 7 and P columns 4 cg + 32 q (an 8 x 8 register
//     block at PB 64), read as float4s: 4 of them per 64 FMAs. Below N
//     128 the warps past N's rows take every second (fourth) row of a
//     stage instead, and the partial sums are added in warp order.
//   * (batch, group, chunk, 64 x 64 tile at or below the diagonal): the
//     scores S = C_t B_s^T, once for all the heads of the group, which
//     step C's blocks read back from L2. C and B rows come in 32 columns
//     of N a stage (cp.async, double-buffered, rows padded to 36 floats
//     so that the float4 reads of a warp hit distinct banks); an 8 x 4
//     register block a lane. The tiles are written to the scratch.
// - Step B, ssd_pass_kernel: for each (batch, head), in chunk order, over
//   the N x P state entries (float4s, elementwise, bound by bytes):
//     state_in[c + 1] = state_in[c] exp(cum_L[c]) + D_c,  state_in[0] = 0,
//   in place: slot c of the scratch ends up holding the state entering
//   chunk c + 1 (chunk 0 needs none, the last chunk's D_c is never made).
// - Step C, ssd_chunk_scan_kernel (8 warps, 2 blocks an SM): a block owns
//   (batch, chunk, 64-row t tile, 4 units of one group), a unit being a
//   (head, P slice); warp w owns unit w % 4 and rows 32 (w / 4) .. + 31.
//   The tiles of its reduction stream through one double-buffered cp.async
//   pipeline, one block barrier a tile:
//   * chunk > 0: 16 columns of C_t with 16 rows of each unit's state_in
//     (kept transposed, N x P, so that its rows are x-like rows of P);
//   * then the s tiles of 16 rows at or before the t tile: 16 columns of
//     the group's score tile, 16 rows of x for the 4 units and their
//     (cum, dt) pairs.
//   Each warp turns the 32 rows it owns of the staged A tile into its own
//   transposed A tile in shared memory (lane = row), behind a __syncwarp
//   and no block barrier: on the two s tiles that cross its rows,
//   W = S exp(cum_t - cum_s) dt_s on s <= t, masked before the exp; below
//   them the decay splits at the warp's first row r0, exp(cum_t - cum_s) =
//   exp(cum_t - cum_r0) exp(cum_r0 - cum_s), both factors <= 1, so W =
//   S exp(cum_r0 - cum_s) dt_s (one exp a column, shuffled across the
//   warp) and the rows' factor multiplies the accumulator once, before the
//   first crossing tile; the state's term enters as C_t exp(cum_r0). The
//   warp multiplies the tile into its 32 x PB y block: lane (rg, cg)
//   owns rows 8 rg .. + 7 and the columns above, 2 float4s of W and 2 of
//   x (at PB 64) per 64 FMAs, at most 1 byte of shared memory a FMA. s
//   tiles wholly above a warp's rows are skipped; t tiles run heaviest
//   first (the last in the grid's slowest index).
// What it does about the first design's limits: (1) 4-warp and 8-warp
// blocks with launch bounds naming 4 and 2 blocks an SM, step C in 60 KB
// of shared memory at PB 64 (step A <= 64 KB); (2) the chunks run in
// parallel, the serial part is step B's elementwise pass; (3) the scores
// are made once per (batch, group, chunk), not once per head and P slice,
// and in step A rather than in a step-C block: a block making them would
// hold C_t and double-buffered B_s and x_s tiles of its heads (over 110
// KB at N 128 and 4 heads), and its S tile would be a product too small
// to give each lane an 8 x 8 block;
// (4) every staged tile comes in through cp.async, double-buffered, one
// block barrier a tile, and the decayed scores never leave a warp; (5)
// 8 x 8 register blocks (outer products of float4 rows) instead of 4 x 4;
// (6) the state update is a product of its own (step A), not the last t
// tile's serial tail.
// Scratch (the wrapper's one float32 allocation, offsets in floats, each
// region at a multiple of 64): (cum, dt) per (b, h, s); states per (b, h,
// chunk < nc - 1) as NW x PW (N and nsplit slices of PB, padded); score
// tiles per (b, g, chunk), the nt (nt + 1) / 2 lower 64 x 64 tiles of the
// chunk (nt = ceil(L / 64)), row-major. ssd_scan.f32_plan mirrors it.
// Bits: a head's y depends only on its own data and the shapes (its
// summation order is fixed by L, N and PB; nsplit = ceil(P / 64) for this
// route, the C entry refuses any other; no float atomics), so a batch row,
// a head subset or a rank's heads alone give the whole call's bits.
// Bound: chip_smoke.py's ssd_flops (the scores once per group, the y
// products per head, the carried state's term and the state update per
// head on all chunks but one) over 67 TFLOP/s, or x, dt, b, c read and y
// written once over 3.35 TB/s: by operations at both of the float32 rows
// (mamba2-1.3b's recompute layer, B 16, S 1024, H 64, P 64, N 128, L
// 256: 43.6 GFLOP, 0.650 ms; P 32 x N 48: 0.0266 ms).
// What it leaves: the scores of a tile computed at the diagonal in full
// and re-read from L2 by each 4-unit block; a block's s tiles of 16 rows
// (more barriers than 32 would take); x rows re-read from L2 by every t
// tile after them; step B's launch and its pass over the scratch (~0.12
// ms of traffic at the recompute shape).
//
// The bf16 route's bound (3.35 TB/s; 989 TFLOP/s bf16 dense): x, dt, b,
// c read once and y written once, or ssd_flops as above: by bytes at both
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
// 16-byte cp.async ones where rows are whole aligned vectors, else element
// loads. The float32 route keeps its states at the padded widths in the
// scratch, so they are always whole vectors.
//
// Build: kernels/build.py compiles this source once per part (the "nvcc
// parts" line below), one nvcc each, with -DREPRO_PART=<i>; without it
// every part is compiled: part 0 holds today's sizes and the C entry
// point (and step B of the float32 route), part 1 the float32 padded
// bodies, part 2 the bf16 padded body, reached through namespace
// ssd_parts.
// nvcc parts: 3

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "attention_f32.cuh"
#include "attention_tc.cuh"

#ifdef REPRO_PART
#define PART(i) (REPRO_PART == (i))
#else
#define PART(i) 1
#endif

namespace ssd_parts {
// the padded bodies: float32 (part 1) and bf16 (part 2)
int padded_f32(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, void* scratch, int B, int S, int H,
               int G, int P, int N, int L, int nsplit, void* stream);
int padded_tc(const void* x, const void* dt, const void* a, const void* b,
              const void* c, void* y, int B, int S, int H, int G, int P,
              int N, int L, int nsplit, void* stream);
}  // namespace ssd_parts

// ---------------------------------------------------------------------------
// float32: the three steps on the CUDA cores

// types and sizes shared by the parts (named, so that part 1 can call the
// step-B launch that part 0 holds)
namespace ssd_f32 {

constexpr int kT = 64;          // rows of a t tile and of a score tile
constexpr int kK = 16;          // reduction rows of a staged step-C tile
constexpr int kKC = 32;         // N columns of a staged score tile
constexpr int kUnits = 4;       // (head, P slice) units of a step-C block
constexpr int kThreadsA = 128;  // step A: 4 warps
constexpr int kThreadsB = 256;
constexpr int kThreadsC = 256;  // step C: 2 warps (row halves) a unit
constexpr int kLDA = kK + 4;    // padded row of a staged step-C A tile
constexpr int kLDK = kKC + 4;   // padded row of a staged C or B tile
constexpr size_t kAlign = 64;   // scratch regions start at 64 floats

// step A's chunk-state blocks: a staged B row (the lanes' 32 rows of n at
// least) and the s rows of a stage (64 where both tiles stay small)
template <int PB, int N>
struct TileA {
  static constexpr int LDB = N < 32 ? 32 : N;
  static constexpr int KS = LDB + PB <= 96 ? 64 : 32;
};

// the widths the scratch keeps: N padded to 16, 32, 64, 128 and a P slice
// to 16, 32, 64 (an exact instantiation's own sizes)
__host__ __device__ inline int pad_n(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : 128;
}
__host__ __device__ inline int pad_p(int p) {
  return p <= 16 ? 16 : p <= 32 ? 32 : 64;
}
__host__ __device__ inline size_t round_up(size_t v) {
  return (v + kAlign - 1) / kAlign * kAlign;
}

// offsets (floats) of the scratch's regions: (cum, dt) pairs at 0, the
// states, the score tiles; `floats` its size
struct Layout {
  size_t states, scores, floats;
};

inline Layout layout(int B, int S, int H, int G, int L, int NW, int PW) {
  const size_t nc = L > 0 ? size_t(S) / L : 0;
  const size_t nt = (size_t(L) + kT - 1) / kT;
  Layout o;
  o.states = round_up(size_t(B) * H * S * 2);
  o.scores = o.states + round_up(size_t(B) * H * (nc > 0 ? nc - 1 : 0) *
                                 NW * PW);
  o.floats = o.scores + size_t(B) * G * nc * (nt * (nt + 1) / 2) * kT * kT;
  return o;
}

struct Args {
  const float* x;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  float* y;
  float* scratch;
  size_t states, scores;  // scratch offsets (floats)
  int B, S, H, G, P, N;   // N: the real state width
  int L, nsplit, pb;      // chunk rows; P slices and rows a slice (ceil)
  int nc, nt, ntri;       // chunks; 64-row tiles a chunk; score tiles
  int NW, PW;             // the scratch's state widths (padded N, P)
};

// Args without the pointers: the shapes, the tiles they give and the
// scratch's offsets, for the state widths NW x PW
inline Args shape_args(int B, int S, int H, int G, int P, int N, int L,
                       int nsplit, int NW, int PW) {
  Args p = {};
  p.B = B;
  p.S = S;
  p.H = H;
  p.G = G;
  p.P = P;
  p.N = N;
  p.L = L;
  p.nsplit = nsplit;
  p.pb = (P + nsplit - 1) / nsplit;
  p.nc = S / L;
  p.nt = (L + kT - 1) / kT;
  p.ntri = p.nt * (p.nt + 1) / 2;
  p.NW = NW;
  p.PW = PW;
  const Layout lay = layout(B, S, H, G, L, NW, PW);
  p.states = lay.states;
  p.scores = lay.scores;
  return p;
}

// the three grids: step A, a block per (batch, head, chunk, P slice) and
// per (batch, group, chunk, lower score tile); step B (launched only with
// more than one chunk), (batch x head, kThreadsB float4s of a state);
// step C, a block per (batch, chunk, t tile, group, kUnits units)
struct Grids {
  size_t a, c;
  unsigned b_x, b_y;
};

inline Grids grids(const Args& p) {
  const size_t per = size_t(p.NW) * p.PW / 4;
  const size_t nub = (size_t(p.H / p.G) * p.nsplit + kUnits - 1) / kUnits;
  Grids g;
  g.a = size_t(p.B) * p.H * p.nc * p.nsplit +
        size_t(p.B) * p.G * p.nc * p.ntri;
  g.b_x = unsigned(size_t(p.B) * p.H);
  g.b_y = unsigned((per + kThreadsB - 1) / kThreadsB);
  g.c = size_t(p.B) * p.nc * p.nt * p.G * nub;
  return g;
}

// kern<<<grid, threads, smem, stream>>>(p), allowed to start while the
// kernel before it on the stream still runs (it waits in wait_prior)
template <typename Kern>
cudaError_t launch_after(Kern kern, dim3 grid, int threads, size_t smem,
                         cudaStream_t stream, const Args& p) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute pdl;
  pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &pdl;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, p);
}

}  // namespace ssd_f32

namespace ssd_parts {
// step B (part 0): the states passed from chunk to chunk
int pass_f32(const ssd_f32::Args& p, cudaStream_t stream);
}  // namespace ssd_parts

namespace {

namespace f32 {

using namespace ssd_f32;
using attn_f32::copy_chunk;
using attn_f32::fma4;
using attn_tc::cp_async16;
using attn_tc::cp_async_commit;
using attn_tc::cp_async_wait;
using attn_tc::smem_u32;

// programmatic dependent launch: steps B and C are launched while the step
// before them runs (launch_after); a block lets the next step's blocks be
// scheduled (allow_next), and waits for the step before it to finish and
// its writes to be visible before reading them (wait_prior)
__device__ __forceinline__ void allow_next() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 8-byte async copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
}

// the TN = PB / 8 columns of a row of PB floats lane group cg owns: 4 cg +
// 32 q + e (q < TN / 4, e < 4) at PB 32 and 64, 2 cg + e at PB 16
template <int TN>
__device__ __forceinline__ int col_of(int cg, int j) {
  if constexpr (TN == 2)
    return 2 * cg + j;
  else
    return 32 * (j / 4) + 4 * cg + j % 4;
}

template <int TN>
__device__ __forceinline__ void load_cols(float (&v)[TN], const float* row,
                                          int cg) {
  if constexpr (TN == 2) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * cg);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const float4 t =
          *reinterpret_cast<const float4*>(row + 32 * q + 4 * cg);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  }
}

template <int TN>
__device__ __forceinline__ void store_cols(float* row, int cg,
                                           const float (&v)[TN]) {
  if constexpr (TN == 2) {
    *reinterpret_cast<float2*>(row + 2 * cg) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < TN / 4; ++q)
      *reinterpret_cast<float4*>(row + 32 * q + 4 * cg) = make_float4(
          v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

// acc[i][j] += a[i] v[j]: one k of an 8 x TN outer product
template <int TN>
__device__ __forceinline__ void outer8(float (&acc)[8][TN], const float4 a0,
                                       const float4 a1, const float (&v)[TN]) {
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
}

template <int PB, int N>
size_t smem_a(int L) {
  constexpr int LDB = TileA<PB, N>::LDB, kKS = TileA<PB, N>::KS;
  const size_t lp = (size_t(L) + kKS - 1) / kKS * kKS;
  const size_t state =
      (2 * size_t(kKS) * (LDB + PB) + 2 * lp) * sizeof(float);
  const size_t scores = 4 * size_t(kT) * kLDK * sizeof(float);
  const size_t partials = 128 * size_t(PB) * sizeof(float);
  const size_t m = state > scores ? state : scores;
  return m > partials ? m : partials;
}

template <int PB>
constexpr size_t smem_c() {
  return (2 * size_t(kT) * kLDA + 2 * size_t(kK) * kUnits * PB +
          2 * size_t(kK) * kUnits * 2 + (kThreadsC / 32) * size_t(kK) * 32 +
          size_t(kT) * kUnits) * sizeof(float);
}

// Step A, a chunk-state block: (batch, head, chunk, P slice) -> the
// (cum, dt) pairs of the chunk and, but for the last chunk, its end state
// D_c = (x o dt exp(cum_L - cum))^T B, stored transposed (N x PB)
template <int PB, int N, bool PAD>
__device__ __forceinline__ void chunk_state(const Args& p, int id,
                                            float* sm) {
  constexpr int LDB = TileA<PB, N>::LDB, kKS = TileA<PB, N>::KS;
  constexpr int TN = PB / 8;
  constexpr int BCH = LDB / 4, XCH = PB / 4;
  const int L = p.L;
  const int lp = (L + kKS - 1) / kKS * kKS;
  float* Bs = sm;                       // 2 x kKS x LDB
  float* Xs = Bs + 2 * kKS * LDB;       // 2 x kKS x PB
  float* cum = Xs + 2 * kKS * PB;       // lp
  float* fw = cum + lp;                 // dt, then dt exp(cum_L - cum)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = id % p.nsplit;
  int rest = id / p.nsplit;
  const int ic = rest % p.nc;
  rest /= p.nc;
  const int h = rest % p.H, b = rest / p.H;
  const bool last = ic == p.nc - 1;
  if (last && split > 0) return;
  const size_t c0 = size_t(ic) * L;
  const float ah = p.a[h];
  for (int r = tid; r < lp; r += kThreadsA)
    fw[r] = r < L ? p.dt[(size_t(b) * p.S + c0 + r) * p.H + h] : 0.f;
  __syncthreads();
  if (warp == 0) {   // inclusive scan of a * dt, 32 rows at a time
    float carry = 0.f;
    for (int base = 0; base < L; base += 32) {
      const int r = base + lane;
      float v = r < L ? ah * fw[r] : 0.f;
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
  if (split == 0) {
    float2* cd = reinterpret_cast<float2*>(p.scratch) +
                 (size_t(b) * p.H + h) * p.S + c0;
    for (int r = tid; r < L; r += kThreadsA)
      cd[r] = make_float2(cum[r], fw[r]);
  }
  if (last) return;
  // each thread rescales the rows it wrote; the stage loop's first
  // barrier publishes them
  const float cl = cum[L - 1];
  for (int r = tid; r < L; r += kThreadsA) fw[r] *= expf(cl - cum[r]);

  const int g = h / (p.H / p.G);
  const int Nr = PAD ? p.N : N;
  const int pr = PAD ? min(p.pb, p.P - split * p.pb) : PB;
  const bool nvec = !PAD || Nr % 4 == 0;
  const bool xvec = !PAD || (p.P % 4 == 0 && p.pb % 4 == 0);
  const size_t xrow = size_t(p.H) * p.P, brow = size_t(p.G) * Nr;
  const float* xb = p.x + (size_t(b) * p.S + c0) * xrow + size_t(h) * p.P +
                    size_t(split) * p.pb;
  const float* bb = p.b + (size_t(b) * p.S + c0) * brow + size_t(g) * Nr;
  auto stage = [&](int s0, int buf) {
    float* bd = Bs + buf * kKS * LDB;
    float* xd = Xs + buf * kKS * PB;
    for (int i = tid; i < kKS * BCH; i += kThreadsA) {
      const int r = i / BCH, cc = i % BCH;
      const bool ok = s0 + r < L;
      copy_chunk(bd + r * LDB + 4 * cc, ok ? bb + (s0 + r) * brow : bb, cc,
                 Nr, ok, nvec);
    }
    for (int i = tid; i < kKS * XCH; i += kThreadsA) {
      const int r = i / XCH, cc = i % XCH;
      const bool ok = s0 + r < L;
      copy_chunk(xd + r * PB + 4 * cc, ok ? xb + (s0 + r) * xrow : xb, cc,
                 pr, ok, xvec);
    }
    cp_async_commit();
  };

  // warp w owns state rows 32 (w % NB) .. + 31 and, when N < 128 leaves
  // warps over, every KSPLIT-th row of a stage from w / NB; the partial
  // sums are added in that order at the end
  constexpr int NB = (N + 31) / 32, KSPLIT = 4 / NB;
  const int rg = lane / 8, cg = lane % 8;
  const int kpart = KSPLIT > 1 ? warp / NB : 0;
  const int n0 = 32 * (warp % NB) + 8 * rg;   // this lane's rows n0 .. + 7
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const int ns = lp / kKS;
  stage(0, 0);
  for (int js = 0; js < ns; ++js) {
    const int buf = js & 1;
    cp_async_wait<0>();
    __syncthreads();   // stage js landed; stage js - 1's buffer is free
    if (js + 1 < ns) stage((js + 1) * kKS, buf ^ 1);
    const float* bt = Bs + buf * kKS * LDB + n0;
    const float* xt = Xs + buf * kKS * PB;
    const float* ft = fw + js * kKS;   // rows past L: x and f are 0
#pragma unroll 1
    for (int k = kpart; k < kKS; k += KSPLIT) {
      const float f = ft[k];
      float v[TN];
      load_cols<TN>(v, xt + k * PB, cg);
#pragma unroll
      for (int j = 0; j < TN; ++j) v[j] *= f;
      outer8<TN>(acc, *reinterpret_cast<const float4*>(bt + k * LDB),
                 *reinterpret_cast<const float4*>(bt + k * LDB + 4), v);
    }
  }
  if constexpr (KSPLIT > 1) {   // add the partial sums, in kpart order
    float* red = sm;                   // KSPLIT x 32 NB x PB
    __syncthreads();                   // the stage buffers are free
    if (kpart > 0)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        store_cols<TN>(red + (kpart * 32 * NB + n0 + i) * PB, cg, acc[i]);
    __syncthreads();
    if (kpart > 0) return;
#pragma unroll 1
    for (int q = 1; q < KSPLIT; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float v[TN];
        load_cols<TN>(v, red + (q * 32 * NB + n0 + i) * PB, cg);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += v[j];
      }
  }
  float* st = p.scratch + p.states +
              ((size_t(b) * p.H + h) * (p.nc - 1) + ic) * p.NW * p.PW +
              size_t(split) * PB;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (n0 + i < N) store_cols<TN>(st + size_t(n0 + i) * p.PW, cg, acc[i]);
}

// Step A, a score block: (batch, group, chunk, tile (i, j), j <= i) ->
// S = C_t B_s^T over t in tile i, s in tile j (64 x 64), once for the
// group's heads
template <int N, bool PAD>
__device__ __forceinline__ void chunk_scores(const Args& p, int id,
                                             float* sm) {
  constexpr int CH = kKC / 4;
  constexpr int NK = (N + kKC - 1) / kKC;
  float* Cs = sm;                       // 2 x kT x kLDK
  float* Bs = Cs + 2 * kT * kLDK;       // 2 x kT x kLDK
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tri = id % p.ntri;
  int rest = id / p.ntri;
  const int ic = rest % p.nc;
  rest /= p.nc;
  const int g = rest % p.G, b = rest / p.G;
  int ti = 0;                           // tri = ti (ti + 1) / 2 + tj
  while ((ti + 1) * (ti + 2) / 2 <= tri) ++ti;
  const int tj = tri - ti * (ti + 1) / 2;
  const int L = p.L, t0 = ti * kT, s0 = tj * kT;
  const int Nr = PAD ? p.N : N;
  const bool nvec = !PAD || Nr % 4 == 0;
  const size_t brow = size_t(p.G) * Nr;
  const size_t base = (size_t(b) * p.S + size_t(ic) * L) * brow +
                      size_t(g) * Nr;
  const float* cb = p.c + base;
  const float* bb = p.b + base;
  auto stage = [&](int k0, int buf) {
    float* cd = Cs + buf * kT * kLDK;
    float* bd = Bs + buf * kT * kLDK;
    for (int e = tid; e < kT * CH; e += kThreadsA) {
      const int r = e / CH, cc = e % CH;
      const bool okc = t0 + r < L, oks = s0 + r < L;
      copy_chunk(cd + r * kLDK + 4 * cc,
                 okc ? cb + (t0 + r) * brow + k0 : cb, cc, Nr - k0, okc,
                 nvec);
      copy_chunk(bd + r * kLDK + 4 * cc,
                 oks ? bb + (s0 + r) * brow + k0 : bb, cc, Nr - k0, oks,
                 nvec);
    }
    cp_async_commit();
  };
  const int rg = lane / 8, cg = lane % 8;
  const int wr = 32 * (warp / 2) + rg, wc = 32 * (warp % 2) + cg;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  stage(0, 0);
  for (int ks = 0; ks < NK; ++ks) {
    const int buf = ks & 1;
    cp_async_wait<0>();
    __syncthreads();
    if (ks + 1 < NK) stage((ks + 1) * kKC, buf ^ 1);
    // rows wr + 4 i of C, rows wc + 8 j of B: float4s along N
    const float* ct = Cs + buf * kT * kLDK + wr * kLDK;
    const float* bt = Bs + buf * kT * kLDK + wc * kLDK;
#pragma unroll 1
    for (int k = 0; k < kKC; k += 4) {
      float4 cv[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        cv[i] = *reinterpret_cast<const float4*>(ct + 4 * i * kLDK + k);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const float4*>(bt + 8 * j * kLDK + k);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma4(cv[i], bv[j], acc[i][j]);
    }
  }
  float* out = p.scratch + p.scores +
               (((size_t(b) * p.G + g) * p.nc + ic) * p.ntri + tri) * kT *
                   kT;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[(wr + 4 * i) * kT + wc + 8 * j] = acc[i][j];
}

template <int PB, int N, bool PAD>
__global__ void __launch_bounds__(kThreadsA, 4)
ssd_state_kernel(const Args p) {
  extern __shared__ __align__(16) float ssd_a_smem[];
  allow_next();
  const int nstate = p.B * p.H * p.nc * p.nsplit;
  if (int(blockIdx.x) < nstate)
    chunk_state<PB, N, PAD>(p, blockIdx.x, ssd_a_smem);
  else
    chunk_scores<N, PAD>(p, blockIdx.x - nstate, ssd_a_smem);
}

// Step C: block (batch, chunk, t tile, 4 units of one group). y_t of each
// unit = exp(cum_t) (C_t state_in^T) + [S o exp(cum_t - cum_s) dt_s]_{s<=t}
// x_s, the scores S from step A's tiles
template <int PB, int N, bool PAD>
__global__ void __launch_bounds__(kThreadsC, 2)
ssd_chunk_scan_kernel(const Args p) {
  constexpr int TN = PB / 8;
  constexpr int LDV = kUnits * PB;      // a staged V row: the units' columns
  constexpr int VCH = PB / 4;           // 16-byte chunks of a unit's row
  constexpr int NWARP = kThreadsC / 32;
  extern __shared__ __align__(16) float ssd_c_smem[];
  float* As = ssd_c_smem;                          // 2 x kT x kLDA
  float* Vs = As + 2 * kT * kLDA;                  // 2 x kK x LDV
  float2* Tb = reinterpret_cast<float2*>(Vs + 2 * kK * LDV);  // 2 x kK x 4
  float* Ws = reinterpret_cast<float*>(Tb + 2 * kK * kUnits);  // 8 x kK x 32
  float* Ct = Ws + NWARP * kK * 32;                // kT x kUnits: cum_t

  wait_prior();   // step B's states (step A's, with one chunk)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int slot = warp % kUnits, half = warp / kUnits;
  const int rep = p.H / p.G, units = rep * p.nsplit;
  const int nub = (units + kUnits - 1) / kUnits;
  int id = blockIdx.x;
  const int ub = id % nub;
  id /= nub;
  const int g = id % p.G;
  id /= p.G;
  const int ic = id % p.nc;
  id /= p.nc;
  const int b = id % p.B;
  const int it = p.nt - 1 - id / p.B;   // heaviest t tiles first
  const int L = p.L, t0 = it * kT;
  const size_t c0 = size_t(ic) * L;
  const int Nr = PAD ? p.N : N;
  const bool nvec = !PAD || Nr % 4 == 0;
  const bool xvec = !PAD || (p.P % 4 == 0 && p.pb % 4 == 0);
  const size_t xrow = size_t(p.H) * p.P, crow = size_t(p.G) * Nr;
  const size_t per = size_t(p.NW) * p.PW;
  const float2* cdb = reinterpret_cast<const float2*>(p.scratch);
  // unit q of the block: its head and P slice (past the group's units,
  // the last unit's, never stored)
  auto unit = [&](int q, int& hq, int& sq) {
    const int u = ub * kUnits + q;
    const int uc = min(u, units - 1);
    hq = g * rep + uc / p.nsplit;
    sq = uc % p.nsplit;
    return u < units;
  };
  {  // cum of the t rows (rows past L: 0)
    const int r = tid / kUnits, q = tid % kUnits;
    int hq, sq;
    const bool ok = unit(q, hq, sq) && t0 + r < L;
    Ct[tid] = ok ? cdb[(size_t(b) * p.H + hq) * p.S + c0 + t0 + r].x : 0.f;
  }
  const int n1 = ic > 0 ? (Nr + kK - 1) / kK : 0;  // state tiles
  const int reach = min(t0 + kT, L);             // s rows [0, reach)
  const int nk = n1 + (reach + kK - 1) / kK;
  const float* cb = p.c + (size_t(b) * p.S + c0) * crow + size_t(g) * Nr;
  const float* xb = p.x + (size_t(b) * p.S + c0) * xrow;
  const float* sc = p.scratch + p.scores +
                    (((size_t(b) * p.G + g) * p.nc + ic) * p.ntri +
                     size_t(it) * (it + 1) / 2) * kT * kT;
  // this thread's share of a V tile, fixed for the whole loop: unit vq,
  // chunk vc of its row, rows vr0 + i VSTEP; and of the (cum, dt) pairs
  constexpr int VSTEP = kThreadsC / (kUnits * VCH);
  constexpr int VROWS = kK / VSTEP;
  const int vq = tid / VCH % kUnits, vc = tid % VCH;
  const int vr0 = tid / (kUnits * VCH);
  int vh, vs;
  const bool vok = unit(vq, vh, vs);
  const int vpr = PAD ? min(p.pb, p.P - vs * p.pb) : PB;
  const float* xsrc = xb + size_t(vh) * p.P + size_t(vs) * p.pb;
  const float* ssrc = p.scratch + p.states +
                      ((size_t(b) * p.H + vh) * (p.nc - 1) + max(ic - 1, 0)) *
                          per +
                      size_t(vs) * PB + 4 * vc;
  float* vdst = Vs + vr0 * LDV + vq * PB + 4 * vc;
  const int tr = tid / kUnits;
  int th = 0, ts = 0;
  const bool tok = tid < kK * kUnits && unit(tid % kUnits, th, ts);
  const float2* tsrc = cdb + (size_t(b) * p.H + th) * p.S + c0;
  const int ar = tid / 4, ac = tid % 4;  // the A tile: 64 rows x 4 chunks
  auto stage = [&](int k, int buf) {
    float* ad = As + buf * kT * kLDA + ar * kLDA + 4 * ac;
    float* vd = vdst + buf * kK * LDV;
    if (k < n1) {   // C_t columns k0 .. + 15, state rows k0 .. + 15
      const int k0 = k * kK;
      const bool ok = t0 + ar < L;
      copy_chunk(ad, ok ? cb + (t0 + ar) * crow + k0 : cb, ac, Nr - k0, ok,
                 nvec);
      const float* src = ssrc + size_t(k0 + vr0) * p.PW;
#pragma unroll
      for (int i = 0; i < VROWS; ++i)
        cp_async16(smem_u32(vd + i * VSTEP * LDV),
                   src + size_t(i) * VSTEP * p.PW, vok);
    } else {        // s tile: score columns, x rows, (cum, dt) pairs
      const int s0 = (k - n1) * kK;
      cp_async16(smem_u32(ad),
                 sc + size_t(s0 / kT) * kT * kT + ar * kT + s0 % kT + 4 * ac,
                 true);
#pragma unroll
      for (int i = 0; i < VROWS; ++i) {
        const int row = s0 + vr0 + i * VSTEP;
        const bool ok = vok && row < L;
        copy_chunk(vd + i * VSTEP * LDV, ok ? xsrc + row * xrow : xb, vc,
                   vpr, ok, xvec);
      }
      if (tid < kK * kUnits) {
        const bool ok = tok && s0 + tr < L;
        cp_async8(smem_u32(Tb + buf * kK * kUnits + tid),
                  tsrc + (ok ? s0 + tr : 0), ok);
      }
    }
    cp_async_commit();
  };

  int hq, sq;
  const bool live = unit(slot, hq, sq);
  const int wr0 = 32 * half;            // the warp's rows of the t tile
  const int wt0 = t0 + wr0;
  const bool rows = live && wt0 < L;
  const int rg = lane / 8, cg = lane % 8;
  float* w = Ws + warp * kK * 32;       // the warp's A tile, transposed
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // lane = row t = wt0 + lane: cum_t. Below the diagonal (s < wt0 <= t)
  // a score's decay is split at the warp's first row: exp(cum_t - cum_s) =
  // rt exp(cum_ref - cum_s), rt = exp(cum_t - cum_ref), both factors <= 1;
  // the state's term takes exp(cum_ref) and the rows' rt comes in once,
  // before the first diagonal tile
  float ct = 0.f, cref = 0.f, rt = 0.f, eref = 0.f;
  stage(0, 0);
  for (int k = 0; k < nk; ++k) {
    const int buf = k & 1;
    cp_async_wait<0>();
    __syncthreads();   // tile k landed (and Ct, at k = 0); buf ^ 1 free
    if (k + 1 < nk) stage(k + 1, buf ^ 1);
    if (!rows) continue;
    if (k == 0) {
      ct = Ct[(wr0 + lane) * kUnits + slot];
      cref = Ct[wr0 * kUnits + slot];
      rt = wt0 + lane < L ? expf(ct - cref) : 0.f;
      eref = expf(cref);
    }
    const int s0 = (k - n1) * kK;       // an s tile's first row (k >= n1)
    if (k >= n1 && s0 > wt0 + 31) continue;   // every pair masked
    if (k >= n1 && s0 == wt0) {         // the rows' factor rt
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float r = __shfl_sync(0xffffffffu, rt, 8 * rg + i);
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] *= r;
      }
    }
    const float* at = As + buf * kT * kLDA + (wr0 + lane) * kLDA;
    float a4[kK];                       // the lane's row of the A tile
#pragma unroll
    for (int q = 0; q < kK / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(at + 4 * q);
      a4[4 * q] = v.x;
      a4[4 * q + 1] = v.y;
      a4[4 * q + 2] = v.z;
      a4[4 * q + 3] = v.w;
    }
    const float2* tb = Tb + buf * kK * kUnits + slot;
    if (k < n1) {   // C_t exp(cum_ref), transposed
#pragma unroll
      for (int c = 0; c < kK; ++c) w[c * 32 + lane] = a4[c] * eref;
    } else if (s0 < wt0) {   // below the diagonal: S exp(cum_ref - cum_s) dt_s
      const float2 cs = tb[(lane % kK) * kUnits];
      const float f = expf(cref - cs.x) * cs.y;   // column lane % 16's
#pragma unroll
      for (int c = 0; c < kK; ++c)
        w[c * 32 + lane] = a4[c] * __shfl_sync(0xffffffffu, f, c);
    } else {        // the diagonal: S exp(cum_t - cum_s) dt_s on s <= t < L
      const int t = wt0 + lane;
#pragma unroll
      for (int c = 0; c < kK; ++c) {
        const float2 cs = tb[c * kUnits];
        const bool keep = s0 + c <= t && t < L;
        const float dec = keep ? ct - cs.x : 0.f;
        w[c * 32 + lane] = keep ? a4[c] * expf(dec) * cs.y : 0.f;
      }
    }
    __syncwarp();
    // y += A V: rows 8 rg .. + 7 of the warp's A tile against the unit's
    // columns of the V tile
    const float* vt = Vs + buf * kK * LDV + slot * PB;
#pragma unroll 1
    for (int c = 0; c < kK; ++c) {
      float v[TN];
      load_cols<TN>(v, vt + c * LDV, cg);
      outer8<TN>(acc, *reinterpret_cast<const float4*>(w + c * 32 + 8 * rg),
                 *reinterpret_cast<const float4*>(w + c * 32 + 8 * rg + 4),
                 v);
    }
    __syncwarp();      // the next tile rewrites w
  }
  if (!rows) return;
  const int pr = PAD ? min(p.pb, p.P - sq * p.pb) : PB;
  float* yb = p.y + (size_t(b) * p.S + c0) * xrow + size_t(hq) * p.P +
              size_t(sq) * p.pb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = wt0 + 8 * rg + i;
    if (t >= L) continue;
    float* row = yb + size_t(t) * xrow;
    if constexpr (PAD) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = col_of<TN>(cg, j);
        if (col < pr) row[col] = acc[i][j];
      }
    } else {
      store_cols<TN>(row, cg, acc[i]);
    }
  }
}

template <int PB, int N, bool PAD>
int launch(const Args& p, cudaStream_t stream) {
  auto ka = ssd_state_kernel<PB, N, PAD>;
  auto kc = ssd_chunk_scan_kernel<PB, N, PAD>;
  const size_t sa = smem_a<PB, N>(p.L), sc = smem_c<PB>();
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, int(sa));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kc, cudaFuncAttributeMaxDynamicSharedMemorySize, int(sc));
  if (err != cudaSuccess) return int(err);
  if (p.B == 0 || p.S == 0) return int(cudaGetLastError());
  const Grids g = grids(p);
  if (g.a > 0x7fffffffu || g.c > 0x7fffffffu)
    return int(cudaErrorInvalidValue);
  ka<<<unsigned(g.a), kThreadsA, sa, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  if (p.nc > 1) {
    const int e = ssd_parts::pass_f32(p, stream);
    if (e != 0) return e;
  }
  err = launch_after(kc, dim3(unsigned(g.c)), kThreadsC, sc, stream, p);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace f32

}  // namespace

#if PART(0)
namespace {
// Step B: the states entering each chunk, in place over the scratch's
// chunk states. Block (batch x head, 256 float4s of a state); thread e
// walks the chunks in order with its float4
__global__ void __launch_bounds__(ssd_f32::kThreadsB)
ssd_pass_kernel(const ssd_f32::Args p) {
  f32::allow_next();
  f32::wait_prior();   // step A's states and (cum, dt) pairs
  const size_t per = size_t(p.NW) * p.PW / 4;
  const size_t e = size_t(blockIdx.y) * ssd_f32::kThreadsB + threadIdx.x;
  if (e >= per) return;
  const size_t bh = blockIdx.x;
  const float2* cd = reinterpret_cast<const float2*>(p.scratch) + bh * p.S;
  float4* st = reinterpret_cast<float4*>(p.scratch + p.states) +
               bh * (p.nc - 1) * per + e;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = st[0];
  for (int ic = 0; ic + 1 < p.nc; ++ic) {
    const float4 nxt = ic + 2 < p.nc ? st[size_t(ic + 1) * per] : v;
    const float d = expf(cd[size_t(ic) * p.L + p.L - 1].x);
    s.x = fmaf(s.x, d, v.x);
    s.y = fmaf(s.y, d, v.y);
    s.z = fmaf(s.z, d, v.z);
    s.w = fmaf(s.w, d, v.w);
    st[size_t(ic) * per] = s;
    v = nxt;
  }
}
}  // namespace

namespace ssd_parts {
int pass_f32(const ssd_f32::Args& p, cudaStream_t stream) {
  const ssd_f32::Grids g = ssd_f32::grids(p);
  const dim3 grid(g.b_x, g.b_y);
  const cudaError_t err = ssd_f32::launch_after(
      ssd_pass_kernel, grid, ssd_f32::kThreadsB, 0, stream, p);
  return int(err != cudaSuccess ? err : cudaGetLastError());
}
}  // namespace ssd_parts
#endif

namespace {

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

}  // namespace

namespace {

// float32: the three steps of namespace f32; bfloat16: the tensor-core body
template <typename T, int PB, int N, bool PAD>
int route(const void* x, const void* dt, const void* a, const void* b,
          const void* c, void* y, void* scratch, int B, int S, int H, int G,
          int P, int n, int L, int nsplit, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    ssd_f32::Args p =
        ssd_f32::shape_args(B, S, H, G, P, n, L, nsplit, N, nsplit * PB);
    p.x = static_cast<const float*>(x);
    p.dt = static_cast<const float*>(dt);
    p.a = static_cast<const float*>(a);
    p.b = static_cast<const float*>(b);
    p.c = static_cast<const float*>(c);
    p.y = static_cast<float*>(y);
    p.scratch = static_cast<float*>(scratch);
    return f32::launch<PB, N, PAD>(p, s);
  } else {
    return tc::launch<PB, N, PAD>(x, dt, a, b, c, y, B, S, H, G, P, n, L,
                                  nsplit, s);
  }
}

// N: the real state width, padded to 16, 32, 64 or 128 with PAD; PB the
// slice's padded rows
template <typename T, int PB, bool PAD>
int dispatch_n(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, void* scratch, int B, int S, int H,
               int G, int P, int N, int L, int nsplit, cudaStream_t s) {
  const int nw = PAD ? ssd_f32::pad_n(N) : N;
  switch (nw) {
    case 16: return route<T, PB, 16, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                          H, G, P, N, L, nsplit, s);
    case 32: return route<T, PB, 32, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                          H, G, P, N, L, nsplit, s);
    case 64: return route<T, PB, 64, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                          H, G, P, N, L, nsplit, s);
    case 128: return route<T, PB, 128, PAD>(x, dt, a, b, c, y, scratch, B,
                                            S, H, G, P, N, L, nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// PB: the slice's rows, ceil(P / nsplit), padded to 16, 32 or 64 with PAD
template <typename T, bool PAD>
int dispatch(const void* x, const void* dt, const void* a, const void* b,
             const void* c, void* y, void* scratch, int B, int S, int H,
             int G, int P, int N, int L, int nsplit, cudaStream_t s) {
  const int pb = (P + nsplit - 1) / nsplit;
  const int pw = PAD ? ssd_f32::pad_p(pb) : pb;
  switch (pw) {
    case 16: return dispatch_n<T, 16, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                           H, G, P, N, L, nsplit, s);
    case 32: return dispatch_n<T, 32, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                           H, G, P, N, L, nsplit, s);
    case 64: return dispatch_n<T, 64, PAD>(x, dt, a, b, c, y, scratch, B, S,
                                           H, G, P, N, L, nsplit, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

namespace ssd_parts {
#if PART(1)
int padded_f32(const void* x, const void* dt, const void* a, const void* b,
               const void* c, void* y, void* scratch, int B, int S, int H,
               int G, int P, int N, int L, int nsplit, void* stream) {
  return dispatch<float, true>(x, dt, a, b, c, y, scratch, B, S, H, G, P, N,
                               L, nsplit, static_cast<cudaStream_t>(stream));
}
#endif
#if PART(2)
int padded_tc(const void* x, const void* dt, const void* a, const void* b,
              const void* c, void* y, int B, int S, int H, int G, int P,
              int N, int L, int nsplit, void* stream) {
  return dispatch<__nv_bfloat16, true>(x, dt, a, b, c, y, nullptr, B, S, H,
                                       G, P, N, L, nsplit,
                                       static_cast<cudaStream_t>(stream));
}
#endif
}  // namespace ssd_parts

#if PART(0)
// x, b, c, y: dtype 0 = float32, 1 = bfloat16; dt and a float32. All
// contiguous, 16-byte aligned. P and N in 1 ... 128, ceil(P / nsplit) <=
// 64 with no slice empty, H % G == 0, S % L == 0. P / nsplit in {16, 32,
// 64} and N in {16, 32, 64, 128} run their exact instantiations, any
// other sizes the padded ones. float32 takes nsplit = ceil(P / 64) only
// and a scratch of at least ssd_f32::layout(...).floats floats (16-byte
// aligned; scratch_bytes its size), which it overwrites; bfloat16 reads no
// scratch. Returns cudaGetLastError() after the last launch.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, void* y,
                               void* scratch, size_t scratch_bytes, int B,
                               int S, int H, int G, int P, int N, int L,
                               int nsplit, int dtype, void* stream) {
  if (B < 0 || S < 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      S % L != 0 || nsplit <= 0 || P < 1 || P > 128 || N < 1 || N > 128 ||
      (P + nsplit - 1) / nsplit > 64 ||
      (nsplit - 1) * ((P + nsplit - 1) / nsplit) >= P ||
      size_t(B) * H * nsplit > 0x7fffffffu || (dtype != 0 && dtype != 1))
    return int(cudaErrorInvalidValue);
  if (dtype == 0) {
    if (nsplit != (P + 63) / 64) return int(cudaErrorInvalidValue);
    const int pb = (P + nsplit - 1) / nsplit;
    const size_t need = ssd_f32::layout(B, S, H, G, L, ssd_f32::pad_n(N),
                                        nsplit * ssd_f32::pad_p(pb))
                            .floats * sizeof(float);
    if (scratch_bytes < need || (need > 0 && scratch == nullptr) ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
      return int(cudaErrorInvalidValue);
  }
  const int pb = P / nsplit;
  const bool exact = P % nsplit == 0 && (pb == 16 || pb == 32 || pb == 64) &&
                     (N == 16 || N == 32 || N == 64 || N == 128);
  if (!exact)
    return dtype == 0
               ? ssd_parts::padded_f32(x, dt, a, b, c, y, scratch, B, S, H,
                                       G, P, N, L, nsplit, stream)
               : ssd_parts::padded_tc(x, dt, a, b, c, y, B, S, H, G, P, N,
                                      L, nsplit, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float, false>(x, dt, a, b, c, y, scratch, B, S, H, G, P,
                                  N, L, nsplit, s);
  return dispatch<__nv_bfloat16, false>(x, dt, a, b, c, y, nullptr, B, S, H,
                                        G, P, N, L, nsplit, s);
}

// The float32 route's plan for these shapes, as ssd_scan_launch runs it:
// out[0 .. 6] = nsplit, (head, P slice) units a step-C block, step A's
// blocks, step B's grid (x, y; 0, 0 with one chunk: no step B), step C's
// blocks, the scratch's bytes. ssd_scan.f32_plan computes the same in
// Python from the shapes; the card tests hold the two to each other.
extern "C" int ssd_f32_plan(int B, int S, int H, int G, int P, int N, int L,
                            long long* out) {
  if (B < 0 || S < 0 || H <= 0 || G <= 0 || H % G != 0 || L <= 0 ||
      S % L != 0 || P < 1 || P > 128 || N < 1 || N > 128 || out == nullptr)
    return int(cudaErrorInvalidValue);
  const int nsplit = (P + 63) / 64;
  const int pb = (P + nsplit - 1) / nsplit;
  const ssd_f32::Args p =
      ssd_f32::shape_args(B, S, H, G, P, N, L, nsplit, ssd_f32::pad_n(N),
                          nsplit * ssd_f32::pad_p(pb));
  const ssd_f32::Grids g = ssd_f32::grids(p);
  out[0] = nsplit;
  out[1] = ssd_f32::kUnits;
  out[2] = static_cast<long long>(g.a);
  out[3] = p.nc > 1 ? g.b_x : 0;
  out[4] = p.nc > 1 ? g.b_y : 0;
  out[5] = static_cast<long long>(g.c);
  out[6] = static_cast<long long>(
      ssd_f32::layout(B, S, H, G, L, p.NW, p.PW).floats * sizeof(float));
  return 0;
}
#endif
