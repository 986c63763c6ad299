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
// sliding-window band; masked V is zeroed by a select so NaN or garbage in
// unwritten page tails (the scratch page included) never reaches an
// output. The output is acc / max(l, 1e-30) in the q dtype.
//
// K4 has one body per input dtype, chosen in paged_prefill_launch:
// - bfloat16: paged_prefill_tc_kernel, the tensor-core tile core of
//   attention_tc.cuh (bf16 mma.sync, cp.async double-buffering; each key
//   row's page looked up per column, so any page size 1-64 works; rows at
//   or past the slot's length zero-filled by the copy). One block of 64
//   threads (2 warps, 32 rows = 32 / rep tokens x rep heads) per (tile,
//   slot, kv head): a chunk of C 512 at rep 2 is 32 tiles x 8 kv heads =
//   256 blocks, more than one wave on 132 SMs;
// - float32: paged_prefill_kernel over attend_tile below, the body behind
//   the tight float32 checks (1e-5 against the twin).
// K3 runs attend_tile for both dtypes.
//
// attend_tile design (simple first):
// - one thread block of 128 threads per (slot, kv_head) for decode and per
//   (slot, q-tile of bq = 32/rep tokens, kv_head) for prefill; a block
//   reads its own table row, length and start (no scalar prefetch here);
// - a dead decode slot (len = width*page + 1, past its table) returns
//   zeros at once; every other page loop is bounded by ceil(len/page)
//   (<= npages) and by the tile's causal and window reach [first, last],
//   so no block reads its table row out of bounds and unreachable pages
//   cost nothing;
// - each iteration stages up to 64 key columns (64/page pages) of K and V
//   in shared memory with 16-byte loads, converted to float32; q rows stay
//   in shared memory for the whole block; ragged prefill tails are masked
//   rows, so a chunk of any length C runs (no C % bq requirement);
// - scores are one thread per (row, column), the softmax one warp per row,
//   P.V one thread per (row, d) with the accumulators in registers. All
//   arithmetic is float32 on the CUDA cores.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 dense):
// - K3 is memory-bound. Per layer it must read the live KV,
//   2 * sum_slots ceil(len/16)*16 * Hkv * D * 2 bytes (4 KiB per token per
//   layer at Qwen3-1.7B: Hkv 8, D 128, bf16), at ~1 FLOP per byte.
// - K4 is bound by FLOPs or bytes, whichever is larger: 4 * Hq * D FLOPs
//   per (query, attended key) pair against the pages of starts + C.
// What the designs leave on the table: K3 launches B*Hkv blocks, 64 at 8
// slots on 132 SMs, and walks a long context serially inside one block
// (split-K across blocks is the fix), on the CUDA cores in float32 with
// no cp.async double-buffering. K4's bf16 body walks up to starts + C
// keys serially in each block (1536 at start 1024, C 512).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_tc.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kMaxRows = 32;    // query rows (tokens x rep) per block
constexpr int kTileK = 64;      // key columns staged per iteration
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
  __device__ __forceinline__ static float store(float x) { return x; }
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
  __device__ __forceinline__ static __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return size_t(kTileK) * (D + 1) + size_t(kTileK) * D +
         size_t(kMaxRows) * (D + 1) + size_t(kMaxRows) * kTileK +
         3 * size_t(kMaxRows);
}

// One block's work: `rows` query rows against pages [first, last] of one
// slot's table row. Row r is token r / rep of the tile (absolute position
// pos0 + r / rep) and query head (kvh * rep + r % rep); q and out point at
// the tile's first token and the kv head's first query head, tokens
// `tok_stride` elements apart. V is zeroed outside [v_lo, length).
// Not inlined: inlined into paged_prefill_kernel, nvcc 12.9 at -O3
// produced code that skipped the page loop (all-zero outputs) on an H100,
// while the same body called out of line is correct.
template <typename T, int D>
__device__ __noinline__ void attend_tile(
    const T* __restrict__ q, const T* __restrict__ kp,
    const T* __restrict__ vp, const int* __restrict__ table_row,
    T* __restrict__ out, int rows, int rep, int tok_stride, int pos0,
    int length, int v_lo, int first, int last, int kvh, int Hkv,
    int page_size, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                          // kTileK x (D + 1)
  float* Vs = Ks + kTileK * (D + 1);         // kTileK x D
  float* Qs = Vs + kTileK * D;               // kMaxRows x (D + 1)
  float* Ps = Qs + kMaxRows * (D + 1);       // kMaxRows x kTileK
  float* m_s = Ps + kMaxRows * kTileK;
  float* l_s = m_s + kMaxRows;
  float* a_s = l_s + kMaxRows;

  constexpr int VN = Vec<T>::N;
  constexpr int DV = D / VN;
  constexpr int PT = kMaxRows * D / kThreads;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < rows * DV; i += kThreads) {
    const int r = i / DV, v = i % DV;
    float t[VN];
    Vec<T>::load(q + size_t(r / rep) * tok_stride + (r % rep) * D + v * VN,
                 t);
#pragma unroll
    for (int e = 0; e < VN; ++e) Qs[r * (D + 1) + v * VN + e] = t[e];
  }
  if (tid < kMaxRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[PT];
#pragma unroll
  for (int k = 0; k < PT; ++k) acc[k] = 0.f;

  const int ppi = kTileK / page_size;        // pages per iteration
  const size_t row_stride = size_t(Hkv) * D;
  for (int j0 = first; j0 <= last; j0 += ppi) {
    const int npg = min(ppi, last - j0 + 1);
    const int ncols = npg * page_size;
    const int col0 = j0 * page_size;
    __syncthreads();   // previous tile consumed; q and m/l visible
    for (int i = tid; i < ncols * DV; i += kThreads) {
      const int c = i / DV, v = i % DV;
      const int phys = table_row[j0 + c / page_size];
      const size_t off = (size_t(phys) * page_size + c % page_size) *
                             row_stride + size_t(kvh) * D + v * VN;
      float tk[VN], tv[VN];
      Vec<T>::load(kp + off, tk);
      Vec<T>::load(vp + off, tv);
      const int col = col0 + c;
      const bool vok = col >= v_lo && col < length;
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        Ks[c * (D + 1) + v * VN + e] = tk[e];
        Vs[c * D + v * VN + e] = vok ? tv[e] : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < rows * ncols; i += kThreads) {
      const int r = i / ncols, c = i % ncols;
      const float* qr = Qs + r * (D + 1);
      const float* kc = Ks + c * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kc[d], s);
      s *= scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      const int col = col0 + c, pq = pos0 + r / rep;
      const bool ok = col <= pq && (window < 0 || col > pq - window);
      Ps[r * kTileK + c] = ok ? s : kNegInf;
    }
    __syncthreads();
    for (int r = warp; r < rows; r += kThreads / 32) {
      float* pr = Ps + r * kTileK;
      float mloc = kNegInf;
      for (int c = lane; c < ncols; c += 32) mloc = fmaxf(mloc, pr[c]);
      mloc = warp_max(mloc);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mloc);
      float sum = 0.f;
      for (int c = lane; c < ncols; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < PT; ++k) {
      const int idx = tid + k * kThreads;
      const int r = idx / D, d = idx % D;
      if (r < rows) {
        const float* pr = Ps + r * kTileK;
        float a = acc[k] * a_s[r];
        for (int c = 0; c < ncols; ++c) a = fmaf(pr[c], Vs[c * D + d], a);
        acc[k] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PT; ++k) {
    const int idx = tid + k * kThreads;
    const int r = idx / D, d = idx % D;
    if (r < rows) {
      const float l = fmaxf(l_s[r], 1e-30f);
      out[size_t(r / rep) * tok_stride + (r % rep) * D + d] =
          Vec<T>::store(acc[k] / l);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Hq, int Hkv, int page_size, int npages, int window,
                    float softcap, float scale) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int rep = Hq / Hkv;
  const int length = lengths[b];
  const size_t qoff = (size_t(b) * Hq + size_t(kvh) * rep) * D;
  // A dead slot (finished or inactive) sits at length = width * page + 1,
  // past its table: its output is discarded, so it walks no page and
  // writes zeros (the twin's row for it is junk of the scratch page).
  if (length > npages * page_size) {
    for (int i = threadIdx.x; i < rep * D; i += kThreads)
      out[qoff + i] = Vec<T>::store(0.f);
    return;
  }
  const int live = (length + page_size - 1) / page_size;
  int first = 0, v_lo = 0;
  if (window >= 0) {
    v_lo = length - window;      // band: col > length - 1 - window
    first = v_lo > 0 ? v_lo / page_size : 0;
  }
  attend_tile<T, D>(q + qoff, kp, vp, table + size_t(b) * npages,
                    out + qoff, rep, rep, Hq * D, length - 1, length, v_lo,
                    first, live - 1, kvh, Hkv, page_size, window, softcap,
                    scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ table,
                     const int* __restrict__ lengths,
                     const int* __restrict__ starts, T* __restrict__ out,
                     int C, int Hq, int Hkv, int page_size, int npages,
                     int window, float softcap, float scale) {
  const int b = blockIdx.x, tile = blockIdx.y, kvh = blockIdx.z;
  const int rep = Hq / Hkv;
  const int bq = kMaxRows / rep;
  const int tok0 = tile * bq;
  const int ntok = min(bq, C - tok0);       // ragged last tile: fewer rows
  const int length = lengths[b];
  const int q0 = starts[b] + tok0;
  const int last_live = max((length + page_size - 1) / page_size - 1, 0);
  const int last = min(min(last_live, (q0 + ntok - 1) / page_size),
                       npages - 1);
  int first = 0;
  if (window >= 0) {
    const int lo = q0 - window + 1;
    first = lo > 0 ? lo / page_size : 0;
  }
  const size_t qoff =
      ((size_t(b) * C + tok0) * Hq + size_t(kvh) * rep) * D;
  attend_tile<T, D>(q + qoff, kp, vp, table + size_t(b) * npages,
                    out + qoff, ntok * rep, rep, Hq * D, q0, length, 0,
                    first, last, kvh, Hkv, page_size, window, softcap, scale);
}

template <int D>
__global__ void __launch_bounds__(64)
paged_prefill_tc_kernel(const attn_tc::bf16* __restrict__ q,
                        const attn_tc::bf16* __restrict__ kp,
                        const attn_tc::bf16* __restrict__ vp,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths,
                        const int* __restrict__ starts,
                        attn_tc::bf16* __restrict__ out, int C, int Hq,
                        int Hkv, int page_size, int npages, int window,
                        float softcap, float scale) {
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
  a.causal = 1;
  a.window = window;
  a.softcap = softcap;
  a.scale = scale;
  const attn_tc::PagedKeys keys{table + size_t(b) * npages, page_size,
                                size_t(kvh) * D, size_t(Hkv) * D};
  attn_tc::attend_tc<D, 2, 1>(a, kp, vp, keys);
}

bool shape_ok(int Hq, int Hkv, int D, int page_size) {
  return Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= kMaxRows &&
         (D == 64 || D == 128 || D == 256) && page_size >= 1 &&
         page_size <= kTileK;
}

template <typename T, int D>
int launch_decode(const void* q, const void* kp, const void* vp,
                  const void* table, const void* lengths, void* out, int B,
                  int Hq, int Hkv, int page_size, int npages, int window,
                  float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0) return int(cudaGetLastError());
  kern<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<T*>(out), Hq, Hkv,
      page_size, npages, window, softcap, 1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <typename T, int D>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   const void* table, const void* lengths, const void* starts,
                   void* out, int B, int C, int Hq, int Hkv, int page_size,
                   int npages, int window, float softcap,
                   cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  if (B == 0 || C == 0) return int(cudaGetLastError());
  const int bq = kMaxRows / (Hq / Hkv);
  kern<<<dim3(B, (C + bq - 1) / bq, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<const int*>(starts),
      static_cast<T*>(out), C, Hq, Hkv, page_size, npages, window, softcap,
      1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// bfloat16 only (T is the pools' element type, for DISPATCH_D)
template <typename T, int D>
int launch_prefill_tc(const void* q, const void* kp, const void* vp,
                      const void* table, const void* lengths,
                      const void* starts, void* out, int B, int C, int Hq,
                      int Hkv, int page_size, int npages, int window,
                      float softcap, cudaStream_t stream) {
  constexpr size_t smem = attn_tc::smem_bytes<D, 2, 1>();
  auto kern = paged_prefill_tc_kernel<D>;
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
      window, softcap, 1.0f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

#define DISPATCH_D(T, FN, ...)                                   \
  switch (D) {                                                   \
    case 64: return FN<T, 64>(__VA_ARGS__);                      \
    case 128: return FN<T, 128>(__VA_ARGS__);                    \
    case 256: return FN<T, 256>(__VA_ARGS__);                    \
    default: return int(cudaErrorInvalidValue);                 \
  }

// dtype: 0 = float32, 1 = bfloat16. window < 0: no sliding window.
// softcap <= 0: no softcap. Returns cudaGetLastError() after the launch.
extern "C" int paged_decode_launch(const void* q, const void* kp,
                                   const void* vp, const void* table,
                                   const void* lengths, void* out, int B,
                                   int Hq, int Hkv, int D, int page_size,
                                   int npages, int window, float softcap,
                                   int dtype, void* stream) {
  if (!shape_ok(Hq, Hkv, D, page_size)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_D(float, launch_decode, q, kp, vp, table, lengths, out, B, Hq,
               Hkv, page_size, npages, window, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(__nv_bfloat16, launch_decode, q, kp, vp, table, lengths, out,
               B, Hq, Hkv, page_size, npages, window, softcap, s)
  }
  return int(cudaErrorInvalidValue);
}

extern "C" int paged_prefill_launch(const void* q, const void* kp,
                                    const void* vp, const void* table,
                                    const void* lengths, const void* starts,
                                    void* out, int B, int C, int Hq, int Hkv,
                                    int D, int page_size, int npages,
                                    int window, float softcap, int dtype,
                                    void* stream) {
  if (!shape_ok(Hq, Hkv, D, page_size)) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    DISPATCH_D(float, launch_prefill, q, kp, vp, table, lengths, starts, out,
               B, C, Hq, Hkv, page_size, npages, window, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(__nv_bfloat16, launch_prefill_tc, q, kp, vp, table, lengths,
               starts, out, B, C, Hq, Hkv, page_size, npages, window,
               softcap, s)
  }
  return int(cudaErrorInvalidValue);
}
