// Hopper kernel of the serving decode step: paged GQA decode attention over
// the hash-indexed KV page pool.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attn.py paged_attention (_paged_attn_kernel)
// For each sequence b and kv head h it attends the G query heads of that
// group over the live tokens of b, page by page through page_table[b]:
// positions >= seq_lens[b] and pages with an id < 0 are masked; scores,
// running max, sum and accumulator are float32 (online softmax); the output
// is acc / max(l, 1e-30) in q's type.
//
// Bound: device-memory bytes.  The function must read each live token's K
// and V row once (2 * D * sizeof(T) bytes per token per kv head) plus q and
// the page table, and write the output; it does 4 * D flops per token per
// query head, about G / sizeof(T) flops per byte read (4 at bf16, G = 8),
// far below the card's ~295 flops per byte.
//
// Design (simple first): one block of 8 warps per (b, kv head, group of up
// to 8 query heads), one warp per query head.  The block walks the live
// tokens in tiles of 32 rows (16 for float32).  Each thread resolves the
// physical page of the rows it copies through the page table (rows of
// unmapped pages are never read) and loads them with 16-byte loads into
// registers one tile ahead, so the next tile's loads are in flight while
// the warps work on the current one out of shared memory (rows padded by
// 8 elements, so a quarter-warp's 16-byte bf16 reads of 8 rows hit
// distinct banks).  Scores: one lane per token (two for float32, combined
// by one shuffle), dot products against the head's q row held in shared
// memory as float32, no per-token reduction.  Softmax: one warp max and one warp
// sum per tile.  P.V: lanes own head dims (d = lane + 32 i); each token's
// probability is broadcast by a shuffle.  Only pages below
// ceil(seq_lens[b] / PS) are visited: pages past the length add nothing to
// the softmax, so stopping there is exact.  Still one wave of B * KVH
// blocks (132 SMs) with one tile in flight per block: split-KV over pages,
// TMA and wgmma are later work.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadsPerBlock = 8;   // one warp per query head
constexpr int kThreads = kHeadsPerBlock * 32;
constexpr int kMaxD = 256;
constexpr int kDimsPerLane = kMaxD / 32;
constexpr int kPad = 8;             // shared-memory row padding, elements
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// dot of 16 bytes of T (8 bf16 or 4 f32) with the matching floats of q
__device__ __forceinline__ float dot16(uint4 k, const float* q,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&k);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    s = fmaf(f.x, q[2 * i], s);
    s = fmaf(f.y, q[2 * i + 1], s);
  }
  return s;
}
__device__ __forceinline__ float dot16(uint4 k, const float* q, float) {
  float s = __uint_as_float(k.x) * q[0];
  s = fmaf(__uint_as_float(k.y), q[1], s);
  s = fmaf(__uint_as_float(k.z), q[2], s);
  return fmaf(__uint_as_float(k.w), q[3], s);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                  const T* __restrict__ vpool,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                  int H, int KVH, int D, int NP, int PS, int MAXP,
                  float scale) {
  constexpr int kTile = 64 / static_cast<int>(sizeof(T));  // 32 bf16, 16 f32
  constexpr int kLanesPerTok = 32 / kTile;
  constexpr int kElems = 16 / static_cast<int>(sizeof(T));  // per uint4
  // uint4 loads per thread per tensor per tile, at most (kTile*kMaxD/kElems)
  // / kThreads = 4
  constexpr int kLoads = kTile * kMaxD / kElems / kThreads;
  __shared__ __align__(16) T ks[kTile * (kMaxD + kPad)];
  __shared__ __align__(16) T vs[kTile * (kMaxD + kPad)];
  __shared__ __align__(16) float qs[kHeadsPerBlock * kMaxD];
  __shared__ int live[kTile];  // row of the tile is mapped and below len

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.y * kHeadsPerBlock;
  const bool active = g0 + warp < G;  // uniform across the warp
  const size_t qo = (static_cast<size_t>(b) * H + h * G + g0 + warp) * D;
  const int vpr = D / kElems;          // uint4 per row
  // padded shared-memory row stride, in uint4
  const int ws = (D + kPad) * static_cast<int>(sizeof(T)) / 16;
  const int32_t* pt_row = page_table + static_cast<size_t>(b) * MAXP;

  for (int i = threadIdx.x; i < kHeadsPerBlock * D; i += kThreads) {
    const int w = i / D;
    qs[w * kMaxD + i % D] =
        g0 + w < G ? to_f(q[(static_cast<size_t>(b) * H + h * G + g0 + w) * D +
                            i % D])
                   : 0.f;
  }
  int len = seq_lens[b];
  len = len < 0 ? 0 : (len > MAXP * PS ? MAXP * PS : len);

  // -- registers one tile ahead ---------------------------------------------
  uint4 kr[kLoads], vr[kLoads];
  unsigned loaded = 0;  // bit k: kr[k]/vr[k] hold a live row's chunk
  auto issue = [&](int t0) {
    const int n = min(kTile, len - t0);
    loaded = 0;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = threadIdx.x + k * kThreads;
      const int r = i / vpr;
      if (r < n) {
        const int j = t0 + r;
        const int pt = __ldg(pt_row + j / PS);
        if (pt >= 0 && pt < NP) {
          const size_t row = ((static_cast<size_t>(pt) * KVH + h) * PS +
                              j % PS) * D;
          const int c = i - r * vpr;
          kr[k] = __ldg(reinterpret_cast<const uint4*>(kpool + row) + c);
          vr[k] = __ldg(reinterpret_cast<const uint4*>(vpool + row) + c);
          loaded |= 1u << k;
        }
      }
    }
  };

  uint4* k4 = reinterpret_cast<uint4*>(ks);
  uint4* v4 = reinterpret_cast<uint4*>(vs);
  const float* qw = qs + warp * kMaxD;
  const int tok = lane % kTile;
  const int part = lane / kTile;

  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  if (len > 0) issue(0);
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int n = min(kTile, len - t0);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (loaded >> k & 1u) {
        const int i = threadIdx.x + k * kThreads;
        const int r = i / vpr;
        k4[r * ws + (i - r * vpr)] = kr[k];
        v4[r * ws + (i - r * vpr)] = vr[k];
      }
    }
    if (threadIdx.x < kTile) {
      const int j = t0 + threadIdx.x;
      int ok = 0;
      if (static_cast<int>(threadIdx.x) < n) {
        const int pt = __ldg(pt_row + j / PS);
        ok = pt >= 0 && pt < NP;
      }
      live[threadIdx.x] = ok;
    }
    __syncthreads();
    if (t0 + kTile < len) issue(t0 + kTile);  // in flight during the math
    if (active) {
      // scores: lane -> token (two lanes per token for float32)
      float s = 0.f;
      for (int c = part; c < vpr; c += kLanesPerTok)
        s += dot16(k4[tok * ws + c], qw + c * kElems, T());
      if (kLanesPerTok == 2) s += __shfl_xor_sync(kFull, s, 16);
      s = live[tok] ? s * scale : -INFINITY;
      const float m_new = fmaxf(m, warp_max(s));
      if (m_new != -INFINITY) {  // else the tile and all before are masked
        const float alpha = expf(m - m_new);
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        l = l * alpha + warp_sum(part == 0 ? p : 0.f);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= alpha;
        for (int t = 0; t < n; ++t) {
          const float pr = __shfl_sync(kFull, p, t);
          if (pr > 0.f) {  // masked rows hold stale shared memory
            const T* vrow = vs + t * ws * kElems;
#pragma unroll
            for (int i = 0; i < kDimsPerLane; ++i) {
              const int d = lane + 32 * i;
              if (d < D) acc[i] = fmaf(pr, to_f(vrow[d]), acc[i]);
            }
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[qo + d] = from_f<T>(acc[i] / denom);
    }
  }
}

template <typename T>
void launch(const void* q, const void* kpool, const void* vpool,
            const void* page_table, const void* seq_lens, void* out, int B,
            int H, int KVH, int D, int NP, int PS, int MAXP, float scale,
            cudaStream_t stream) {
  const int G = H / KVH;
  const dim3 grid(B * KVH, (G + kHeadsPerBlock - 1) / kHeadsPerBlock);
  const dim3 block(kThreads);
  paged_attn_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kpool),
      static_cast<const T*>(vpool), static_cast<const int32_t*>(page_table),
      static_cast<const int32_t*>(seq_lens), static_cast<T*>(out), H, KVH, D,
      NP, PS, MAXP, scale);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, both pools and out).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int paged_attn_launch(int dtype, const void* q, const void* kpool,
                                 const void* vpool, const void* page_table,
                                 const void* seq_lens, void* out, int B, int H,
                                 int KVH, int D, int NP, int PS, int MAXP,
                                 float scale, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH || D <= 0 || D > kMaxD || D % 8 || PS <= 0 ||
      MAXP <= 0 || NP <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      launch<float>(q, kpool, vpool, page_table, seq_lens, out, B, H, KVH, D,
                    NP, PS, MAXP, scale, s);
      break;
    case 1:
      launch<__nv_bfloat16>(q, kpool, vpool, page_table, seq_lens, out, B, H,
                            KVH, D, NP, PS, MAXP, scale, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
