// Hopper kernel of the serving decode step: paged GQA decode attention over
// the hash-indexed KV page pool.
//
// Replaces the TPU kernel
//   src/repro/kernels/paged_attn.py paged_attention (_paged_attn_kernel)
// For each sequence b and kv head h it attends the G query heads of that
// group over the live tokens of b, page by page through page_table[b]:
// positions >= seq_lens[b] and pages with an id < 0 or >= NP are masked;
// scores, running max, sum and accumulator are float32 (online softmax);
// the output is acc / max(l, 1e-30) in q's type, zeros for a sequence with
// no live token.
//
// Bound: device-memory bytes.  The function must read each live token's K
// and V row once (2 * D * sizeof(T) bytes per token per kv head) plus q and
// the page table, and write the output; it does 4 * D flops per token per
// query head, about G / sizeof(T) flops per byte read (4 at bf16, G = 8),
// far below the card's ~295 flops per byte.  Reaching the byte bound takes
// every SM busy, enough bytes in flight on each (~25 KB: 3.35 TB/s times
// ~1 us of latency over 132 SMs) and arithmetic that hides under the loads.
//
// Design (split-KV, flash-decoding):
// - Grid (B * KVH, splits, head groups).  Each block walks one contiguous
//   range of logical pages of one (sequence, kv head) and writes float32
//   partials (m, l, acc[D]) per query head to a workspace; a second kernel,
//   launched from the same entry with programmatic dependent launch (so
//   its launch overlaps the first kernel's tail), merges the splits of
//   each head in split order.  The host picks `splits` from B * KVH, MAXP,
//   the SM count and the blocks one SM holds of the instantiation it
//   launches (paged_attn_resident_blocks, the runtime's occupancy for its
//   registers and shared memory): one wave of resident blocks, so a small
//   batch fills the card too, and no block pays the start and the merge
//   twice.  No float atomics: the output is bit-reproducible.  A split
//   past the length writes m = -inf, l = 0, and the merge skips it (it
//   never forms exp(-inf - -inf)).
// - bfloat16: 4 warps, each an independent online softmax over its own
//   16-token tiles (tile k of the block goes to warp k % 4); the warps'
//   states are merged through shared memory at the end.  Each warp keeps a
//   ring of 3 tiles in shared memory filled by TMA bulk copies
//   (cp.async.bulk), completing on one mbarrier per stage: two tiles in
//   flight while it computes the third (~2 x 8 KB per warp at D = 128,
//   ~128 KB per SM at two blocks).  Each lane resolves one token's
//   physical row through the page table (the block reads its own page
//   ids) and copies that row of K (lanes 0-15) or V (lanes 16-31), one
//   copy instruction per tile; rows of unmapped pages and rows past the
//   length are zeroed instead and never read.  The copies land in rows
//   padded by 8 elements, so the 8 rows of each ldmatrix phase fall on
//   distinct banks (a 1-D copy of a whole 256-byte-stride page would not).
//   The length, q and the first page ids are loaded together, and the
//   first tiles' copies go out before q is staged.
//   S = q K^T and P V run on the tensor cores with mma.sync.m16n8k16
//   (bf16 in, float32 accumulate): the group's query heads, zero-padded to
//   16 rows, are the A operand; K is read with ldmatrix; the scale is
//   applied to S in float32; P stays in registers, the accumulator
//   fragment of S reused as the A operand of P V, split into a bf16 high
//   part and the bf16 rounding of its remainder, both multiplied by V
//   (two mma each, ~1 % of the kernel's time): P keeps ~16 significant
//   bits, as the reference's float32 P does, where P rounded to bf16 once
//   would change a third of the bf16 outputs by an ulp; V is read with
//   ldmatrix.trans.  D is padded to a multiple of 16 with zero
//   columns in shared memory.  wgmma is not used: its 64-row tile would
//   leave 7/8 of every product idle at G = 8, and the kernel is bound by
//   bytes, not by the tensor cores.
// - float32: the same grid, partials and merge, with CUDA-core FMAs (TF32
//   tensor cores would keep ~3 digits): one warp per query head, 16-token
//   tiles staged through registers one tile ahead.
// - int8 pools (kv_dtype "int8", q and out float32 or bfloat16): the
//   float32 kernel's loop, each pool row read as int8 (8 bytes per lane
//   load) with its float32 scale and dequantized while it is staged into
//   the shared tile, float(q8) * scale rounded to q's type as the plain
//   version's (q8.float() * scale).to(dtype), then the same float32
//   softmax and merge.  Bound: bytes, 2 * D + 8 per live token per kv
//   head (264 at D 128, against 512 in bf16): the pools are never
//   dequantized in device memory.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kMaxD = 256;
constexpr unsigned kFull = 0xffffffffu;

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

// first and one-past-last token of a split's page range, clipped to len
__device__ __forceinline__ void split_tokens(int split, int pages_per_split,
                                             int PS, int len, int* tb,
                                             int* te) {
  const long long b = static_cast<long long>(split) * pages_per_split * PS;
  const long long e = b + static_cast<long long>(pages_per_split) * PS;
  *tb = static_cast<int>(b < len ? b : len);
  *te = static_cast<int>(e < len ? e : len);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, TMA ring
// ---------------------------------------------------------------------------

constexpr int kRows = 16;    // query heads per block: the mma's M
constexpr int kWarps = 4;
constexpr int kTok = 16;     // tokens per warp tile: the K of P V
constexpr int kStages = 3;   // tiles per warp in the ring
constexpr int kPad = 8;      // shared-memory row padding, elements

__host__ __device__ constexpr int padded_d(int D) { return (D + 15) & ~15; }

// [mbarriers][q rows][ring][warp states (m, l)][live masks]
constexpr int kBarBytes = 128;  // kWarps * kStages mbarriers, 8 bytes each
static_assert(kWarps * kStages * 8 <= kBarBytes, "mbarrier area too small");
__host__ __device__ constexpr int bf16_smem_bytes(int D) {
  return kBarBytes +
         (kRows + kStages * kWarps * 2 * kTok) * (padded_d(D) + kPad) * 2 +
         kWarps * kRows * 8 + kWarps * kStages * 4;
}

// programmatic dependent launch: the merge kernel is launched while the
// split kernel runs and waits in griddep_wait() until its results are
// complete and visible, so the launch gap between the two is hidden
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier of one ring stage: one arrival (with the stage's byte count)
// plus the bytes of its bulk copies complete a phase
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
}
// TMA bulk copy of `bytes` (a multiple of 16) global -> shared, completing
// on the mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two floats as a packed bf16 pair (*hi) and the packed bf16 rounding of
// what that pair leaves of them (*lo): hi + lo keeps ~16 significant bits
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  *hi = pack_bf16(a, b);
  *lo = pack_bf16(a - __uint_as_float(*hi << 16),
                  b - __uint_as_float(*hi & 0xffff0000u));
}

// kNt: the most 8-wide dim tiles (padded D / 8) this instantiation takes
template <int kNt>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ kpool,
                  const bf16* __restrict__ vpool,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ seq_lens,
                  float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                  int H, int KVH, int D, int NP, int PS, int MAXP,
                  int pages_per_split, int splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_d(D);
  const int ld = Dp + kPad;
  const uint32_t bars = smem_u32(smem);                  // [kWarps][kStages]
  bf16* qs = reinterpret_cast<bf16*>(smem + kBarBytes);  // [kRows][ld]
  bf16* ring = qs + kRows * ld;  // [kStages][kWarps][K, V][kTok][ld]
  float2* red_ml = reinterpret_cast<float2*>(
      ring + kStages * kWarps * 2 * kTok * ld);           // [kWarps][kRows]
  // [kWarps][kStages]: live rows of each ring stage's tile, bit per token
  unsigned* live_s = reinterpret_cast<unsigned*>(red_ml + kWarps * kRows);
  float* red_acc = reinterpret_cast<float*>(ring);  // [kWarps][kRows][Dp]

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int split = blockIdx.y;
  const int G = H / KVH;
  const int g0 = blockIdx.z * kRows;
  const int rows = min(kRows, G - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(b) * H + h * G + g0;

  griddep_launch_dependents();  // the merge may launch and wait for us

  // Independent loads first, so their latencies overlap: the length, this
  // thread's chunks of q, and the page ids of the warp's first tiles
  // (speculative: the split's range and the table row bound them, the
  // length masks them below).
  const int len_raw = seq_lens[b];
  const int qchunks = Dp / 8;  // 16-byte chunks per q row, D padded
  uint4 qv[(kRows * kNt + kWarps * 32 - 1) / (kWarps * 32)];
#pragma unroll
  for (int k = 0; k < (kRows * kNt + kWarps * 32 - 1) / (kWarps * 32); ++k) {
    const int i = threadIdx.x + k * kWarps * 32;
    const int r = i / qchunks, c = i % qchunks;
    qv[k] = make_uint4(0, 0, 0, 0);
    if (r < rows && c * 8 < D)
      qv[k] = *reinterpret_cast<const uint4*>(q + (row0 + r) * D + c * 8);
  }
  const int32_t* pt_row = page_table + static_cast<size_t>(b) * MAXP;
  const int tb0 = static_cast<int>(
      min(static_cast<long long>(split) * pages_per_split * PS,
          static_cast<long long>(MAXP) * PS));
  const int t_end = min(tb0 + pages_per_split * PS, MAXP * PS);
  // page id of the lane's token (lane & 15) in this warp's i-th tile
  auto page_of = [&](int i) {
    const int j = tb0 + (warp + i * kWarps) * kTok + (lane & (kTok - 1));
    return j < t_end ? __ldg(pt_row + j / PS) : -1;
  };
  int pt_first[kStages - 1];
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) pt_first[st] = page_of(st);

  const int len = len_raw < 0 ? 0 : min(len_raw, MAXP * PS);
  int tb, te;
  split_tokens(split, pages_per_split, PS, len, &tb, &te);
  if (te <= tb) {  // nothing live in this split
    if (static_cast<int>(threadIdx.x) < rows)
      ws_ml[(row0 + threadIdx.x) * splits + split] =
          make_float2(-INFINITY, 0.f);
    return;
  }

  const int nchunks = (te - tb + kTok - 1) / kTok;
  const int mine = warp < nchunks ? (nchunks - 1 - warp) / kWarps + 1 : 0;
  const int sstride = kWarps * 2 * kTok * ld;  // one stage of all warps
  bf16* my = ring + warp * 2 * kTok * ld;
  const uint32_t my_bars = bars + warp * kStages * 8;
  if (lane == 0) {
    for (int st = 0; st < kStages; ++st) mbar_init(my_bars + st * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this warp's i-th tile into ring stage i % kStages (pt: page_of(i)):
  // lane r < 16 copies the K row of the tile's token r, lane 16 + r its V
  // row, each with one bulk copy; a masked row (past the length, or of an
  // unmapped page) is zeroed instead and never read
  auto issue = [&](int i, int pt) {
    const int st = i % kStages;
    const int j = tb + (warp + i * kWarps) * kTok + (lane & (kTok - 1));
    const int prow =
        j < te && pt >= 0 && pt < NP ? (pt * KVH + h) * PS + j % PS : -1;
    const unsigned live = __ballot_sync(kFull, prow >= 0) & 0xffffu;
    const uint32_t bar = my_bars + st * 8;
    if (lane == 0) {
      live_s[warp * kStages + st] = live;
      mbar_expect_tx(bar, __popc(live) * 2 * D * 2);
    }
    __syncwarp();
    bf16* dst = my + st * sstride + (lane >> 4) * kTok * ld + (lane & 15) * ld;
    if (prow >= 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(smem_u32(dst), (lane < kTok ? kpool : vpool) +
                                   static_cast<size_t>(prow) * D,
                D * 2, bar);
    } else {
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(0, 0, 0, 0);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st)
    if (st < mine) issue(st, pt_first[st]);

  // q rows of the group (zero rows past G, zero columns past D), and the
  // ring's pad columns D..Dp (never written by the copies) set to zero
#pragma unroll
  for (int k = 0; k < (kRows * kNt + kWarps * 32 - 1) / (kWarps * 32); ++k) {
    const int i = threadIdx.x + k * kWarps * 32;
    if (i < kRows * qchunks)
      *reinterpret_cast<uint4*>(qs + (i / qchunks) * ld + (i % qchunks) * 8) =
          qv[k];
  }
  if (Dp > D)
    for (int i = threadIdx.x; i < kStages * kWarps * 2 * kTok;
         i += blockDim.x)
      *reinterpret_cast<uint4*>(ring + i * ld + D) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // fragment coordinates (mma.m16n8k16): row g / g + 8, column pair 2t
  const int g = lane >> 2, t = lane & 3;
  const int nk = Dp / 16;
  // ldmatrix: lane -> row lr of 8x8 matrix lm
  const int lm = lane >> 3, lr = lane & 7;
  const uint32_t q_addr =
      smem_u32(qs + ((lm & 1) * 8 + lr) * ld + (lm >> 1) * 8);
  const int k_off = ((lm >> 1) * 8 + lr) * ld + (lm & 1) * 8;
  const int v_off = ((lm & 1) * 8 + lr) * ld + (lm >> 1) * 8;

  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    __syncwarp();  // every lane is done with the stage refilled here
    if (i + kStages - 1 < mine)
      issue(i + kStages - 1, page_of(i + kStages - 1));
    mbar_wait(my_bars + (i % kStages) * 8, (i / kStages) & 1);  // tile i
    const unsigned live = live_s[warp * kStages + i % kStages];
    const bf16* ks = my + (i % kStages) * sstride;
    const bf16* vs = ks + kTok * ld;

    // S (16 heads x 16 tokens) = q K^T, two 8-token n tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const uint32_t k_addr = smem_u32(ks + k_off);
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
      if (kk < nk) {
        uint32_t a[4], kb[4];
        ldmatrix_x4(a, q_addr + kk * 32);
        ldmatrix_x4(kb, k_addr + kk * 32);
        mma_bf16(s[0], a, kb[0], kb[1]);
        mma_bf16(s[1], a, kb[2], kb[3]);
      }
    }

    // online softmax on the fragment: element e of n tile j is row
    // g + 8 * (e >> 1), token 8 * j + 2 * t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = 8 * j + 2 * t + (e & 1);
        s[j][e] = live >> tok & 1u ? s[j][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      base[r] = mn == -INFINITY ? 0.f : mn;  // all masked so far: p = 0
      alpha[r] = expf(m[r] - base[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - base[e >> 1]);
        l[e >> 1] += s[j][e];
      }
    // P as the A operand of P V: the C fragment of S, split into a bf16
    // high part and low part, each multiplied by V (the reference
    // multiplies float32 P by V; P rounded to bf16 alone would move the
    // output by up to an ulp of bf16 in a third of its elements)
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(s[i >> 1][2 * (i & 1)], s[i >> 1][2 * (i & 1) + 1], &pa[i],
                 &pl[i]);
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    const uint32_t v_addr = smem_u32(vs + v_off);
#pragma unroll
    for (int n2 = 0; n2 < kNt / 2; ++n2) {
      if (n2 < nk) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, v_addr + n2 * 32);
        mma_bf16(acc[2 * n2], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * n2 + 1], pa, vb[2], vb[3]);
        mma_bf16(acc[2 * n2], pl, vb[0], vb[1]);
        mma_bf16(acc[2 * n2 + 1], pl, vb[2], vb[3]);
      }
    }
  }
  // merge the warps' states through shared memory (the ring is free now)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  __syncthreads();
  if (t == 0) {
    red_ml[warp * kRows + g] = make_float2(m[0], l[0]);
    red_ml[warp * kRows + g + 8] = make_float2(m[1], l[1]);
  }
  float* ra = red_acc + warp * kRows * Dp;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    if (n < Dp / 8) {
      *reinterpret_cast<float2*>(ra + g * Dp + 8 * n + 2 * t) =
          make_float2(acc[n][0], acc[n][1]);
      *reinterpret_cast<float2*>(ra + (g + 8) * Dp + 8 * n + 2 * t) =
          make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_ml[w * kRows + r].x);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = red_ml[w * kRows + r];
      if (ml.x != -INFINITY) {
        const float e = expf(ml.x - M);
        a = fmaf(e, red_acc[(w * kRows + r) * Dp + d], a);
        L = fmaf(e, ml.y, L);
      }
    }
    const size_t o = (row0 + r) * splits + split;
    ws_acc[o * D + d] = a;
    if (d == 0) ws_ml[o] = make_float2(M, L);
  }
}

// ---------------------------------------------------------------------------
// float32 pools, and int8 pools: CUDA cores, one warp per query head
// ---------------------------------------------------------------------------

constexpr int kF32Heads = 8;
constexpr int kF32Threads = kF32Heads * 32;
constexpr int kF32Tile = 16;  // tokens per tile, two lanes per token

// dot of 4 floats (one uint4) with the matching floats of q
__device__ __forceinline__ float dot4(uint4 k, const float* q) {
  float s = __uint_as_float(k.x) * q[0];
  s = fmaf(__uint_as_float(k.y), q[1], s);
  s = fmaf(__uint_as_float(k.z), q[2], s);
  return fmaf(__uint_as_float(k.w), q[3], s);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// x rounded to T and widened back: a dequantized element in q's type
template <typename T>
__device__ __forceinline__ float round_as(float x);
template <>
__device__ __forceinline__ float round_as<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_as<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));  // nearest even, as torch
}

// eight int8 values times their row's scale, each rounded to T: the plain
// version's (q8.float() * scale).to(T)
template <typename T>
__device__ __forceinline__ void dequant8(uint2 w, float s, float* out) {
  const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = round_as<T>(static_cast<float>(b[i]) * s);
}

// q and out of type T.  kQuant false: float pools (T is float), rows read
// 16 bytes (4 values) at a time.  kQuant true: int8 pools with a float32
// scale per (token, head) row, rows read 8 bytes (8 values) at a time and
// dequantized into the shared tile as they are staged, so each live
// token's K and V bytes and two scales are read once and nothing is
// written back.
template <typename T, bool kQuant>
__global__ void __launch_bounds__(kF32Threads)
split_kernel_cc(const T* __restrict__ q, const void* __restrict__ kpool_,
                const void* __restrict__ vpool_,
                const float* __restrict__ kscale,
                const float* __restrict__ vscale,
                const int32_t* __restrict__ page_table,
                const int32_t* __restrict__ seq_lens,
                float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                int H, int KVH, int D, int NP, int PS, int MAXP,
                int pages_per_split, int splits, float scale) {
  using Pool = typename std::conditional<kQuant, int8_t, float>::type;
  using Chunk = typename std::conditional<kQuant, uint2, uint4>::type;
  constexpr int kPer = sizeof(Chunk) / sizeof(Pool);  // values per chunk
  constexpr int kDimsPerLane = kMaxD / 32;
  // chunk loads per thread per tensor per tile: at most 4 (float), 2 (int8)
  constexpr int kLoads = kF32Tile * kMaxD / kPer / kF32Threads;
  const Pool* kpool = static_cast<const Pool*>(kpool_);
  const Pool* vpool = static_cast<const Pool*>(vpool_);
  __shared__ __align__(16) float ks[kF32Tile * (kMaxD + kPad)];
  __shared__ __align__(16) float vs[kF32Tile * (kMaxD + kPad)];
  __shared__ __align__(16) float qs[kF32Heads * kMaxD];
  __shared__ int live[kF32Tile];  // row of the tile is mapped and below te
  griddep_launch_dependents();

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int split = blockIdx.y;
  const int G = H / KVH;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g0 = blockIdx.z * kF32Heads;
  const bool active = g0 + warp < G;  // uniform across the warp
  const size_t row0 = static_cast<size_t>(b) * H + h * G + g0;
  const int vpr = D / 4;               // uint4 of floats per shared row
  const int cpr = D / kPer;            // chunks per pool row
  const int ws = (D + kPad) / 4;       // padded row stride, in uint4
  const int32_t* pt_row = page_table + static_cast<size_t>(b) * MAXP;

  for (int i = threadIdx.x; i < kF32Heads * D; i += kF32Threads) {
    const int w = i / D;
    qs[w * kMaxD + i % D] =
        g0 + w < G ? to_float(q[(row0 + w) * D + i % D]) : 0.f;
  }
  int len = seq_lens[b];
  len = len < 0 ? 0 : (len > MAXP * PS ? MAXP * PS : len);
  int tb, te;
  split_tokens(split, pages_per_split, PS, len, &tb, &te);

  // -- registers one tile ahead ---------------------------------------------
  Chunk kr[kLoads], vr[kLoads];
  float ksr[kLoads], vsr[kLoads];  // the rows' scales (int8 pools)
  unsigned loaded = 0;  // bit k: kr[k]/vr[k] hold a live row's chunk
  auto issue = [&](int t0) {
    const int n = min(kF32Tile, te - t0);
    loaded = 0;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = threadIdx.x + k * kF32Threads;
      const int r = i / cpr;
      if (r < n) {
        const int j = t0 + r;
        const int pt = __ldg(pt_row + j / PS);
        if (pt >= 0 && pt < NP) {
          const size_t row =
              (static_cast<size_t>(pt) * KVH + h) * PS + j % PS;
          const int c = i - r * cpr;
          kr[k] = __ldg(reinterpret_cast<const Chunk*>(kpool + row * D) + c);
          vr[k] = __ldg(reinterpret_cast<const Chunk*>(vpool + row * D) + c);
          if constexpr (kQuant) {
            ksr[k] = __ldg(kscale + row);
            vsr[k] = __ldg(vscale + row);
          }
          loaded |= 1u << k;
        }
      }
    }
  };

  uint4* k4 = reinterpret_cast<uint4*>(ks);
  uint4* v4 = reinterpret_cast<uint4*>(vs);
  const float* qw = qs + warp * kMaxD;
  const int tok = lane % kF32Tile;
  const int part = lane / kF32Tile;

  float acc[kDimsPerLane];
#pragma unroll
  for (int i = 0; i < kDimsPerLane; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  if (tb < te) issue(tb);
  for (int t0 = tb; t0 < te; t0 += kF32Tile) {
    const int n = min(kF32Tile, te - t0);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      if (loaded >> k & 1u) {
        const int i = threadIdx.x + k * kF32Threads;
        const int r = i / cpr;
        const int c = i - r * cpr;
        if constexpr (kQuant) {
          dequant8<T>(kr[k], ksr[k], ks + r * ws * 4 + c * kPer);
          dequant8<T>(vr[k], vsr[k], vs + r * ws * 4 + c * kPer);
        } else {
          k4[r * ws + c] = kr[k];
          v4[r * ws + c] = vr[k];
        }
      }
    }
    if (threadIdx.x < kF32Tile) {
      int ok = 0;
      if (static_cast<int>(threadIdx.x) < n) {
        const int pt = __ldg(pt_row + (t0 + threadIdx.x) / PS);
        ok = pt >= 0 && pt < NP;
      }
      live[threadIdx.x] = ok;
    }
    __syncthreads();
    if (t0 + kF32Tile < te) issue(t0 + kF32Tile);  // in flight during math
    if (active) {
      // scores: two lanes per token, combined by one shuffle
      float s = 0.f;
      for (int c = part; c < vpr; c += 2)
        s += dot4(k4[tok * ws + c], qw + c * 4);
      s += __shfl_xor_sync(kFull, s, 16);
      s = live[tok] ? s * scale : -INFINITY;
      const float m_new = fmaxf(m, warp_max(s));
      if (m_new != -INFINITY) {  // else the tile and all before are masked
        const float alpha = expf(m - m_new);
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        l = l * alpha + warp_sum(part == 0 ? p : 0.f);
#pragma unroll
        for (int i = 0; i < kDimsPerLane; ++i) acc[i] *= alpha;
        for (int r = 0; r < n; ++r) {
          const float pr = __shfl_sync(kFull, p, r);
          if (pr > 0.f) {  // masked rows hold stale shared memory
            const float* vrow = vs + r * ws * 4;
#pragma unroll
            for (int i = 0; i < kDimsPerLane; ++i) {
              const int d = lane + 32 * i;
              if (d < D) acc[i] = fmaf(pr, vrow[d], acc[i]);
            }
          }
        }
        m = m_new;
      }
    }
    __syncthreads();
  }

  if (active) {
    const size_t o = (row0 + warp) * splits + split;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) ws_acc[o * D + d] = acc[i];
    }
    if (lane == 0) ws_ml[o] = make_float2(m, l);
  }
}

template <typename T, bool kQuant>
cudaError_t launch_cc(const void* q, const void* kpool, const void* vpool,
                      const float* kscale, const float* vscale,
                      const int32_t* pt, const int32_t* lens, float* ws_acc,
                      float2* ws_ml, int B, int H, int KVH, int D, int NP,
                      int PS, int MAXP, int pps, int splits, float scale,
                      cudaStream_t stream) {
  const int G = H / KVH;
  split_kernel_cc<T, kQuant><<<dim3(B * KVH, splits,
                                    (G + kF32Heads - 1) / kF32Heads),
                               kF32Threads, 0, stream>>>(
      static_cast<const T*>(q), kpool, vpool, kscale, vscale, pt, lens,
      ws_acc, ws_ml, H, KVH, D, NP, PS, MAXP, pps, splits, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// merge of the splits: one block per (sequence, query head), split order
// ---------------------------------------------------------------------------

constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 1024;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// One block per (sequence, query head).  The first warp's lanes take the
// splits for the max and the weights exp(m_s - M) (0 for an empty split,
// whose acc is never read); then each thread sums its dims over the splits
// in order, one coalesced row of acc per split, several splits' loads in
// flight at once.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ ws_acc,
             const float2* __restrict__ ws_ml, T* __restrict__ out, int D,
             int splits) {
  __shared__ float weight[kMaxSplits];
  __shared__ float total;
  griddep_wait();  // the split kernel's partials are complete and visible
  const size_t row = blockIdx.x;
  const float2* ml = ws_ml + row * splits;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = -INFINITY;
    for (int s = lane; s < splits; s += 32) M = fmaxf(M, ml[s].x);
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float2 v = ml[s];
      weight[s] = v.x == -INFINITY ? 0.f : expf(v.x - M);
      L = fmaf(weight[s], v.y, L);
    }
    L = warp_sum(L);
    if (lane == 0) total = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const float* acc = ws_acc + row * splits * D;
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      if (weight[s] != 0.f) a = fmaf(weight[s], acc[s * D + d], a);
    store(out + row * D + d, a / total);
  }
}

// dynamic shared memory above 48 KB is opt-in, per kernel and device;
// `allowed` (one per kernel) remembers what each device was given
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess)  // the whole carve-out as shared memory: 2 blocks
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) allowed[dev] = bytes;
  return err;
}

// the merge, launched to overlap the split kernel's tail (see griddep_wait)
template <typename T>
cudaError_t launch_merge(const float* ws_acc, const float2* ws_ml, void* out,
                         int BH, int D, int splits, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, ws_acc, ws_ml,
                            static_cast<T*>(out), D, splits);
}

// the bf16 split kernel for padded D <= 8 * kNt, allowed the shared memory
// of head dim D on the current device
template <int kNt>
cudaError_t ready_bf16(int D) {
  static int allowed[64];
  return allow_smem(split_kernel_bf16<kNt>, bf16_smem_bytes(D), allowed);
}

template <int kNt>
cudaError_t resident_bf16(int D, int* blocks) {
  const cudaError_t err = ready_bf16<kNt>(D);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, split_kernel_bf16<kNt>, kWarps * 32, bf16_smem_bytes(D));
}

template <int kNt>
cudaError_t launch_bf16(const void* q, const void* kpool, const void* vpool,
                        const int32_t* pt, const int32_t* lens, float* ws_acc,
                        float2* ws_ml, int B, int H, int KVH, int D, int NP,
                        int PS, int MAXP, int pps, int splits, float scale,
                        cudaStream_t stream) {
  const int bytes = bf16_smem_bytes(D);
  const cudaError_t err = ready_bf16<kNt>(D);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  const dim3 grid(B * KVH, splits, (G + kRows - 1) / kRows);
  split_kernel_bf16<kNt><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kpool),
      static_cast<const bf16*>(vpool), pt, lens, ws_acc, ws_ml, H, KVH, D, NP,
      PS, MAXP, pps, splits, scale);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the split kernel that one SM of the current device holds at
// once, for operands of `dtype` (as below) and head dim D: the occupancy of
// the instantiation paged_attn_launch picks, with its shared memory,
// written to *blocks.  The host sizes one wave of splits from it.  Returns
// the cudaError_t (0 on success).
extern "C" int paged_attn_resident_blocks(int dtype, int D, int* blocks) {
  if (D <= 0 || D > kMaxD || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Dp = padded_d(D);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, split_kernel_cc<float, false>, kF32Threads, 0);
      break;
    case 1:
      err = Dp <= 64    ? resident_bf16<8>(D, blocks)
            : Dp <= 128 ? resident_bf16<16>(D, blocks)
                        : resident_bf16<32>(D, blocks);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, split_kernel_cc<float, true>, kF32Threads, 0);
      break;
    case 3:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, split_kernel_cc<bf16, true>, kF32Threads, 0);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// dtype: 0 float32, 1 bfloat16 (q, both pools and out); 2 float32 q and
// out over int8 pools, 3 bfloat16 q and out over int8 pools, each int8
// pool with its float32 scales (kscale, vscale: one per pool row, null
// for dtypes 0 and 1).  splits: 1 to kMaxSplits.  workspace: float32
// scratch of B * H * splits * (D + 2) values (the splits' acc, then their
// (m, l) pairs).  Launches the split kernel and the merge on `stream`;
// returns the cudaError_t of the launches (0 on success).
extern "C" int paged_attn_launch(int dtype, const void* q, const void* kpool,
                                 const void* vpool, const void* kscale,
                                 const void* vscale, const void* page_table,
                                 const void* seq_lens, void* out,
                                 void* workspace, int B, int H, int KVH, int D,
                                 int NP, int PS, int MAXP, int splits,
                                 float scale, void* stream) {
  if (B <= 0) return 0;
  if (KVH <= 0 || H % KVH || D <= 0 || D > kMaxD || D % 8 || PS <= 0 ||
      MAXP <= 0 || NP <= 0 || splits <= 0 || splits > kMaxSplits ||
      static_cast<long long>(NP) * KVH * PS > 0x7fffffffLL ||  // int rows
      (dtype >= 2) != (kscale != nullptr && vscale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pps = (MAXP + splits - 1) / splits;  // pages per split
  const int BH = B * H;
  float* ws_acc = static_cast<float*>(workspace);
  float2* ws_ml = reinterpret_cast<float2*>(
      ws_acc + static_cast<size_t>(BH) * splits * D);
  const int32_t* pt = static_cast<const int32_t*>(page_table);
  const int32_t* lens = static_cast<const int32_t*>(seq_lens);
  const float* kss = static_cast<const float*>(kscale);
  const float* vss = static_cast<const float*>(vscale);
  cudaError_t err;
  switch (dtype) {
    case 0:
    case 2:
      err = dtype == 0
                ? launch_cc<float, false>(q, kpool, vpool, nullptr, nullptr,
                                          pt, lens, ws_acc, ws_ml, B, H, KVH,
                                          D, NP, PS, MAXP, pps, splits, scale,
                                          s)
                : launch_cc<float, true>(q, kpool, vpool, kss, vss, pt, lens,
                                         ws_acc, ws_ml, B, H, KVH, D, NP, PS,
                                         MAXP, pps, splits, scale, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_merge<float>(ws_acc, ws_ml, out, BH, D, splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      break;
    case 3:
      err = launch_cc<bf16, true>(q, kpool, vpool, kss, vss, pt, lens,
                                  ws_acc, ws_ml, B, H, KVH, D, NP, PS, MAXP,
                                  pps, splits, scale, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_merge<bf16>(ws_acc, ws_ml, out, BH, D, splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      break;
    case 1: {
      const int Dp = padded_d(D);
      err = Dp <= 64
                ? launch_bf16<8>(q, kpool, vpool, pt, lens, ws_acc, ws_ml, B,
                                 H, KVH, D, NP, PS, MAXP, pps, splits, scale,
                                 s)
            : Dp <= 128
                ? launch_bf16<16>(q, kpool, vpool, pt, lens, ws_acc, ws_ml, B,
                                  H, KVH, D, NP, PS, MAXP, pps, splits, scale,
                                  s)
                : launch_bf16<32>(q, kpool, vpool, pt, lens, ws_acc, ws_ml, B,
                                  H, KVH, D, NP, PS, MAXP, pps, splits, scale,
                                  s);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = launch_merge<bf16>(ws_acc, ws_ml, out, BH, D, splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
