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
// - int8 pools with bfloat16 q and out (kv_dtype "int8", the serving
//   path): the same kernel, its own instantiation.  A tile of 16 live
//   tokens of one page (page size a multiple of 16, D a multiple of 16 up
//   to 128: every full tile of the serving path) is four runs in the
//   pools, its K rows, V rows and their float32 scales, each one bulk copy
//   by lane 0 into the end of the stage's K or V area, unpadded; any other
//   tile is staged row by row as the bf16 mode's, each lane's row into
//   the upper half of its own padded bf16 row, with its scale (cp.async,
//   on the same mbarrier).  Once the stage lands, each lane widens its row
//   in place (float(q8) * scale rounded to bf16, the plain version's
//   (q8.float() * scale).to(bfloat16); a run is read whole before any row
//   over it is written), and the bf16 path runs unchanged.  The elements
//   reaching the tensor cores are the dequantized ones and the tiling and
//   order of sums are the bf16 mode's, so at a given split count the
//   output equals the bf16 mode's on the dequantized pools bit for bit.
//   The ring is 2 tiles deep and registers are capped for 3 blocks per SM:
//   the route is bound by each warp's copies, widening and tensor-core
//   work per tile, not by its bytes (more stages did not move it; four
//   copies per tile instead of one per row, and a third block per SM, did).
//   Bound: bytes, 2 * D + 8 per live token per kv head (264 at D 128,
//   against 512 in bf16).
// - float32 q (float32 pools, and int8 pools under float32 q): CUDA cores
//   (TF32 tensor cores would keep ~3 digits), the same grid, partials and
//   merge.  The group's query heads (up to 8) are computed together in
//   registers: each K or V element read from shared memory feeds one FMA
//   per head.  Each warp stages its own 8-token tiles through a 2-stage
//   ring of bulk copies on mbarriers (no block-wide barrier in the token
//   loop), rows padded so a quarter-warp's 8 tokens fall on distinct
//   banks; int8 rows are dequantized as they leave the ring.  Bound:
//   bytes, 8 * D per live token per kv head in float32.
// - Page-token slices (split-KV decode over a mesh whose model axis splits
//   each page's tokens, every route): the pools hold PS of each page's PSg
//   tokens, from token `off` on.  The slice's live rows are a prefix of its
//   local token order (slice_len), so the split kernels run on that prefix;
//   the call returns the splits' partials instead of merging them, and the
//   merge kernel later sums the partials of every slice, in slice order,
//   as it sums splits.  With one slice (PSg = PS, off = 0) the launch is
//   the whole-page instantiation's: its partials and their merge are the
//   whole-page launch's, bit for bit.  A real slice (PSg > PS) of the
//   tensor-core routes runs an instantiation of its own (kSlice), shaped
//   by what a slice launch pays for (tools/attention_breakdown.py's
//   per-block stamps): its few tiles stream at the card's rate, so what it
//   pays beyond its bytes is the first tile's latency, the warps' merge,
//   and blocks and warps waiting for the slowest.  So: a 2-tile ring with
//   three blocks per SM in bf16 too (one wave holds three splits: fewer
//   tiles per warp); int8 tiles of whole slice pages (4 or 8 rows a page)
//   staged as runs, each page's K rows, V rows and scales one bulk copy
//   each, as the whole-page int8 tiles are.  The host's split count
//   fills one wave of this instantiation's blocks.  The arithmetic is the
//   whole-page kernel's, tile for tile, so the int8 slice route equals the
//   bf16 slice route on the dequantized pools bit for bit at a given split
//   count.
// - The warps' merge, every instantiation: the accumulators' live rows go
//   to shared memory without bank conflicts, each row's weights are taken
//   once by one thread, and the block then sums the warps' rows in warp
//   order: the arithmetic of the former pass per element (bit-identical
//   outputs), without its division, exponentials and branches per element
//   (1.5-2 us less per launch at Yi-6B's shape).

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

// the live rows of a sequence of `len` tokens in this call's slice of each
// page, clipped to MAXP * PS: local row j of logical page p is token
// p * PSg + off + j (PSg the pages' global stride, PS the rows per page of
// the pools this call reads).  They are a prefix of the local token order:
// every row of a page wholly below len, then the rows of the last page
// below it.  With PSg = PS and off = 0 (whole pages) it is min(len, MAXP*PS)
__device__ __forceinline__ int slice_len(int len, int PSg, int off, int PS,
                                         int MAXP) {
  if (len <= 0) return 0;
  const int full = len / PSg;
  const int rem = min(max(len - full * PSg - off, 0), PS);
  const long long l = static_cast<long long>(full) * PS + rem;
  return static_cast<int>(l < static_cast<long long>(MAXP) * PS
                              ? l
                              : static_cast<long long>(MAXP) * PS);
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

// int8: tiles per warp in the ring.  Two, not three: the smaller ring
// lets three blocks share an SM (with the register cap below), and the
// int8 route is bound by each warp's widening and tensor-core work per
// tile, not by the bytes in flight
constexpr int kStages8 = 2;
// bf16 over a slice of each page: two tiles per warp too, and three blocks
// per SM.  A slice launch streams its few tiles at the card's rate either
// way; the third block gives the host's one wave three splits, so each
// warp walks fewer tiles and the blocks' tail is shorter (Yi-6B's B 32
// shape, 4 slices: 24.5 against 26.3 us with three stages; PERF.md).
// Whole pages keep three stages and two blocks: on this ring they ran
// 65.8 against 64.6 us at Yi-6B's B 32 shape (tools/attention_modes.py),
// and a third block would change their split count and so their output
constexpr int kSliceStages = 2;
__host__ __device__ constexpr int ring_stages(bool quant, bool slice) {
  return quant ? kStages8 : slice ? kSliceStages : kStages;
}
// blocks per SM the launch bounds ask for: 3 where the ring is 2 deep
__host__ __device__ constexpr int min_blocks(int kNt, bool quant, bool slice) {
  return ring_stages(quant, slice) == 2 && kNt <= 16 ? 3 : 1;
}

// [mbarriers][q rows][ring][warp states (m, l)][live masks][int8: scales]
constexpr int kBarBytes = 128;  // kWarps * kStages mbarriers, 8 bytes each
static_assert(kWarps * kStages * 8 <= kBarBytes, "mbarrier area too small");
static_assert(kWarps * kStages8 * 8 <= kBarBytes, "mbarrier area too small");
static_assert(kWarps * kSliceStages * 8 <= kBarBytes, "mbarrier area too small");
__host__ __device__ constexpr int bf16_smem_bytes(int D, bool quant,
                                                  bool slice) {
  return kBarBytes +
         (kRows + ring_stages(quant, slice) * kWarps * 2 * kTok) *
             (padded_d(D) + kPad) * 2 +
         kWarps * kRows * 8 + kWarps * ring_stages(quant, slice) * 4 +
         (quant ? kWarps * ring_stages(quant, slice) * 2 * kTok * 4 : 0);
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

// Stamps of the tensor-core split kernel's phases, for
// tools/attention_breakdown.py only: a build with PAGED_ATTN_STAMPS
// defined records, per block, %globaltimer (ns) and %clock64 at each
// stamp point into g_stamps (set by paged_attn_set_stamps), and the SM it
// ran on; the library the port loads is built without it, and there
// STAMP compiles to nothing.  Points: 0 block start; 1 the length, q and
// the first page ids loaded and the first tiles issued; 2 warp 0's first
// tile landed; 3 every warp's tile loop done; 4 warps merged and partials
// written; 5 the warps' states in shared memory; 6 + w warp w's tile loop
// done.
constexpr int kStampPoints = 6 + kWarps;
constexpr int kStampWords = 2 * kStampPoints + 2;  // + SM id, tiles of warp 0
#ifdef PAGED_ATTN_STAMPS
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ void stamp_at(int k, bool lead) {
  if (!lead || g_stamps == nullptr) return;
  unsigned long long t, smid;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t)::"memory");
  const long long c = clock64();
  unsigned long long* s =
      g_stamps + (blockIdx.x + static_cast<size_t>(gridDim.x) *
                                   (blockIdx.y + gridDim.y * blockIdx.z)) *
                     kStampWords;
  s[2 * k] = t;
  s[2 * k + 1] = static_cast<unsigned long long>(c);
  if (k == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(id));
    smid = id;
    s[2 * kStampPoints] = smid;
  }
}
__device__ __forceinline__ void stamp_word(int w, unsigned long long v) {
  if (threadIdx.x == 0 && g_stamps != nullptr)
    g_stamps[(blockIdx.x + static_cast<size_t>(gridDim.x) *
                               (blockIdx.y + gridDim.y * blockIdx.z)) *
                 kStampWords +
             w] = v;
}
#define STAMP(k) stamp_at((k), threadIdx.x == 0)
#define STAMP_WARP(w) stamp_at(6 + (w), (threadIdx.x & 31) == 0)
#define STAMP_TILES(n) stamp_word(2 * kStampPoints + 1, (n))
#define STAMP_SYNC() __syncthreads()
#else
#define STAMP(k) ((void)0)
#define STAMP_WARP(w) ((void)0)
#define STAMP_TILES(n) ((void)0)
#define STAMP_SYNC() ((void)0)
#endif

// mbarrier of one ring stage: `count` arrivals (lane 0's, with the
// stage's byte count, and in the int8 modes one per lane when its cp.async
// copies land) plus the bytes of its bulk copies complete a phase
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
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

// cp.async of 4 or 8 bytes global -> shared (both addresses aligned to
// the size); the lane's arrival on the mbarrier once its copies have landed
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// a row of `bytes` (a multiple of 8) global -> shared, completing on the
// mbarrier: one bulk copy when `bulk` (bytes and both addresses multiples
// of 16; the stage's expect_tx counts them), else 8-byte cp.async copies
// (the lane's cp_async_arrive counts them)
__device__ __forceinline__ void stage_row(unsigned char* dst, const void* src,
                                          int bytes, bool bulk,
                                          uint32_t bar) {
  if (bulk) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_copy(smem_u32(dst), src, bytes, bar);
  } else {
    for (int c = 0; c < bytes; c += 8)
      cp_async8(smem_u32(dst + c), static_cast<const unsigned char*>(src) + c);
  }
}

// the four int8 values of w, each exact as a float (2^23 + (v + 128) built
// from its bits, less 2^23 + 128), times s: the plain version's
// q8.float() * scale, rounded once
__device__ __forceinline__ void dequant4(uint32_t w, float s, float* out) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __fmul_rn(
        __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)),
                  8388736.f),
        s);
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

// the D int8 values at bytes D..2D of a bf16 ring row, times s, rounded to
// bf16 into elements 0..D of the same row, in place, in batches of up to
// 128 bytes read before any of them is written: the batch of chunks read
// from bytes D + w c writes bytes 2 w c, which held only chunks of this
// batch or an earlier one (kNt: the instantiation's padded D / 8)
template <int kNt>
__device__ __forceinline__ void widen_row(bf16* row, int D, float s) {
  unsigned char* base = reinterpret_cast<unsigned char*>(row);
  float f[8];
  if (D % 16 == 0) {
#pragma unroll
    for (int c0 = 0; c0 < kNt / 2; c0 += 8) {
      uint4 w[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (c0 + c < D / 16)
          w[c] = *reinterpret_cast<const uint4*>(base + D + 16 * (c0 + c));
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        if (c0 + c < D / 16) {
          unsigned char* out = base + 32 * (c0 + c);
          dequant4(w[c].x, s, f);
          dequant4(w[c].y, s, f + 4);
          *reinterpret_cast<uint4*>(out) =
              make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
          dequant4(w[c].z, s, f);
          dequant4(w[c].w, s, f + 4);
          *reinterpret_cast<uint4*>(out + 16) =
              make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
      }
    }
  } else {  // D = 8 (mod 16): 8-byte chunks
#pragma unroll
    for (int c0 = 0; c0 < kNt; c0 += 16) {
      uint2 w[16];
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (c0 + c < D / 8)
          w[c] = *reinterpret_cast<const uint2*>(base + D + 8 * (c0 + c));
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (c0 + c < D / 8) {
          dequant4(w[c].x, s, f);
          dequant4(w[c].y, s, f + 4);
          *reinterpret_cast<uint4*>(base + 16 * (c0 + c)) =
              make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                         pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
        }
      }
    }
  }
}

// the same from an unpadded run of a stage's 16 rows (src: this row's D
// int8 bytes in it, r: the row), D a multiple of 16: every lane of the warp
// reads its whole row into registers, chunk (c + r) % (D / 16) first so the
// 8 lanes of a quarter-warp read distinct banks, before any lane writes
template <int kNt>
__device__ __forceinline__ void widen_run(bf16* row, const unsigned char* src,
                                          int D, float s, int r) {
  const int n = D / 16;
  const int r0 = r % n;
  uint4 w[kNt / 2];
#pragma unroll
  for (int c = 0; c < kNt / 2; ++c) {
    const int cc = c + r0 < n ? c + r0 : c + r0 - n;
    if (c < n) w[c] = *reinterpret_cast<const uint4*>(src + 16 * cc);
  }
  __syncwarp();  // the run is read: the rows over it may be written
  float f[8];
#pragma unroll
  for (int c = 0; c < kNt / 2; ++c) {
    if (c < n) {
      const int cc = c + r0 < n ? c + r0 : c + r0 - n;
      unsigned char* out = reinterpret_cast<unsigned char*>(row) + 32 * cc;
      dequant4(w[c].x, s, f);
      dequant4(w[c].y, s, f + 4);
      *reinterpret_cast<uint4*>(out) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
      dequant4(w[c].z, s, f);
      dequant4(w[c].w, s, f + 4);
      *reinterpret_cast<uint4*>(out + 16) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  }
}

// kNt: the most 8-wide dim tiles (padded D / 8) this instantiation takes.
// kQuant false: bf16 pools.  kQuant true: int8 pools with float32 scales
// (kscale, vscale: one per pool row), each row staged into the upper half
// of its bf16 ring row with its scale and widened there once the stage has
// landed; from there the same tensor-core path.  kSlice: the slice mode's
// instantiation over pools holding a slice of each page (its ring depth,
// blocks per SM and int8 runs over several pages; the same arithmetic).
template <int kNt, bool kQuant, bool kSlice>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(kNt, kQuant, kSlice))
split_kernel_bf16(const bf16* __restrict__ q, const void* __restrict__ kpool_,
                  const void* __restrict__ vpool_,
                  const float* __restrict__ kscale,
                  const float* __restrict__ vscale,
                  const int32_t* __restrict__ page_table,
                  const int32_t* __restrict__ seq_lens,
                  float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                  int H, int KVH, int D, int NP, int PS, int MAXP, int PSg,
                  int tok_off, int pages_per_split, int splits, float scale) {
  using Pool = typename std::conditional<kQuant, int8_t, bf16>::type;
  constexpr int kS = ring_stages(kQuant, kSlice);  // ring stages
  const Pool* kpool = static_cast<const Pool*>(kpool_);
  const Pool* vpool = static_cast<const Pool*>(vpool_);
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = padded_d(D);
  const int ld = Dp + kPad;
  const uint32_t bars = smem_u32(smem);                  // [kWarps][kS]
  bf16* qs = reinterpret_cast<bf16*>(smem + kBarBytes);  // [kRows][ld]
  bf16* ring = qs + kRows * ld;  // [kS][kWarps][K, V][kTok][ld]
  float2* red_ml = reinterpret_cast<float2*>(
      ring + kS * kWarps * 2 * kTok * ld);           // [kWarps][kRows]
  // [kWarps][kS]: live rows of each ring stage's tile, bit per token
  unsigned* live_s = reinterpret_cast<unsigned*>(red_ml + kWarps * kRows);
  // int8: [kWarps][kS][K, V][kTok] scales of the stage's rows
  float* scl = reinterpret_cast<float*>(live_s + kWarps * kS);
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
  STAMP(0);

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
  int pt_first[kS - 1];
#pragma unroll
  for (int st = 0; st < kS - 1; ++st) pt_first[st] = page_of(st);

  const int len = slice_len(len_raw, PSg, tok_off, PS, MAXP);
  int tb, te;
  split_tokens(split, pages_per_split, PS, len, &tb, &te);
  if (te <= tb) {  // nothing live in this split
    if (static_cast<int>(threadIdx.x) < rows)
      ws_ml[(row0 + threadIdx.x) * splits + split] =
          make_float2(-INFINITY, 0.f);
    STAMP(4);
    return;
  }

  const int nchunks = (te - tb + kTok - 1) / kTok;
  const int mine = warp < nchunks ? (nchunks - 1 - warp) / kWarps + 1 : 0;
  const int sstride = kWarps * 2 * kTok * ld;  // one stage of all warps
  bf16* my = ring + warp * 2 * kTok * ld;
  const uint32_t my_bars = bars + warp * kS * 8;
  if (lane == 0) {
    for (int st = 0; st < kS; ++st)
      mbar_init(my_bars + st * 8, kQuant ? 33 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this warp's i-th tile into ring stage i % kS (pt: page_of(i)):
  // lane r < 16 copies the K row of the tile's token r, lane 16 + r its V
  // row, each with one bulk copy (int8: into the row's upper half, with its
  // scale; a row of D = 8 (mod 16) bytes by 8-byte cp.async); a masked row
  // (past the length, or of an unmapped page) is zeroed instead and never
  // read, nor is its scale.  Int8, a tile of 16 live tokens (D a multiple
  // of 16 up to 128) that lies in one page (PS a multiple of 16) or spans
  // n = 16 / PS whole pages (PS 4 or 8: a slice's pools; a tile starts on
  // a page, the split's first token being one): each page's K rows, V rows
  // and their scales are four runs in the pools, PS * D and PS * 4 bytes
  // (16-byte multiples, 16-byte aligned), each one bulk copy by one of
  // lanes 0..4n-1, the rows to the end of their area of the stage,
  // unpadded and in token order, widened from there (bit 31 of the stage's
  // live mask); PS 2 keeps a copy per row (8-byte scale runs)
  const bool bulk = !kQuant || D % 16 == 0;
  const bool runs =
      kQuant && kNt <= 16 && bulk &&
      (PS % kTok == 0 || (kSlice && PS % 4 == 0 && kTok % PS == 0));
  const int run_rows = PS % kTok == 0 ? kTok : PS;  // rows of one run
  const int run_off = kTok * ld * 2 - kTok * D;  // bytes into a K or V area
  auto issue = [&](int i, int pt) {
    const int st = i % kS;
    const int j = tb + (warp + i * kWarps) * kTok + (lane & (kTok - 1));
    const int prow =
        j < te && pt >= 0 && pt < NP ? (pt * KVH + h) * PS + j % PS : -1;
    const unsigned live = __ballot_sync(kFull, prow >= 0) & 0xffffu;
    const bool whole = runs && live == 0xffffu;
    const uint32_t bar = my_bars + st * 8;
    if (lane == 0) {
      live_s[warp * kS + st] = live | (whole ? 0x80000000u : 0u);
      mbar_expect_tx(bar, whole  ? 2 * kTok * (D + 4)
                          : bulk ? __popc(live) * 2 * D *
                                       static_cast<int>(sizeof(Pool))
                                 : 0);
    }
    __syncwarp();
    bf16* dst = my + st * sstride + (lane >> 4) * kTok * ld + (lane & 15) * ld;
    if (whole && !kSlice) {  // one page: lane 0's four copies (the
      if (lane == 0) {       // lanes' form below cost whole pages 9 %)
        unsigned char* k_run =
            reinterpret_cast<unsigned char*>(my + st * sstride) + run_off;
        float* sc = scl + (warp * kS + st) * 2 * kTok;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_copy(smem_u32(k_run), kpool + static_cast<size_t>(prow) * D,
                  kTok * D, bar);
        bulk_copy(smem_u32(k_run + kTok * ld * 2),
                  vpool + static_cast<size_t>(prow) * D, kTok * D, bar);
        bulk_copy(smem_u32(sc), kscale + prow, kTok * 4, bar);
        bulk_copy(smem_u32(sc + kTok), vscale + prow, kTok * 4, bar);
      }
    } else if (whole) {  // lane k * n + p: run k (K, V, their scales), page p
      const int n = kTok / run_rows, p = lane % n, kind = lane / n;
      const int first = __shfl_sync(kFull, prow, p * run_rows);
      if (kind < 4) {
        const int r0 = p * run_rows;
        unsigned char* k_run =
            reinterpret_cast<unsigned char*>(my + st * sstride) + run_off;
        float* sc = scl + (warp * kS + st) * 2 * kTok + (kind & 1) * kTok;
        const Pool* pool = kind & 1 ? vpool : kpool;
        const float* scales = kind & 1 ? vscale : kscale;
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (kind < 2)
          bulk_copy(smem_u32(k_run + (kind & 1) * kTok * ld * 2 + r0 * D),
                    pool + static_cast<size_t>(first) * D, run_rows * D, bar);
        else
          bulk_copy(smem_u32(sc + r0), scales + first, run_rows * 4, bar);
      }
    } else if (prow >= 0) {
      stage_row(reinterpret_cast<unsigned char*>(dst) + (kQuant ? D : 0),
                (lane < kTok ? kpool : vpool) + static_cast<size_t>(prow) * D,
                D * static_cast<int>(sizeof(Pool)), bulk, bar);
      if constexpr (kQuant)
        cp_async4(smem_u32(scl + (warp * kS + st) * 2 * kTok + lane),
                  (lane < kTok ? kscale : vscale) + prow);
    } else {
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint4*>(dst + c * 8) = make_uint4(0, 0, 0, 0);
    }
    if constexpr (kQuant) cp_async_arrive(bar);
  };
#pragma unroll
  for (int st = 0; st < kS - 1; ++st)
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
    for (int i = threadIdx.x; i < kS * kWarps * 2 * kTok;
         i += blockDim.x)
      *reinterpret_cast<uint4*>(ring + i * ld + D) = make_uint4(0, 0, 0, 0);
  __syncthreads();
  STAMP(1);
  STAMP_TILES(mine);

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
    if (i + kS - 1 < mine)
      issue(i + kS - 1, page_of(i + kS - 1));
    mbar_wait(my_bars + (i % kS) * 8, (i / kS) & 1);  // tile i
    if (i == 0) STAMP(2);
    const unsigned live = live_s[warp * kS + i % kS];
    const bf16* ks = my + (i % kS) * sstride;
    const bf16* vs = ks + kTok * ld;
    if constexpr (kQuant) {  // lane r widens row r (K rows, then V rows)
      bf16* row = my + (i % kS) * sstride + lane * ld;
      const float sc = scl[(warp * kS + i % kS) * 2 * kTok + lane];
      if (live >> 31)
        widen_run<kNt>(row,
                       reinterpret_cast<const unsigned char*>(
                           ks + (lane >> 4) * kTok * ld) +
                           run_off + (lane & (kTok - 1)) * D,
                       D, sc, lane & (kTok - 1));
      else if (live >> (lane & (kTok - 1)) & 1u)
        widen_row<kNt>(row, D, sc);
      __syncwarp();
    }

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
  STAMP_WARP(warp);
  // merge the warps' states through shared memory (the ring is free now):
  // each warp's (m, l) and its accumulator's rows below `rows` (stride
  // Dp + 8 floats, so a half-warp's float2 stores fall on distinct banks);
  // then thread r < rows takes row r's max M over the warps, each warp's
  // weight exp(m_w - M) (a warp with no live token skipped) and the sum L,
  // and the block sums the warps' rows with those weights in warp order:
  // the same operations, in the same order, as one pass per element
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  __syncthreads();
  STAMP(3);
  const int rs = Dp + 8;  // red_acc row stride, floats
  if (t == 0) {
    red_ml[warp * kRows + g] = make_float2(m[0], l[0]);
    red_ml[warp * kRows + g + 8] = make_float2(m[1], l[1]);
  }
  float* ra = red_acc + warp * kRows * rs;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    if (n < Dp / 8) {
      if (g < rows)
        *reinterpret_cast<float2*>(ra + g * rs + 8 * n + 2 * t) =
            make_float2(acc[n][0], acc[n][1]);
      if (g + 8 < rows)
        *reinterpret_cast<float2*>(ra + (g + 8) * rs + 8 * n + 2 * t) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();
  STAMP(5);
  if (static_cast<int>(threadIdx.x) < rows) {  // row r's weights and sum
    const int r = threadIdx.x;
    float M = -INFINITY, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_ml[w * kRows + r].x);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = red_ml[w * kRows + r];
      float e = -1.f;  // skipped
      if (ml.x != -INFINITY) {
        e = expf(ml.x - M);
        L = fmaf(e, ml.y, L);
      }
      red_ml[w * kRows + r].x = e;
    }
    ws_ml[(row0 + r) * splits + split] = make_float2(M, L);
  }
  __syncthreads();
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    float e[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) e[w] = red_ml[w * kRows + r].x;
    float* out = ws_acc + ((row0 + r) * splits + split) * D;
    for (int d = threadIdx.x; d < D; d += kWarps * 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (e[w] >= 0.f) a = fmaf(e[w], red_acc[(w * kRows + r) * rs + d], a);
      out[d] = a;
    }
  }
  STAMP_SYNC();
  STAMP(4);
}

// ---------------------------------------------------------------------------
// float32 q (float32 pools, or int8 pools): CUDA cores, register-tiled
// ---------------------------------------------------------------------------

constexpr int kCcTok = 8;             // tokens per warp tile
constexpr int kCcStages = 2;          // tiles per warp in the ring
constexpr int kCcCols = kMaxD / 128;  // float4 column chunks per lane in P V

// a ring row, bytes: an odd number of 16-byte units, so that the 8 tokens
// one quarter-warp reads at one column fall on distinct banks (float: D + 4
// floats, D / 4 being even; int8: D bytes rounded up to an odd count)
__host__ __device__ constexpr int cc_row_bytes(int D, bool quant) {
  return quant ? 16 * (((D + 15) / 16) | 1) : 4 * (D + 4);
}
// the ring, reused at the end for the warps' accumulators
__host__ __device__ constexpr int cc_ring_bytes(int D, int kG, bool quant) {
  return kWarps * kCcStages * 2 * kCcTok * cc_row_bytes(D, quant) >
                 kWarps * kG * D * 4
             ? kWarps * kCcStages * 2 * kCcTok * cc_row_bytes(D, quant)
             : kWarps * kG * D * 4;
}
// [mbarriers][q rows][ring][int8: scales][p][warp states (m, l)][live]
__host__ __device__ constexpr int cc_smem_bytes(int D, int kG, bool quant) {
  return kBarBytes + kG * D * 4 + cc_ring_bytes(D, kG, quant) +
         (quant ? kWarps * kCcStages * 2 * kCcTok * 4 : 0) +
         kWarps * kG * kCcTok * 4 + kWarps * kG * 8 + kWarps * kCcStages * 4;
}

// kG: the query heads one block computes together (grid z covers G in
// groups of kG).  kQuant false: float32 pools; true: int8 pools with their
// float32 scales, each element dequantized as it leaves the ring.  Each of
// the 4 warps runs its own online softmax over its own 8-token tiles (tile
// k of the block to warp k % 4), staged through its own 2-stage ring by
// bulk copies (int8 rows of D = 8 (mod 16) bytes, and the scales, by
// cp.async) on one mbarrier per stage: no block-wide barrier in the token
// loop.  Scores: lane (sub, tok) = (lane / 8, lane % 8) takes token tok's
// 4-column chunks sub, sub + 4, ... and keeps kG sums, each K element
// feeding kG FMAs (q read from shared memory, one address per quarter-
// warp); the four subs are summed by two shuffles.  P V: lane c owns
// columns 4c..4c+3 (and 128 + 4c.. at D > 128) of every head, an acc[kG][4]
// fragment per chunk, each V element feeding kG FMAs with P broadcast from
// shared memory.  The warps' states are merged through shared memory.
template <int kG, bool kQuant>
__global__ void __launch_bounds__(kWarps * 32)
split_kernel_cc(const float* __restrict__ q, const void* __restrict__ kpool,
                const void* __restrict__ vpool,
                const float* __restrict__ kscale,
                const float* __restrict__ vscale,
                const int32_t* __restrict__ page_table,
                const int32_t* __restrict__ seq_lens,
                float* __restrict__ ws_acc, float2* __restrict__ ws_ml,
                int H, int KVH, int D, int NP, int PS, int MAXP, int PSg,
                int tok_off, int pages_per_split, int splits, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = cc_row_bytes(D, kQuant);
  const int pbytes = kQuant ? D : 4 * D;  // bytes of a pool row
  const uint32_t bars = smem_u32(smem);   // [kWarps][kCcStages]
  float* qs = reinterpret_cast<float*>(smem + kBarBytes);  // [kG][D]
  // [kCcStages][kWarps][K, V][kCcTok][rb bytes]
  unsigned char* ring = reinterpret_cast<unsigned char*>(qs + kG * D);
  // int8: [kWarps][kCcStages][K, V][kCcTok] scales of the stage's rows
  float* scl = reinterpret_cast<float*>(ring + cc_ring_bytes(D, kG, kQuant));
  // [kWarps][kG][kCcTok]: p of the warp's tile
  float* ps = scl + (kQuant ? kWarps * kCcStages * 2 * kCcTok : 0);
  float2* red_ml = reinterpret_cast<float2*>(ps + kWarps * kG * kCcTok);
  unsigned* live_s = reinterpret_cast<unsigned*>(red_ml + kWarps * kG);
  float* red_acc = reinterpret_cast<float*>(ring);  // [kWarps][kG][D]

  const int b = blockIdx.x / KVH;
  const int h = blockIdx.x % KVH;
  const int split = blockIdx.y;
  const int G = H / KVH;
  const int g0 = blockIdx.z * kG;
  const int rows = min(kG, G - g0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t row0 = static_cast<size_t>(b) * H + h * G + g0;

  griddep_launch_dependents();  // the merge may launch and wait for us

  // the length and the warp's first page id together (speculative: the
  // split's range and the table row bound it, the length masks it below)
  const int len_raw = seq_lens[b];
  const int32_t* pt_row = page_table + static_cast<size_t>(b) * MAXP;
  const int tb0 = static_cast<int>(
      min(static_cast<long long>(split) * pages_per_split * PS,
          static_cast<long long>(MAXP) * PS));
  const int t_end = min(tb0 + pages_per_split * PS, MAXP * PS);
  // page id of the lane's token (lane % 8) in this warp's i-th tile
  auto page_of = [&](int i) {
    const int j = tb0 + (warp + i * kWarps) * kCcTok + (lane & (kCcTok - 1));
    return j < t_end ? __ldg(pt_row + j / PS) : -1;
  };
  const int pt_first = page_of(0);

  const int len = slice_len(len_raw, PSg, tok_off, PS, MAXP);
  int tb, te;
  split_tokens(split, pages_per_split, PS, len, &tb, &te);
  if (te <= tb) {  // nothing live in this split
    if (static_cast<int>(threadIdx.x) < rows)
      ws_ml[(row0 + threadIdx.x) * splits + split] =
          make_float2(-INFINITY, 0.f);
    return;
  }

  const int nchunks = (te - tb + kCcTok - 1) / kCcTok;
  const int mine = warp < nchunks ? (nchunks - 1 - warp) / kWarps + 1 : 0;
  const int tile_bytes = 2 * kCcTok * rb;
  const int sstride = kWarps * tile_bytes;  // one stage of all warps
  unsigned char* my = ring + warp * tile_bytes;
  const uint32_t my_bars = bars + warp * kCcStages * 8;
  float* my_scl = scl + warp * kCcStages * 2 * kCcTok;
  if (lane == 0) {
    for (int st = 0; st < kCcStages; ++st)
      mbar_init(my_bars + st * 8, kQuant ? 33 : 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // this warp's i-th tile into ring stage i % kCcStages (pt: page_of(i)):
  // lane r < 8 copies the K row of the tile's token r, lane 8 + r its V
  // row (int8: with its scale); a masked row (past the length, or of an
  // unmapped page) is neither copied nor read, nor is its scale
  const bool bulk = !kQuant || D % 16 == 0;
  auto issue = [&](int i, int pt) {
    const int st = i % kCcStages;
    const int j = tb + (warp + i * kWarps) * kCcTok + (lane & (kCcTok - 1));
    const int prow = lane < 2 * kCcTok && j < te && pt >= 0 && pt < NP
                         ? (pt * KVH + h) * PS + j % PS
                         : -1;
    const unsigned live = __ballot_sync(kFull, prow >= 0) & 0xffu;
    const uint32_t bar = my_bars + st * 8;
    if (lane == 0) {
      live_s[warp * kCcStages + st] = live;
      mbar_expect_tx(bar, bulk ? __popc(live) * 2 * pbytes : 0);
    }
    __syncwarp();
    if (prow >= 0) {
      const unsigned char* pool = static_cast<const unsigned char*>(
          lane < kCcTok ? kpool : vpool);
      stage_row(my + st * sstride + lane * rb,
                pool + static_cast<size_t>(prow) * pbytes, pbytes, bulk, bar);
      if constexpr (kQuant)
        cp_async4(smem_u32(my_scl + st * 2 * kCcTok + lane),
                  (lane < kCcTok ? kscale : vscale) + prow);
    }
    if constexpr (kQuant) cp_async_arrive(bar);
  };
  if (mine > 0) issue(0, pt_first);

  // the group's q rows (zero rows past G)
  for (int i = threadIdx.x; i < kG * D; i += kWarps * 32)
    qs[i] = i / D < rows ? q[row0 * D + i] : 0.f;
  __syncthreads();

  const int sub = lane >> 3, tok = lane & (kCcTok - 1);
  const int nc = D / 4;  // 4-column chunks of a row
  float acc[kG][kCcCols][4];
  float m[kG], lp[kG];  // running max; this lane's share of the running sum
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
#pragma unroll
    for (int hh = 0; hh < kCcCols; ++hh)
      acc[g][hh][0] = acc[g][hh][1] = acc[g][hh][2] = acc[g][hh][3] = 0.f;
  }
  float* my_ps = ps + warp * kG * kCcTok;

  for (int i = 0; i < mine; ++i) {
    __syncwarp();  // every lane is done with the stage refilled here
    if (i + 1 < mine) issue(i + 1, page_of(i + 1));
    const int st = i % kCcStages;
    mbar_wait(my_bars + st * 8, (i / kCcStages) & 1);  // tile i
    const unsigned live = live_s[warp * kCcStages + st];
    const unsigned char* kt = my + st * sstride;
    const unsigned char* vt = kt + kCcTok * rb;

    // scores of token tok over its chunks sub, sub + 4, ...
    float s[kG];
#pragma unroll
    for (int g = 0; g < kG; ++g) s[g] = 0.f;
    const float ksc = kQuant ? my_scl[st * 2 * kCcTok + tok] : 0.f;
    for (int c = sub; c < nc; c += 4) {
      float k[4];
      if constexpr (kQuant) {
        dequant4(*reinterpret_cast<const uint32_t*>(kt + tok * rb + 4 * c),
                 ksc, k);
      } else {
        const float4 k4 =
            *reinterpret_cast<const float4*>(kt + tok * rb + 16 * c);
        k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const float4 q4 = *reinterpret_cast<const float4*>(qs + g * D + 4 * c);
        s[g] = fmaf(k[0], q4.x, s[g]);
        s[g] = fmaf(k[1], q4.y, s[g]);
        s[g] = fmaf(k[2], q4.z, s[g]);
        s[g] = fmaf(k[3], q4.w, s[g]);
      }
    }
    // online softmax of each head over the tile's 8 tokens
    const bool on = live >> tok & 1u;
#pragma unroll
    for (int g = 0; g < kG; ++g) {
      s[g] += __shfl_xor_sync(kFull, s[g], 8);
      s[g] += __shfl_xor_sync(kFull, s[g], 16);
      s[g] = on ? s[g] * scale : -INFINITY;
      float mx = fmaxf(s[g], __shfl_xor_sync(kFull, s[g], 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
      const float mn = fmaxf(m[g], mx);
      const float base = mn == -INFINITY ? 0.f : mn;  // all masked: p = 0
      const float alpha = expf(m[g] - base);
      m[g] = mn;
      const float p = expf(s[g] - base);
      lp[g] = lp[g] * alpha + (sub == 0 ? p : 0.f);
#pragma unroll
      for (int hh = 0; hh < kCcCols; ++hh) {
        acc[g][hh][0] *= alpha;
        acc[g][hh][1] *= alpha;
        acc[g][hh][2] *= alpha;
        acc[g][hh][3] *= alpha;
      }
      if (sub == 0) my_ps[g * kCcTok + tok] = p;
    }
    __syncwarp();

    // P V over the tile's live tokens (a masked row is never read)
#pragma unroll
    for (int t0 = 0; t0 < kCcTok; t0 += 4) {
      if (!(live >> t0 & 0xfu)) continue;
      float4 pv[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g)
        pv[g] = *reinterpret_cast<const float4*>(my_ps + g * kCcTok + t0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (!(live >> (t0 + u) & 1u)) continue;
        const unsigned char* vrow = vt + (t0 + u) * rb;
        const float vsc =
            kQuant ? my_scl[st * 2 * kCcTok + kCcTok + t0 + u] : 0.f;
#pragma unroll
        for (int hh = 0; hh < kCcCols; ++hh) {
          const int c = lane + 32 * hh;
          if (c < nc) {
            float v[4];
            if constexpr (kQuant) {
              dequant4(*reinterpret_cast<const uint32_t*>(vrow + 4 * c), vsc,
                       v);
            } else {
              const float4 v4 =
                  *reinterpret_cast<const float4*>(vrow + 16 * c);
              v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
            }
#pragma unroll
            for (int g = 0; g < kG; ++g) {
              const float p = u == 0   ? pv[g].x
                              : u == 1 ? pv[g].y
                              : u == 2 ? pv[g].z
                                       : pv[g].w;
              acc[g][hh][0] = fmaf(p, v[0], acc[g][hh][0]);
              acc[g][hh][1] = fmaf(p, v[1], acc[g][hh][1]);
              acc[g][hh][2] = fmaf(p, v[2], acc[g][hh][2]);
              acc[g][hh][3] = fmaf(p, v[3], acc[g][hh][3]);
            }
          }
        }
      }
    }
  }

  // merge the warps' states through shared memory (the ring is free now)
#pragma unroll
  for (int g = 0; g < kG; ++g) lp[g] = warp_sum(lp[g]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < kG; ++g)
      red_ml[warp * kG + g] = make_float2(m[g], lp[g]);
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int hh = 0; hh < kCcCols; ++hh) {
      const int c = lane + 32 * hh;
      if (c < nc)
        *reinterpret_cast<float4*>(red_acc + (warp * kG + g) * D + 4 * c) =
            make_float4(acc[g][hh][0], acc[g][hh][1], acc[g][hh][2],
                        acc[g][hh][3]);
    }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += kWarps * 32) {
    const int r = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, red_ml[w * kG + r].x);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float2 ml = red_ml[w * kG + r];
      if (ml.x != -INFINITY) {
        const float e = expf(ml.x - M);
        a = fmaf(e, red_acc[(w * kG + r) * D + d], a);
        L = fmaf(e, ml.y, L);
      }
    }
    const size_t o = (row0 + r) * splits + split;
    ws_acc[o * D + d] = a;
    if (d == 0) ws_ml[o] = make_float2(M, L);
  }
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

// the merge; `pdl`: launched to overlap the split kernel's tail (see
// griddep_wait), else after whatever the stream ran before it
template <typename T>
cudaError_t launch_merge(const float* ws_acc, const float2* ws_ml, void* out,
                         int BH, int D, int splits, bool pdl,
                         cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BH);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, merge_kernel<T>, ws_acc, ws_ml,
                            static_cast<T*>(out), D, splits);
}

// the bf16 split kernel (kQuant: over int8 pools; kSlice: the slice
// mode's instantiation) for padded D <= 8 * kNt, allowed the shared memory
// of head dim D on the current device
template <int kNt, bool kQuant, bool kSlice>
cudaError_t ready_bf16(int D) {
  static int allowed[64];
  return allow_smem(split_kernel_bf16<kNt, kQuant, kSlice>,
                    bf16_smem_bytes(D, kQuant, kSlice), allowed);
}

template <int kNt, bool kQuant, bool kSlice>
cudaError_t resident_bf16(int D, int* blocks) {
  const cudaError_t err = ready_bf16<kNt, kQuant, kSlice>(D);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, split_kernel_bf16<kNt, kQuant, kSlice>, kWarps * 32,
      bf16_smem_bytes(D, kQuant, kSlice));
}

template <bool kQuant, bool kSlice>
cudaError_t resident_bf16_d(int D, int* blocks) {
  const int Dp = padded_d(D);
  return Dp <= 64    ? resident_bf16<8, kQuant, kSlice>(D, blocks)
         : Dp <= 128 ? resident_bf16<16, kQuant, kSlice>(D, blocks)
                     : resident_bf16<32, kQuant, kSlice>(D, blocks);
}

template <int kNt, bool kQuant, bool kSlice>
cudaError_t launch_bf16(const void* q, const void* kpool, const void* vpool,
                        const float* kscale, const float* vscale,
                        const int32_t* pt, const int32_t* lens, float* ws_acc,
                        float2* ws_ml, int B, int H, int KVH, int D, int NP,
                        int PS, int MAXP, int PSg, int off, int pps,
                        int splits, float scale, cudaStream_t stream) {
  const int bytes = bf16_smem_bytes(D, kQuant, kSlice);
  const cudaError_t err = ready_bf16<kNt, kQuant, kSlice>(D);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  const dim3 grid(B * KVH, splits, (G + kRows - 1) / kRows);
  split_kernel_bf16<kNt, kQuant, kSlice>
      <<<grid, kWarps * 32, bytes, stream>>>(
          static_cast<const bf16*>(q), kpool, vpool, kscale, vscale, pt, lens,
          ws_acc, ws_ml, H, KVH, D, NP, PS, MAXP, PSg, off, pps, splits,
          scale);
  return cudaGetLastError();
}

template <bool kQuant, bool kSlice>
cudaError_t launch_bf16_d(const void* q, const void* kpool, const void* vpool,
                          const float* kscale, const float* vscale,
                          const int32_t* pt, const int32_t* lens,
                          float* ws_acc, float2* ws_ml, int B, int H, int KVH,
                          int D, int NP, int PS, int MAXP, int PSg, int off,
                          int pps, int splits, float scale,
                          cudaStream_t stream) {
  const int Dp = padded_d(D);
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, kpool, vpool, kscale, vscale, pt, lens, ws_acc,
                         ws_ml, B, H, KVH, D, NP, PS, MAXP, PSg, off, pps,
                         splits, scale, stream);
  };
  return Dp <= 64    ? go(launch_bf16<8, kQuant, kSlice>)
         : Dp <= 128 ? go(launch_bf16<16, kQuant, kSlice>)
                     : go(launch_bf16<32, kQuant, kSlice>);
}

// the float32-q split kernel of kG heads per block, allowed the shared
// memory of head dim D on the current device
template <int kG, bool kQuant>
cudaError_t ready_cc(int D) {
  static int allowed[64];
  return allow_smem(split_kernel_cc<kG, kQuant>, cc_smem_bytes(D, kG, kQuant),
                    allowed);
}

template <int kG, bool kQuant>
cudaError_t resident_cc(int D, int* blocks) {
  const cudaError_t err = ready_cc<kG, kQuant>(D);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, split_kernel_cc<kG, kQuant>, kWarps * 32,
      cc_smem_bytes(D, kG, kQuant));
}

template <int kG, bool kQuant>
cudaError_t launch_cc(const void* q, const void* kpool, const void* vpool,
                      const float* kscale, const float* vscale,
                      const int32_t* pt, const int32_t* lens, float* ws_acc,
                      float2* ws_ml, int B, int H, int KVH, int D, int NP,
                      int PS, int MAXP, int PSg, int off, int pps, int splits,
                      float scale, cudaStream_t stream) {
  const int bytes = cc_smem_bytes(D, kG, kQuant);
  const cudaError_t err = ready_cc<kG, kQuant>(D);
  if (err != cudaSuccess) return err;
  const int G = H / KVH;
  const dim3 grid(B * KVH, splits, (G + kG - 1) / kG);
  split_kernel_cc<kG, kQuant><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const float*>(q), kpool, vpool, kscale, vscale, pt, lens,
      ws_acc, ws_ml, H, KVH, D, NP, PS, MAXP, PSg, off, pps, splits, scale);
  return cudaGetLastError();
}

// heads per block of the float32-q kernel for G query heads per kv head:
// the least of 1, 2, 4, 8 that holds G, 8 past it (groups of 8)
int cc_heads(int G) { return G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8; }

template <bool kQuant>
cudaError_t resident_cc_g(int G, int D, int* blocks) {
  switch (cc_heads(G)) {
    case 1: return resident_cc<1, kQuant>(D, blocks);
    case 2: return resident_cc<2, kQuant>(D, blocks);
    case 4: return resident_cc<4, kQuant>(D, blocks);
    default: return resident_cc<8, kQuant>(D, blocks);
  }
}

template <bool kQuant>
cudaError_t launch_cc_g(const void* q, const void* kpool, const void* vpool,
                        const float* kscale, const float* vscale,
                        const int32_t* pt, const int32_t* lens, float* ws_acc,
                        float2* ws_ml, int B, int H, int KVH, int D, int NP,
                        int PS, int MAXP, int PSg, int off, int pps,
                        int splits, float scale, cudaStream_t stream) {
  auto go = [&](auto kernel_launch) {
    return kernel_launch(q, kpool, vpool, kscale, vscale, pt, lens, ws_acc,
                         ws_ml, B, H, KVH, D, NP, PS, MAXP, PSg, off, pps,
                         splits, scale, stream);
  };
  switch (cc_heads(H / KVH)) {
    case 1: return go(launch_cc<1, kQuant>);
    case 2: return go(launch_cc<2, kQuant>);
    case 4: return go(launch_cc<4, kQuant>);
    default: return go(launch_cc<8, kQuant>);
  }
}

// the split kernel of `dtype` (see paged_attn_launch) over the pools'
// slice (PSg, off) of each page, its partials into the workspace
cudaError_t launch_splits(int dtype, const void* q, const void* kpool,
                          const void* vpool, const void* kscale,
                          const void* vscale, const void* page_table,
                          const void* seq_lens, float* ws_acc, float2* ws_ml,
                          int B, int H, int KVH, int D, int NP, int PS,
                          int MAXP, int PSg, int off, int splits, float scale,
                          cudaStream_t s) {
  const int pps = (MAXP + splits - 1) / splits;  // pages per split
  const int32_t* pt = static_cast<const int32_t*>(page_table);
  const int32_t* lens = static_cast<const int32_t*>(seq_lens);
  const float* kss = static_cast<const float*>(kscale);
  const float* vss = static_cast<const float*>(vscale);
  switch (dtype) {
    case 0:
    case 2:
      return (dtype == 2 ? launch_cc_g<true> : launch_cc_g<false>)(
          q, kpool, vpool, kss, vss, pt, lens, ws_acc, ws_ml, B, H, KVH, D,
          NP, PS, MAXP, PSg, off, pps, splits, scale, s);
    case 1:
    case 3:  // a slice of each page (PSg > PS): the slice instantiation
      return (dtype == 3 ? PSg > PS ? launch_bf16_d<true, true>
                                    : launch_bf16_d<true, false>
              : PSg > PS ? launch_bf16_d<false, true>
                         : launch_bf16_d<false, false>)(
          q, kpool, vpool, kss, vss, pt, lens, ws_acc, ws_ml, B, H, KVH, D,
          NP, PS, MAXP, PSg, off, pps, splits, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

bool bad_operands(int dtype, int B, int H, int KVH, int D, int NP, int PS,
                  int MAXP, int splits, const void* kscale,
                  const void* vscale) {
  return B <= 0 || KVH <= 0 || H % KVH || D <= 0 || D > kMaxD || D % 8 ||
         PS <= 0 || MAXP <= 0 || NP <= 0 || splits <= 0 ||
         splits > kMaxSplits || dtype < 0 || dtype > 3 ||
         static_cast<long long>(NP) * KVH * PS > 0x7fffffffLL ||  // int rows
         (dtype >= 2) != (kscale != nullptr && vscale != nullptr);
}

}  // namespace

// Blocks of the split kernel that one SM of the current device holds at
// once, for operands of `dtype` (as below), head dim D and G query heads
// per kv head: the occupancy of the instantiation paged_attn_launch picks,
// with its registers and shared memory, written to *blocks.  The host
// sizes one wave of splits from it.  Returns the cudaError_t (0 on
// success).
extern "C" int paged_attn_resident_blocks(int dtype, int D, int G,
                                          int* blocks) {
  if (D <= 0 || D > kMaxD || D % 8 || G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (dtype) {
    case 0: err = resident_cc_g<false>(G, D, blocks); break;
    case 1: err = resident_bf16_d<false, false>(D, blocks); break;
    case 2: err = resident_cc_g<true>(G, D, blocks); break;
    case 3: err = resident_bf16_d<true, false>(D, blocks); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// The same for the page-token slice mode's launches over a slice of each
// page (paged_attn_slice_launch with PSg > PS): the tensor-core routes
// (dtypes 1 and 3) run an instantiation of their own.
extern "C" int paged_attn_slice_resident_blocks(int dtype, int D, int G,
                                                int* blocks) {
  if (dtype == 1 || dtype == 3) {
    if (D <= 0 || D > kMaxD || D % 8 || G <= 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(dtype == 3 ? resident_bf16_d<true, true>(D, blocks)
                                       : resident_bf16_d<false, true>(D, blocks));
  }
  return paged_attn_resident_blocks(dtype, D, G, blocks);
}

// dtype: 0 float32, 1 bfloat16 (q, both pools and out); 2 float32 q and
// out over int8 pools, 3 bfloat16 q and out over int8 pools, each int8
// pool with its float32 scales (kscale, vscale: one per pool row, null
// for dtypes 0 and 1).  Dtypes 0 and 2 run the CUDA-core kernel, 1 and 3
// the tensor-core one.  splits: 1 to kMaxSplits.  workspace: float32
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
  if (bad_operands(dtype, B, H, KVH, D, NP, PS, MAXP, splits, kscale, vscale))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int BH = B * H;
  float* ws_acc = static_cast<float*>(workspace);
  float2* ws_ml = reinterpret_cast<float2*>(
      ws_acc + static_cast<size_t>(BH) * splits * D);
  cudaError_t err =
      launch_splits(dtype, q, kpool, vpool, kscale, vscale, page_table,
                    seq_lens, ws_acc, ws_ml, B, H, KVH, D, NP, PS, MAXP, PS, 0,
                    splits, scale, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0 || dtype == 2
            ? launch_merge<float>(ws_acc, ws_ml, out, BH, D, splits, true, s)
            : launch_merge<bf16>(ws_acc, ws_ml, out, BH, D, splits, true, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The page-token slice mode: the split kernel alone over pools that hold a
// slice of each page, PS of its PSg tokens from token `off` on (local row
// j of logical page p is token p * PSg + off + j, live iff that token is
// below the sequence's length and the page is mapped).  Writes the splits'
// partials to the workspace as paged_attn_launch lays them out, acc (B, H,
// splits, D) then (m, l) (B, H, splits), and no output: the partials of
// several slices merge with paged_attn_merge_launch.  With PSg = PS and
// off = 0 the partials are those paged_attn_launch merges.
extern "C" int paged_attn_slice_launch(int dtype, const void* q,
                                       const void* kpool, const void* vpool,
                                       const void* kscale, const void* vscale,
                                       const void* page_table,
                                       const void* seq_lens, void* workspace,
                                       int B, int H, int KVH, int D, int NP,
                                       int PS, int MAXP, int PSg, int off,
                                       int splits, float scale, void* stream) {
  if (B <= 0) return 0;
  if (bad_operands(dtype, B, H, KVH, D, NP, PS, MAXP, splits, kscale,
                   vscale) ||
      PSg < PS || off < 0 || off > PSg - PS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H;
  float* ws_acc = static_cast<float*>(workspace);
  float2* ws_ml = reinterpret_cast<float2*>(
      ws_acc + static_cast<size_t>(BH) * splits * D);
  const cudaError_t err = launch_splits(
      dtype, q, kpool, vpool, kscale, vscale, page_table, seq_lens, ws_acc,
      ws_ml, B, H, KVH, D, NP, PS, MAXP, PSg, off, splits, scale,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PAGED_ATTN_STAMPS
namespace {
__global__ void stamp_clock_kernel(unsigned long long* out) {
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(*out)::"memory");
}
}  // namespace
// %globaltimer read by a one-thread kernel on `stream` into *out (device
// memory): bracketing a launch, it shows the gaps before its first block
// and after its last.  Returns the cudaError_t of the launch.
extern "C" int paged_attn_stamp_clock(void* out, void* stream) {
  stamp_clock_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
// The stamp buffer of the tensor-core split kernel (see STAMP): kStampWords
// unsigned 64-bit words per block, blocks in (x, y, z) order; null stops
// the stamps.  Returns the cudaError_t.
extern "C" int paged_attn_set_stamps(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(g_stamps, &buf, sizeof(buf)));
}
extern "C" int paged_attn_stamp_words() { return kStampWords; }
#endif

// The merge alone over `parts` partials per (sequence, head) row: acc
// (rows, parts, D) float32 and (m, l) (rows, parts) float2 pairs, in the
// order they are to be summed (the ranks' slices in rank order, each
// rank's splits in split order); out (rows, D) float32 (out_bf16 0) or
// bfloat16 (1).  An empty partial (m = -inf) weighs 0; a row of empty
// partials gives zeros.  Returns the cudaError_t of the launch.
extern "C" int paged_attn_merge_launch(int out_bf16, const void* acc,
                                       const void* ml, void* out, int rows,
                                       int D, int parts, void* stream) {
  if (rows <= 0) return 0;
  if (D <= 0 || parts <= 0 || parts > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float2* m = static_cast<const float2*>(ml);
  const cudaError_t err =
      out_bf16 ? launch_merge<bf16>(a, m, out, rows, D, parts, false, s)
               : launch_merge<float>(a, m, out, rows, D, parts, false, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
