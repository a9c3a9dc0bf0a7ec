// Hopper kernels of the continuity store's request path: the segment probe
// of a lookup and the mutation plan of an update/delete.
//
// Replaces the TPU kernels
//   src/repro/kernels/probe.py  probe_segments (_probe_kernel, _probe_kernel_fp)
//   src/repro/kernels/mutate.py mutate_segments (_mutate_kernel)
// One template, three modes: probe without and with the fingerprint
// pre-filter, and mutate (filter always on, plus the XOR commit mask).
//
// Bound: device-memory bytes.  Per query the function reads one S-slot key
// row (16*S bytes at a random row of a multi-gigabyte table), the pair's
// indicator word (4 B) and fp words (8 B), its own key (16 B), pair, parity
// and fingerprint (12 B), and writes 8 B (12 B for mutate); it does a few
// dozen integer operations per slot, far below the card's operation rate.
// The reads are random: a row spans ~3 lines of 128 B and the indicator and
// fp words one 32-byte sector each, so the memory system serves ~5 random
// accesses per query, and such reads run well below the card's byte rate
// (PERF.md).
//
// Design: two kernels, the host picks one per launch (no device read).
// - A batch that one wave of one-warp-per-query blocks covers (8,448
//   queries at 8 warps per block) takes segment_probe_direct_kernel: one
//   warp per query, lane s loads slot s's key straight into registers, two
//   warp-wide minimum reductions give the argmins.  Its chain of memory
//   trips (pair, then row) is the shortest, and a small batch is
//   latency-bound.
// - A larger batch takes segment_probe_kernel: persistent warps, a tile of
//   up to 32 queries per warp (one per lane), rows in flight as TMA bulk
//   copies into shared memory.  The host launches one wave of resident
//   blocks (the runtime's occupancy of the instantiation launched,
//   segment_probe_resident_blocks), with the smallest power-of-two tile
//   that the wave covers, so a mid-size batch spreads over every warp and
//   each warp issues few copies (a warp issues its lanes' bulk copies one
//   after another, ~40 ns each); warp w of the grid walks tiles w,
//   w + warps, ... of the batch.
//   Lane i of a tile owns query i.  Its pair index comes from a coalesced
//   load issued one tile ahead, so the dependent trip to the row overlaps
//   the tile in flight.  With the pair in hand the lane copies the query's
//   row, one contiguous 16*S-byte region (the TPU kernel's single row DMA,
//   the paper's single RDMA read), with ONE bulk copy (cp.async.bulk) into
//   the warp's stage in shared memory, completing on the stage's mbarrier,
//   and loads its key, parity, fingerprint, indicator word and fp words
//   into registers; all of them are in flight together.  The row copy
//   carries an L2 evict-first hint: a row is read once per call, and
//   keeping rows out of L2 leaves it to the indicator and fp words (12 B
//   per pair, 50 MB at 2^23 buckets), which every call reads at random.
//   Nothing is read for a lane past the batch or with a pair outside
//   [0, P): the stage expects only the bytes of the copies issued, and the
//   lane reports -1 / -1 (flip 0).
//   Each warp has one tile in flight and copies the next once it has
//   resolved it; 16 warps per SM keep ~170 KB of rows in flight.  Chip
//   measurements (PERF.md) found this as fast as rings of 2 to 4 tiles per
//   warp at every batch size: the memory system's rate of random reads,
//   not the latency of one warp's trips, sets the time.
//   Rows land with a pitch of an odd number of 16-byte units (16 * (S | 1)
//   bytes), so the 8 lanes of a quarter warp reading 16 bytes each at the
//   same slot fall on 8 distinct bank groups.
//   Each lane resolves its own query: the fingerprint filter becomes a
//   32-bit mask of the slots whose 2-bit field equals the query's; the
//   lane compares keys only at the set bits of (occupied & filter &
//   candidate), and takes the least (rank, slot) of the hits and of the
//   empty candidates.  Where a parity's ranks rise with the slot (or
//   strictly fall), that is the lowest (highest) set bit, one instruction;
//   otherwise a walk keeping the minimum (strict <, ascending slots: ties
//   go to the lowest slot, as argmin's do).  prio (2 x S), each parity's
//   candidate mask and its order are staged in shared memory once per
//   block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 0x7FFFFFFF;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 32;       // queries per warp tile: one per lane
constexpr int kWarps = 8;       // warps per block
constexpr int kMaxSlots = 32;   // two fp words carry 32 2-bit fields

enum Mode { kProbe = 0, kProbeFp = 1, kMutate = 2 };
enum Order { kUnordered = 0, kAscending = 1, kDescending = 2 };

// Shared memory: [an mbarrier per warp][prio][candidate masks][orders]
// [each warp's stage: a tile of rows]
constexpr int kBarBytes = kWarps * 8;
constexpr int kPrioOff = (kBarBytes + 15) & ~15;
constexpr int kCandOff = kPrioOff + 2 * kMaxSlots * 4;  // [2] masks
constexpr int kDirOff = kCandOff + 8;                     // [2] orders
constexpr int kHeadBytes = kCandOff + 16;

__host__ __device__ constexpr int row_pitch(int S) { return 16 * (S | 1); }
__host__ __device__ constexpr int smem_bytes(int S) {
  return kHeadBytes + kWarps * kTile * row_pitch(S);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier of a warp's stage: one arrival (with the stage's byte count)
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
// on the mbarrier, its lines marked first to evict from L2
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// bit s set iff the 2-bit field of slot s in the fp words equals qf
__device__ __forceinline__ uint32_t fp_mask(uint2 w, uint32_t qf) {
  if (qf > 3u) return 0u;
  uint32_t half[2] = {w.x, w.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t z = half[i] ^ (qf * 0x55555555u);  // equal field -> 00
    uint32_t e = ~(z | (z >> 1)) & 0x55555555u;       // bit 2f per field f
    e = (e | (e >> 1)) & 0x33333333u;                 // gather the even bits
    e = (e | (e >> 2)) & 0x0F0F0F0Fu;
    e = (e | (e >> 4)) & 0x00FF00FFu;
    half[i] = (e | (e >> 8)) & 0x0000FFFFu;
  }
  return half[0] | (half[1] << 16);
}

template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
segment_probe_kernel(const uint4* __restrict__ rows,
                     const uint32_t* __restrict__ ind,
                     const uint2* __restrict__ fps,
                     const int32_t* __restrict__ prio,
                     const int32_t* __restrict__ pairs,
                     const int32_t* __restrict__ parity,
                     const uint4* __restrict__ qkeys,
                     const uint32_t* __restrict__ qfp,
                     int B, int P, int S, int tile,
                     int32_t* __restrict__ match,
                     int32_t* __restrict__ empty,
                     uint32_t* __restrict__ flip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tiles = (B + tile - 1) / tile;
  const int nw = gridDim.x * kWarps;  // warps of the grid
  const int gw = blockIdx.x * kWarps + warp;
  const int mine = gw < tiles ? (tiles - 1 - gw) / nw + 1 : 0;
  const uint32_t bar = smem_u32(smem) + warp * 8;  // the warp's mbarrier
  int32_t* prio_s = reinterpret_cast<int32_t*>(smem + kPrioOff);
  uint32_t* cand_s = reinterpret_cast<uint32_t*>(smem + kCandOff);
  int32_t* dir_s = reinterpret_cast<int32_t*>(smem + kDirOff);
  const int pitch = row_pitch(S);
  // this lane's row in the warp's stage
  const unsigned char* row_s =
      smem + kHeadBytes + (warp * kTile + lane) * pitch;
  // query of this lane in the warp's k-th tile (lanes below `tile`)
  auto query = [&](int k) { return (gw + k * nw) * tile + lane; };
  const bool mine_lane = lane < tile;
  // its pair index (coalesced over the tile); -1 past the warp's tiles or
  // the batch
  auto pair_of = [&](int k) {
    return mine_lane && k < mine && query(k) < B ? __ldg(pairs + query(k))
                                                 : -1;
  };
  int next = pair_of(0);  // this lane's pair in the next tile to copy

  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) prio_s[i] = prio[i];
  if (warp == 0) {
    // per parity: the candidate slots, and whether their ranks never
    // decrease with the slot (the lowest candidate of a set has its least
    // rank: kAscending) or strictly decrease (the highest: kDescending)
#pragma unroll
    for (int par = 0; par < 2; ++par) {
      const int r = lane < S ? prio[par * S + lane] : kBig;
      const unsigned cand = __ballot_sync(kFull, r < kBig);
      const unsigned above = cand & ~((2u << lane) - 1u);  // 0 at lane 31
      const int rn = __shfl_sync(kFull, r, above ? __ffs(above) - 1 : lane);
      const bool last = !((cand >> lane) & 1u) || !above;
      const bool up = __all_sync(kFull, last || r <= rn);
      const bool down = __all_sync(kFull, last || r > rn);
      if (lane == 0) {
        cand_s[par] = cand;
        dir_s[par] = up ? kAscending : down ? kDescending : kUnordered;
      }
    }
  }
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  uint64_t evict_first;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(evict_first));

  // this lane's query fields in the tile in flight, loaded with its row
  uint4 qk;
  uint2 fw;
  uint32_t occ, qf;
  int par;
  bool live;

  // copy the k-th tile into the stage (p: this lane's pair)
  auto issue = [&](int k, int p) {
    const int q = query(k);
    live = mine_lane && q < B && p >= 0 && p < P;
    const int n = __popc(__ballot_sync(kFull, live));
    if (lane == 0) mbar_expect_tx(bar, n * 16 * S);
    __syncwarp();
    if (live) {
      if (k > 0)  // the stage was read through the generic proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_copy(smem_u32(row_s), rows + static_cast<size_t>(p) * S, 16 * S,
                bar, evict_first);
      qk = qkeys[q];
      occ = ind[p];
      par = parity[q];
      if (MODE != kProbe) {
        fw = fps[p];
        qf = qfp[q];
      }
    }
  };

  // resolve the k-th tile from the stage
  auto resolve = [&](int k) {
    const int q = query(k);
    if (!mine_lane || q >= B) return;
    int ms = -1, es = -1;
    if (live) {
      const int pa = par == 0 ? 0 : 1;
      const int32_t* pr = prio_s + pa * S;
      const uint32_t cand = cand_s[pa];
      const bool ordered = dir_s[pa] != kUnordered;
      const bool down = dir_s[pa] == kDescending;
      const uint32_t em = ~occ & cand;  // empty candidates
      uint32_t mm = occ & cand;         // occupied candidates
      if (MODE != kProbe) mm &= fp_mask(fw, qf);
      // the slots of mm holding the query's key: independent compares
      const uint4* row = reinterpret_cast<const uint4*>(row_s);
      uint32_t hit = 0;
      for (; mm; mm &= mm - 1) {
        const int s = __ffs(mm) - 1;
        const uint4 r = row[s];
        hit |= static_cast<uint32_t>(r.x == qk.x && r.y == qk.y &&
                                     r.z == qk.z && r.w == qk.w)
               << s;
      }
      // the least (rank, slot) of a set: its first slot in probe order
      // where the ranks are monotone, else a walk keeping the minimum
      auto least = [&](uint32_t m) {
        if (!m) return -1;
        if (ordered) return down ? 31 - __clz(m) : __ffs(m) - 1;
        int best = kBig, slot = -1;
        for (; m; m &= m - 1) {
          const int s = __ffs(m) - 1;
          if (pr[s] < best) {
            best = pr[s];
            slot = s;
          }
        }
        return slot;
      };
      ms = least(hit);
      es = least(em);
    }
    match[q] = ms;
    empty[q] = es;
    if (MODE == kMutate)
      flip[q] = (ms >= 0 ? 1u << ms : 0u) | (es >= 0 ? 1u << es : 0u);
  };

  if (mine > 0) issue(0, next);
  next = pair_of(1);
  for (int k = 0; k < mine; ++k) {
    mbar_wait(bar, k & 1);
    resolve(k);
    __syncwarp();  // every lane is done with the stage refilled here
    if (k + 1 < mine) {
      issue(k + 1, next);
      next = pair_of(k + 2);
    }
  }
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// One warp per query, its lanes over the slots (the path of a batch that
// one wave of such warps covers): lane s loads slot s's key straight into
// registers, and two warp-wide 64-bit minimum reductions over (rank, slot)
// give both argmins, ties going to the lowest slot.
template <int MODE>
__global__ void __launch_bounds__(kWarps * 32)
segment_probe_direct_kernel(const uint4* __restrict__ rows,
                            const uint32_t* __restrict__ ind,
                            const uint2* __restrict__ fps,
                            const int32_t* __restrict__ prio,
                            const int32_t* __restrict__ pairs,
                            const int32_t* __restrict__ parity,
                            const uint4* __restrict__ qkeys,
                            const uint32_t* __restrict__ qfp,
                            int B, int P, int S,
                            int32_t* __restrict__ match,
                            int32_t* __restrict__ empty,
                            uint32_t* __restrict__ flip) {
  constexpr unsigned long long kNone = ~0ull;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // q is uniform across the warp
  const int p = pairs[q];
  unsigned long long mkey = kNone, ekey = kNone;
  if (p >= 0 && p < P && lane < S) {
    const int pr = parity[q] == 0 ? prio[lane] : prio[S + lane];
    const uint4 k = rows[static_cast<size_t>(p) * S + lane];
    const uint4 qk = qkeys[q];
    const bool occupied = (ind[p] >> lane) & 1u;
    bool eq = k.x == qk.x && k.y == qk.y && k.z == qk.z && k.w == qk.w;
    if (MODE != kProbe) {
      const uint32_t word =
          reinterpret_cast<const uint32_t*>(fps)[2 * static_cast<size_t>(p) +
                                                 (lane >> 4)];
      eq = eq && ((word >> (2 * (lane & 15))) & 3u) == qfp[q];
    }
    if (pr < kBig) {
      // order-preserving signed -> unsigned rank in the high half, the
      // slot in the low half: the minimum is the lowest rank, then slot
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<uint32_t>(pr) ^
                                           0x80000000u) << 32) |
          static_cast<unsigned>(lane);
      if (occupied && eq) mkey = key;
      if (!occupied) ekey = key;
    }
  }
  mkey = warp_min(mkey);
  ekey = warp_min(ekey);
  if (lane == 0) {
    const int ms = mkey == kNone ? -1 : static_cast<int>(mkey & 31u);
    const int es = ekey == kNone ? -1 : static_cast<int>(ekey & 31u);
    match[q] = ms;
    empty[q] = es;
    if (MODE == kMutate)
      flip[q] = (ms >= 0 ? 1u << ms : 0u) | (es >= 0 ? 1u << es : 0u);
  }
}

// the kernel a launch picks: tiles of `tile` queries, or (tile 0) one
// warp per query, with its dynamic shared memory, allowed on the current
// device
template <int MODE>
cudaError_t ready(int S, int tile, const void** kernel, int* bytes) {
  static int allowed[64];  // per device: the dynamic shared memory allowed
  *kernel = tile ? reinterpret_cast<const void*>(segment_probe_kernel<MODE>)
                 : reinterpret_cast<const void*>(
                       segment_probe_direct_kernel<MODE>);
  *bytes = tile ? smem_bytes(S) : 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && tile && (dev >= 64 || allowed[dev] < *bytes)) {
    err = cudaFuncSetAttribute(segment_probe_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *bytes);
    if (err == cudaSuccess && dev < 64) allowed[dev] = *bytes;
  }
  if (err != cudaSuccess) cudaGetLastError();  // reported here, not later
  return err;
}

template <int MODE>
cudaError_t resident(int S, int tile, int* blocks) {
  const void* kernel;
  int bytes;
  cudaError_t err = ready<MODE>(S, tile, &kernel, &bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                        kWarps * 32, bytes);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

template <int MODE>
cudaError_t launch(const void* rows, const void* ind, const void* fps,
                   const void* prio, const void* pairs, const void* parity,
                   const void* qkeys, const void* qfp, int B, int P, int S,
                   int tile, void* match, void* empty, void* flip,
                   int blocks, cudaStream_t stream) {
  const void* kernel;
  int bytes;
  const cudaError_t err = ready<MODE>(S, tile, &kernel, &bytes);
  if (err != cudaSuccess) return err;
  const auto* r = static_cast<const uint4*>(rows);
  const auto* i = static_cast<const uint32_t*>(ind);
  const auto* f = static_cast<const uint2*>(fps);
  const auto* pr = static_cast<const int32_t*>(prio);
  const auto* pa = static_cast<const int32_t*>(pairs);
  const auto* par = static_cast<const int32_t*>(parity);
  const auto* qk = static_cast<const uint4*>(qkeys);
  const auto* qf = static_cast<const uint32_t*>(qfp);
  auto* m = static_cast<int32_t*>(match);
  auto* e = static_cast<int32_t*>(empty);
  auto* fl = static_cast<uint32_t*>(flip);
  if (tile)
    segment_probe_kernel<MODE><<<blocks, kWarps * 32, bytes, stream>>>(
        r, i, f, pr, pa, par, qk, qf, B, P, S, tile, m, e, fl);
  else
    segment_probe_direct_kernel<MODE><<<blocks, kWarps * 32, 0, stream>>>(
        r, i, f, pr, pa, par, qk, qf, B, P, S, m, e, fl);
  return cudaGetLastError();
}

// tile: 0 (one warp per query) or a power of two up to kTile
bool valid_shape(int mode, int S, int tile) {
  return mode >= kProbe && mode <= kMutate && S >= 1 && S <= kMaxSlots &&
         tile >= 0 && tile <= kTile && (tile & (tile - 1)) == 0;
}

}  // namespace

// Blocks (of kWarps warps) that one SM of the current device holds at once
// for mode `mode`, S slots and tiles of `tile` queries (0: one warp per
// query): the occupancy of the kernel segment_probe_launch picks, with its
// shared memory, written to *blocks.  The host sizes one wave from it.
// Returns the cudaError_t (0 on success).
extern "C" int segment_probe_resident_blocks(int mode, int S, int tile,
                                             int* blocks) {
  if (!valid_shape(mode, S, tile))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (mode) {
    case kProbe:
      err = resident<kProbe>(S, tile, blocks);
      break;
    case kProbeFp:
      err = resident<kProbeFp>(S, tile, blocks);
      break;
    default:
      err = resident<kMutate>(S, tile, blocks);
      break;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one block of the tiled kernel for S slots, in
// bytes; the one-warp-per-query kernel takes none.
extern "C" int segment_probe_smem_bytes(int S) { return smem_bytes(S); }

// mode: 0 probe, 1 probe with the fp filter, 2 mutate.  rows: (P, 4*S)
// words, 16-byte aligned; fps: (P, 2) words, 8-byte aligned (modes 1, 2);
// qkeys: (B, 4) words, 16-byte aligned.  tile: queries per warp tile, a
// power of two up to 32, or 0 for one warp per query (then
// blocks * kWarps >= B); blocks: the grid of kWarps-warp blocks (one wave
// of resident blocks at most).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int segment_probe_launch(int mode, const void* rows,
                                    const void* ind, const void* fps,
                                    const void* prio, const void* pairs,
                                    const void* parity, const void* qkeys,
                                    const void* qfp, int B, int P, int S,
                                    int tile, void* match, void* empty,
                                    void* flip, int blocks, void* stream) {
  if (B <= 0) return 0;
  if (!valid_shape(mode, S, tile) || blocks < 1 ||
      (!tile && static_cast<long long>(blocks) * kWarps < B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (mode) {
    case kProbe:
      err = launch<kProbe>(rows, ind, fps, prio, pairs, parity, qkeys, qfp, B,
                           P, S, tile, match, empty, flip, blocks, s);
      break;
    case kProbeFp:
      err = launch<kProbeFp>(rows, ind, fps, prio, pairs, parity, qkeys, qfp,
                             B, P, S, tile, match, empty, flip, blocks, s);
      break;
    default:
      err = launch<kMutate>(rows, ind, fps, prio, pairs, parity, qkeys, qfp,
                            B, P, S, tile, match, empty, flip, blocks, s);
      break;
  }
  return static_cast<int>(err);
}
