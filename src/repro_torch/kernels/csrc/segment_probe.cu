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
// indicator word (4 B) and fp word (8 B), its own key (16 B), pair, parity
// and fingerprint (12 B), and writes 8 B (12 B for mutate); it does a few
// dozen integer operations per slot, far below the card's operation rate.
//
// Design: one warp per query.  Lane s loads slot s's 16-byte key as ONE
// uint4; the row is one contiguous 16*S-byte region, so the warp's loads
// coalesce into the row's few 128-byte lines (the analogue of the TPU
// kernel's one contiguous row DMA per query).  Each lane forms its slot's
// match and empty candidacy in registers; two warp-wide 64-bit min
// reductions over (rank, slot) give both argmins, ties going to the lowest
// slot as argmin's do.  No shared memory and no state across blocks; 8
// warps per block keep many independent row gathers in flight per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBig = 0x7FFFFFFF;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned long long kNone = ~0ull;

enum Mode { kProbe = 0, kProbeFp = 1, kMutate = 2 };

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

template <int MODE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
segment_probe_kernel(const uint4* __restrict__ rows,
                     const uint32_t* __restrict__ ind,
                     const uint32_t* __restrict__ fps,
                     const int32_t* __restrict__ prio,
                     const int32_t* __restrict__ pairs,
                     const int32_t* __restrict__ parity,
                     const uint4* __restrict__ qkeys,
                     const uint32_t* __restrict__ qfp,
                     int B, int P, int S,
                     int32_t* __restrict__ match,
                     int32_t* __restrict__ empty,
                     uint32_t* __restrict__ flip) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= B) return;  // q is uniform across the warp
  const int p = pairs[q];
  unsigned long long mkey = kNone;
  unsigned long long ekey = kNone;
  // a pair index outside the table reads nothing and reports miss/full
  if (p >= 0 && p < P && lane < S) {
    const int pr = parity[q] == 0 ? prio[lane] : prio[S + lane];
    const uint4 k = rows[static_cast<size_t>(p) * S + lane];
    const uint4 qk = qkeys[q];
    const bool occupied = (ind[p] >> lane) & 1u;
    bool eq = k.x == qk.x && k.y == qk.y && k.z == qk.z && k.w == qk.w;
    if (MODE != kProbe) {
      const uint32_t word = fps[2 * static_cast<size_t>(p) + (lane >> 4)];
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
    if (MODE == kMutate) {
      flip[q] = (ms >= 0 ? 1u << ms : 0u) | (es >= 0 ? 1u << es : 0u);
    }
  }
}

template <int MODE>
void launch(const void* rows, const void* ind, const void* fps,
            const void* prio, const void* pairs, const void* parity,
            const void* qkeys, const void* qfp, int B, int P, int S,
            void* match, void* empty, void* flip, cudaStream_t stream) {
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  segment_probe_kernel<MODE><<<grid, block, 0, stream>>>(
      static_cast<const uint4*>(rows), static_cast<const uint32_t*>(ind),
      static_cast<const uint32_t*>(fps), static_cast<const int32_t*>(prio),
      static_cast<const int32_t*>(pairs), static_cast<const int32_t*>(parity),
      static_cast<const uint4*>(qkeys), static_cast<const uint32_t*>(qfp),
      B, P, S, static_cast<int32_t*>(match), static_cast<int32_t*>(empty),
      static_cast<uint32_t*>(flip));
}

}  // namespace

// mode: 0 probe, 1 probe with the fp filter, 2 mutate.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int segment_probe_launch(int mode, const void* rows,
                                    const void* ind, const void* fps,
                                    const void* prio, const void* pairs,
                                    const void* parity, const void* qkeys,
                                    const void* qfp, int B, int P, int S,
                                    void* match, void* empty, void* flip,
                                    void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || S > 32) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kProbe:
      launch<kProbe>(rows, ind, fps, prio, pairs, parity, qkeys, qfp, B, P,
                     S, match, empty, flip, s);
      break;
    case kProbeFp:
      launch<kProbeFp>(rows, ind, fps, prio, pairs, parity, qkeys, qfp, B, P,
                       S, match, empty, flip, s);
      break;
    case kMutate:
      launch<kMutate>(rows, ind, fps, prio, pairs, parity, qkeys, qfp, B, P,
                      S, match, empty, flip, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
