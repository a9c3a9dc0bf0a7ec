// Hopper kernel of the baselines' write paths: the serial walk.
//
// No TPU kernel is replaced.  The reference's level and P-FaRM-KV
// insert / update / delete (src/repro/core/level.py:344, :354, :363 and
// src/repro/core/pfarm.py:352, :362, :371) are a jax.lax.scan over the
// batch: each op reads the tokens and slots the previous op left, and takes
// one branch of a lax.cond (level: plain or one-movement insert, free or
// logged update; pfarm: plain, one displacement or a chain block).  The
// walk is exact by construction: it applies the batch in batch order.
//
// Bound: latency.  Each op needs at least one dependent random trip to
// device memory (the candidate buckets' token bytes; chase_kernel below
// measures that trip alone), and op
// i + 1 may read what op i wrote, so the ops cannot overlap without a
// hazard check.  The bytes and operations per op are tiny (a few token
// bytes, up to 32 keys of 16 B, a few hashes).
//
// Design: two kernels, launched together by scan_walk_launch.
// - prologue_kernel (one thread per op, many blocks): what depends only on
//   the key, computed for the whole batch at once: level's four candidate
//   buckets [top h1, top h2, bottom h1/2, bottom h2/2], pfarm's home bucket.
// - walk_kernel (one block of one warp): the ops one at a time, in batch
//   order.  Every 32 ops the warp loads their flags, candidates, keys and
//   values in one coalesced trip; each op's fields reach every lane by
//   shuffles.  Lanes run over the op's candidate slots (level: 4 buckets x
//   bucket_slots; pfarm: the window's H buckets x bucket_slots), each lane
//   reading its bucket's token byte (and its slot's key for update and
//   delete, in flight together); a ballot gives the first empty or
//   matching slot in the reference's flattened order (argmax of a boolean
//   = the first set bit).
//   Pfarm's displacement puts the lanes over the window's items: each hashes
//   its item's key to its home (device hash128, bit-exact with
//   core/hashfn.py) and finds the first free slot of that item's window
//   (its tokens loaded together: one trip).
//   The rare paths (level's move, pfarm's chain) run the same scalar code on
//   every lane.  Lane 0 makes every store, in the reference's store order
//   (slot payload, then the token byte); a __syncwarp after each op orders
//   them before the next op's loads.  Table loads go through L2 (ld.cg).
//   count and ocount live in registers and are stored at the end; ok and pm
//   (the PM writes each op charged) go out every 32 ops, coalesced.
//   Overlapping the next ops' token reads with the current op is left to a
//   later redesign.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSeed2 = 0x5BD1E995u;   // hash128_2's seed
constexpr int kWin = 8;     // window tokens a displacement loads at once

enum Mode {
  kLevelInsert = 0, kLevelUpdate = 1, kLevelDelete = 2,
  kPfarmInsert = 3, kPfarmUpdate = 4, kPfarmDelete = 5,
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// core/hashfn.hash128: murmur3-32 style over the four key lanes.
__device__ __forceinline__ uint32_t hash128(uint4 k, uint32_t seed) {
  const uint32_t lane[4] = {k.x, k.y, k.z, k.w};
  uint32_t h = seed ^ 16u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t l = lane[i] * 0xCC9E2D51u;
    l = rotl32(l, 15);
    l *= 0x1B873593u;
    h = rotl32(h ^ l, 13);
    h = h * 5u + 0xE6546B64u;
  }
  return fmix32(h);
}

__device__ __forceinline__ bool same(uint4 a, uint4 b) {
  return a.x == b.x && a.y == b.y && a.z == b.z && a.w == b.w;
}

// First clear bit of a token below bs, or -1.
__device__ __forceinline__ int first_empty(uint32_t tok, int bs) {
  const uint32_t free = ~tok & ((1u << bs) - 1u);
  return free ? __ffs(free) - 1 : -1;
}

__device__ __forceinline__ uint4 shfl4(uint4 v, int src) {
  v.x = __shfl_sync(kFull, v.x, src);
  v.y = __shfl_sync(kFull, v.y, src);
  v.z = __shfl_sync(kFull, v.z, src);
  v.w = __shfl_sync(kFull, v.w, src);
  return v;
}

__device__ __forceinline__ uint32_t ld_tok(const uint8_t* p, size_t i) {
  return __ldcg(p + i);
}

__device__ __forceinline__ uint4 ld_slot(const uint4* p, size_t i) {
  return __ldcg(p + i);
}

// Table pointers and geometry.  Level: a = top level (n_a = num_top
// buckets), b = bottom level (n_b = num_top / 2).  Pfarm: a = the main
// buckets (n_a = num_buckets), b = the overflow pool (n_b = pool_blocks),
// plus the chain heads and links.
struct Table {
  uint4* keys_a;
  uint4* vals_a;
  uint8_t* tok_a;
  uint4* keys_b;
  uint4* vals_b;
  uint8_t* tok_b;
  int* head;
  int* onext;
  int* ocount;
  int* count;
  int n_a, n_b, bs, window, max_chain;
};

__global__ void prologue_kernel(int mode, const uint4* __restrict__ qkeys,
                                int B, int n, int* __restrict__ cand) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const uint4 k = qkeys[i];
  const uint32_t h1 = hash128(k, 0u) % static_cast<uint32_t>(n);
  if (mode <= kLevelDelete) {
    const uint32_t h2 = hash128(k, kSeed2) % static_cast<uint32_t>(n);
    reinterpret_cast<int4*>(cand)[i] =
        make_int4(static_cast<int>(h1), static_cast<int>(h2),
                  static_cast<int>(h1 / 2), static_cast<int>(h2 / 2));
  } else {
    cand[i] = static_cast<int>(h1);
  }
}

// -- level --------------------------------------------------------------------

// One level op.  c: the candidates; returns the PM writes it charged (0:
// the op failed).
__device__ int level_op(int mode, const Table& t, int4 c, uint4 key,
                        uint4 val, int lane) {
  const int bs = t.bs;
  const int j = lane / bs, s = lane % bs;
  const bool in = lane < 4 * bs;
  const int cj = j == 0 ? c.x : j == 1 ? c.y : j == 2 ? c.z : c.w;
  const bool top = j < 2;
  const uint8_t* tokp = top ? t.tok_a : t.tok_b;
  const uint32_t tok = in ? ld_tok(tokp, cj) : 0xFFu;
  const bool leader = lane == 0;

  if (mode == kLevelInsert) {
    const unsigned E = __ballot_sync(kFull, in && !((tok >> s) & 1u));
    if (E) {                                   // plain: first empty slot
      const int f = __ffs(E) - 1;
      const uint32_t ftok = __shfl_sync(kFull, tok, f);
      const int fj = f / bs, fs = f % bs;
      const int b = __shfl_sync(kFull, cj, f);
      if (leader) {
        const size_t at = static_cast<size_t>(b) * bs + fs;
        (fj < 2 ? t.keys_a : t.keys_b)[at] = key;
        (fj < 2 ? t.vals_a : t.vals_b)[at] = val;
        (fj < 2 ? t.tok_a : t.tok_b)[b] =
            static_cast<uint8_t>(ftok | (1u << fs));
      }
      return 2;
    }
    // one movement: top[h1]'s slot-0 item to its alternate top bucket
    const int c0 = c.x;
    const uint4 mkey = ld_slot(t.keys_a, static_cast<size_t>(c0) * bs);
    const uint4 mval = ld_slot(t.vals_a, static_cast<size_t>(c0) * bs);
    const uint32_t nt = static_cast<uint32_t>(t.n_a);
    const int a1 = static_cast<int>(hash128(mkey, 0u) % nt);
    const int a2 = static_cast<int>(hash128(mkey, kSeed2) % nt);
    const int alt = a1 == c0 ? a2 : a1;
    const uint32_t atok = ld_tok(t.tok_a, alt);
    const int aslot = first_empty(atok, bs);
    if (aslot < 0 || alt == c0) return 0;
    if (leader) {
      const size_t dst = static_cast<size_t>(alt) * bs + aslot;
      const size_t src = static_cast<size_t>(c0) * bs;
      t.keys_a[dst] = mkey;
      t.vals_a[dst] = mval;
      t.tok_a[alt] = static_cast<uint8_t>(atok | (1u << aslot));
      const uint32_t stok = ld_tok(t.tok_a, c0) & 0xFEu;
      t.tok_a[c0] = static_cast<uint8_t>(stok);
      t.keys_a[src] = key;
      t.vals_a[src] = val;
      t.tok_a[c0] = static_cast<uint8_t>(stok | 1u);
    }
    return 5;
  }

  // update / delete: the first match over [t1, t2, b1, b2] x slots; the
  // slot's key is loaded whatever its bit, so its trip overlaps the token's
  uint4 k = make_uint4(0, 0, 0, 0);
  if (in) {
    k = ld_slot(top ? t.keys_a : t.keys_b, static_cast<size_t>(cj) * bs + s);
  }
  const bool match = in && ((tok >> s) & 1u) && same(k, key);
  const unsigned M = __ballot_sync(kFull, match);
  if (!M) return 0;
  const int f = __ffs(M) - 1;
  const int fj = f / bs, fs = f % bs;
  const uint32_t ftok = __shfl_sync(kFull, tok, f);
  const int b = __shfl_sync(kFull, cj, f);
  uint8_t* tokp_f = fj < 2 ? t.tok_a : t.tok_b;
  if (mode == kLevelDelete) {
    if (leader) tokp_f[b] = static_cast<uint8_t>(ftok & ~(1u << fs));
    return 1;
  }
  const int e = first_empty(ftok, bs);
  const size_t base = static_cast<size_t>(b) * bs;
  if (e >= 0) {                  // log-free out of place in the same bucket
    if (leader) {
      (fj < 2 ? t.keys_a : t.keys_b)[base + e] = key;
      (fj < 2 ? t.vals_a : t.vals_b)[base + e] = val;
      tokp_f[b] = static_cast<uint8_t>(ftok ^ ((1u << e) | (1u << fs)));
    }
    return 2;
  }
  if (leader) {                  // logged in place
    (fj < 2 ? t.keys_a : t.keys_b)[base + fs] = key;
    (fj < 2 ? t.vals_a : t.vals_b)[base + fs] = val;
  }
  return 4;
}

// -- pfarm --------------------------------------------------------------------

// Where a pfarm key lives: the first window match (bucket-major), else the
// first chain block holding it within max_chain hops.
struct Where {
  bool found;
  bool chain;
  int bucket;
  int slot;
  uint32_t tok;   // the bucket's (or block's) token byte as read
};

__device__ Where pfarm_find(const Table& t, int home, uint4 key, int lane) {
  const int bs = t.bs;
  const int j = lane / bs, s = lane % bs;
  const bool in = lane < t.window * bs;
  const int b = (home + j) % t.n_a;
  bool match = false;
  uint32_t tok = 0;
  if (in) {              // token and key in flight together
    tok = ld_tok(t.tok_a, b);
    const uint4 k = ld_slot(t.keys_a, static_cast<size_t>(b) * bs + s);
    match = ((tok >> s) & 1u) && same(k, key);
  }
  const unsigned M = __ballot_sync(kFull, match);
  if (M) {
    const int f = __ffs(M) - 1;
    return {true, false, (home + f / bs) % t.n_a, f % bs,
            __shfl_sync(kFull, tok, f)};
  }
  int cur = __ldcg(t.head + home);
  for (int hop = 0; hop < t.max_chain && cur >= 0; ++hop) {
    bool m = false;
    uint32_t btok = 0;
    if (lane < bs) {
      btok = ld_tok(t.tok_b, cur);
      const uint4 k = ld_slot(t.keys_b, static_cast<size_t>(cur) * bs + lane);
      m = ((btok >> lane) & 1u) && same(k, key);
    }
    const unsigned Mb = __ballot_sync(kFull, m);
    if (Mb) {
      const int f = __ffs(Mb) - 1;
      return {true, true, cur, f, __shfl_sync(kFull, btok, f)};
    }
    cur = __ldcg(t.onext + cur);
  }
  return {false, false, 0, 0, 0};
}

// One pfarm op; returns whether it succeeded.  ocount: the pool blocks
// allocated so far (uniform across the warp).
__device__ bool pfarm_op(int mode, const Table& t, int home, uint4 key,
                         uint4 val, int lane, int& ocount) {
  const int bs = t.bs, H = t.window, N = t.n_a;
  const bool leader = lane == 0;
  if (mode != kPfarmInsert) {
    const Where w = pfarm_find(t, home, key, lane);
    if (!w.found) return false;
    if (leader) {
      const size_t at = static_cast<size_t>(w.bucket) * bs + w.slot;
      if (mode == kPfarmDelete) {
        (w.chain ? t.tok_b : t.tok_a)[w.bucket] =
            static_cast<uint8_t>(w.tok & ~(1u << w.slot));
      } else {
        (w.chain ? t.vals_b : t.vals_a)[at] = val;
      }
    }
    return true;
  }

  const int j = lane / bs, s = lane % bs;
  const bool in = lane < H * bs;
  const int b = (home + j) % N;
  const uint32_t tok = in ? ld_tok(t.tok_a, b) : 0xFFu;
  const unsigned E = __ballot_sync(kFull, in && !((tok >> s) & 1u));
  if (E) {                                     // plain: first empty slot
    const int f = __ffs(E) - 1;
    const int fb = (home + f / bs) % N, fs = f % bs;
    const uint32_t ftok = __shfl_sync(kFull, tok, f);
    if (leader) {
      const size_t at = static_cast<size_t>(fb) * bs + fs;
      t.keys_a[at] = key;
      t.vals_a[at] = val;
      t.tok_a[fb] = static_cast<uint8_t>(ftok | (1u << fs));
    }
    return true;
  }

  // one displacement: lane i owns window item i; its first free slot in
  // its own window (bucket-major), as a flat index into that window
  int dflat = -1, whome = 0;
  if (in) {
    const uint4 item = ld_slot(t.keys_a, static_cast<size_t>(b) * bs + s);
    whome = static_cast<int>(hash128(item, 0u) % static_cast<uint32_t>(N));
    // the first kWin window tokens in flight together, then the rest
    uint32_t wt[kWin];
#pragma unroll
    for (int jj = 0; jj < kWin; ++jj)
      wt[jj] = jj < H ? ld_tok(t.tok_a, (whome + jj) % N) : 0xFFu;
#pragma unroll
    for (int jj = 0; jj < kWin; ++jj) {
      const int e = first_empty(wt[jj], bs);
      if (dflat < 0 && jj < H && e >= 0) dflat = jj * bs + e;
    }
    for (int jj = kWin; jj < H && dflat < 0; ++jj) {
      const int e = first_empty(ld_tok(t.tok_a, (whome + jj) % N), bs);
      if (e >= 0) dflat = jj * bs + e;
    }
  }
  const unsigned C = __ballot_sync(kFull, dflat >= 0);
  if (C) {
    const int m = __ffs(C) - 1;
    const int src_b = (home + m / bs) % N, src_s = m % bs;
    const int df = __shfl_sync(kFull, dflat, m);
    const int dh = __shfl_sync(kFull, whome, m);
    const int dst_b = (dh + df / bs) % N, dst_s = df % bs;
    if (leader) {
      const size_t src = static_cast<size_t>(src_b) * bs + src_s;
      const size_t dst = static_cast<size_t>(dst_b) * bs + dst_s;
      const uint4 mk = ld_slot(t.keys_a, src);
      const uint4 mv = ld_slot(t.vals_a, src);
      t.keys_a[dst] = mk;
      t.vals_a[dst] = mv;
      t.tok_a[dst_b] =
          static_cast<uint8_t>(ld_tok(t.tok_a, dst_b) | (1u << dst_s));
      t.tok_a[src_b] =
          static_cast<uint8_t>(ld_tok(t.tok_a, src_b) & ~(1u << src_s));
      t.keys_a[src] = key;
      t.vals_a[src] = val;
      t.tok_a[src_b] =
          static_cast<uint8_t>(ld_tok(t.tok_a, src_b) | (1u << src_s));
    }
    return true;
  }

  // chain: the head block if it has a free slot, else a fresh block
  const int head = __ldcg(t.head + home);
  const int hslot = head >= 0 ? first_empty(ld_tok(t.tok_b, head), bs) : -1;
  int blk, slot;
  if (hslot >= 0) {
    blk = head;
    slot = hslot;
  } else if (ocount < t.n_b) {
    blk = ocount;
    slot = 0;
  } else {
    return false;                              // the pool is full
  }
  if (leader) {
    const size_t at = static_cast<size_t>(blk) * bs + slot;
    t.keys_b[at] = key;
    t.vals_b[at] = val;
    t.tok_b[blk] = static_cast<uint8_t>(ld_tok(t.tok_b, blk) | (1u << slot));
    if (hslot < 0) {
      t.onext[blk] = head;
      t.head[home] = blk;
    }
  }
  if (hslot < 0) ++ocount;
  return true;
}

// -- the walk -----------------------------------------------------------------

__global__ void __launch_bounds__(32, 1)
walk_kernel(int mode, Table t, const uint4* __restrict__ qkeys,
            const uint4* __restrict__ qvals,
            const uint8_t* __restrict__ active, const int* __restrict__ cand,
            int B, int* __restrict__ ok, int* __restrict__ pm) {
  const int lane = threadIdx.x;
  const bool level = mode <= kLevelDelete;
  int count = __ldcg(t.count);
  int ocount = level ? 0 : __ldcg(t.ocount);
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int base = 0; base < B; base += 32) {
    // one coalesced trip for the next 32 ops' fields
    const int i = base + lane;
    const bool have = i < B;
    const int my_act = have ? active[i] : 0;
    int4 my_c = make_int4(0, 0, 0, 0);
    if (have) {
      my_c = level ? reinterpret_cast<const int4*>(cand)[i]
                   : make_int4(cand[i], 0, 0, 0);
    }
    const uint4 my_key = have ? qkeys[i] : zero;
    const uint4 my_val = have && qvals ? qvals[i] : zero;
    int my_ok = 0, my_pm = 0;
    const int n = min(32, B - base);
    for (int k = 0; k < n; ++k) {
      if (!__shfl_sync(kFull, my_act, k)) continue;    // masked off: no-op
      int4 c;
      c.x = __shfl_sync(kFull, my_c.x, k);
      c.y = __shfl_sync(kFull, my_c.y, k);
      c.z = __shfl_sync(kFull, my_c.z, k);
      c.w = __shfl_sync(kFull, my_c.w, k);
      const uint4 key = shfl4(my_key, k);
      const uint4 val = shfl4(my_val, k);
      int w;
      if (level) {
        w = level_op(mode, t, c, key, val, lane);
      } else {
        w = pfarm_op(mode, t, c.x, key, val, lane, ocount) ? 5 : 0;
      }
      if (w) {
        if (mode == kLevelInsert || mode == kPfarmInsert) ++count;
        if (mode == kLevelDelete || mode == kPfarmDelete) --count;
      }
      if (lane == k) {
        my_ok = w != 0;
        my_pm = w;
      }
      __syncwarp();          // this op's stores before the next op's loads
    }
    if (have) {
      ok[i] = my_ok;
      pm[i] = my_pm;
    }
  }
  if (lane == 0) {
    *t.count = count;
    if (!level) *t.ocount = ocount;
  }
}

__global__ void hash_kernel(const uint4* __restrict__ keys, int B,
                            uint32_t* __restrict__ h1,
                            uint32_t* __restrict__ h2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  h1[i] = hash128(keys[i], 0u);
  h2[i] = hash128(keys[i], kSeed2);
}

// The latency floor of the walk: one warp, steps dependent random byte
// loads through L2 (ld.cg, as the walk's token reads), each load's address
// a function of the byte the previous one returned.  Every lane computes
// the same address (one transaction per load); lane 0 writes the final
// state, which the host holds against the plain version.
__global__ void __launch_bounds__(32, 1)
chase_kernel(const uint8_t* __restrict__ data, unsigned long long n,
             int elem, int steps, uint32_t h, uint32_t* __restrict__ out) {
  for (int i = 0; i < steps; ++i) {
    const unsigned long long j = (static_cast<unsigned long long>(h) * n) >> 32;
    const uint32_t b = ld_tok(data, static_cast<size_t>(j) * elem);
    h = fmix32(h ^ b ^ (static_cast<uint32_t>(i) * 0x9E3779B9u));
  }
  if (threadIdx.x == 0) *out = h;
}

}  // namespace

// mode: 0-2 level insert / update / delete, 3-5 pfarm insert / update /
// delete.  keys_a..tok_b: the table's two levels (level) or main buckets
// and pool (pfarm), slots 16-byte aligned; head, onext, ocount: pfarm only
// (null for level); count: the table's live count.  qkeys, qvals: (B, 4)
// words, 16-byte aligned (qvals null for delete); active: (B,) bytes;
// cand: (B, 4) int32 scratch (level) or (B,) (pfarm), 16-byte aligned;
// ok, pm: (B,) int32 out.  Geometry: n_a, n_b buckets of bs slots (pfarm:
// window, max_chain; window * bs <= 32; level: 4 * bs <= 32).  Launches the
// prologue and the one-warp walk on the stream; returns the cudaError_t of
// the launches (0 on success).
extern "C" int scan_walk_launch(int mode, void* keys_a, void* vals_a,
                                void* tok_a, void* keys_b, void* vals_b,
                                void* tok_b, void* head, void* onext,
                                void* ocount, void* count, const void* qkeys,
                                const void* qvals, const void* active,
                                int B, int n_a, int n_b, int bs, int window,
                                int max_chain, void* cand, void* ok, void* pm,
                                void* stream) {
  if (B <= 0) return 0;
  const bool level = mode >= kLevelInsert && mode <= kLevelDelete;
  const bool pfarm = mode >= kPfarmInsert && mode <= kPfarmDelete;
  if ((!level && !pfarm) || bs < 1 || bs > 8 || n_a < 1 ||
      (level && 4 * bs > 32) ||
      (pfarm && (window < 1 || window * bs > 32 || max_chain < 0 ||
                 n_b < 1 || !head || !onext || !ocount)) ||
      ((mode == kLevelDelete || mode == kPfarmDelete) != (qvals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Table t{static_cast<uint4*>(keys_a), static_cast<uint4*>(vals_a),
          static_cast<uint8_t*>(tok_a), static_cast<uint4*>(keys_b),
          static_cast<uint4*>(vals_b), static_cast<uint8_t*>(tok_b),
          static_cast<int*>(head), static_cast<int*>(onext),
          static_cast<int*>(ocount), static_cast<int*>(count),
          n_a, n_b, bs, window, max_chain};
  prologue_kernel<<<(B + 255) / 256, 256, 0, s>>>(
      mode, static_cast<const uint4*>(qkeys), B, n_a, static_cast<int*>(cand));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  walk_kernel<<<1, 32, 0, s>>>(
      mode, t, static_cast<const uint4*>(qkeys),
      static_cast<const uint4*>(qvals), static_cast<const uint8_t*>(active),
      static_cast<const int*>(cand), B, static_cast<int*>(ok),
      static_cast<int*>(pm));
  return static_cast<int>(cudaGetLastError());
}

// hash128 and hash128_2 of (B, 4) key words (16-byte aligned) into two (B,)
// uint32 arrays: the device hashes, held against core/hashfn.py by tests.
extern "C" int scan_walk_hash_launch(const void* keys, int B, void* h1,
                                     void* h2, void* stream) {
  if (B <= 0) return 0;
  hash_kernel<<<(B + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(keys), B, static_cast<uint32_t*>(h1),
      static_cast<uint32_t*>(h2));
  return static_cast<int>(cudaGetLastError());
}

// The walk's latency floor: steps dependent random byte loads from the
// n = nbytes / elem elements of data (element (h * n) >> 32 of a 32-bit
// state h, h = fmix32(h ^ byte ^ i * 0x9E3779B9) after load i), one warp;
// the final state goes to out (one uint32).  Returns the cudaError_t.
extern "C" int scan_walk_chase_launch(const void* data, long long nbytes,
                                      int elem, int steps, unsigned seed,
                                      void* out, void* stream) {
  if (elem < 1 || nbytes < elem || steps < 0 ||
      nbytes / elem > 0xFFFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  chase_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data),
      static_cast<unsigned long long>(nbytes / elem), elem, steps, seed,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
