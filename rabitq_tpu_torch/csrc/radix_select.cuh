// The exact range-binned radix select of one row a block, shared by
// select.cu (the rerank candidates) and probe_rank.cu (the probed
// clusters). A row is n values read as quads of 4 through an accessor that
// gives their order-preserving uint32 keys (to_key); the select finds, for
// a rank r, the key T of the value of rank r by (key, flat index) and how
// many of the values equal to T that rank keeps, and then visits the kept
// values in flat order with their output slots.
//
//   - Keys: flip every bit of a negative value, the sign bit of a positive
//     one; NaN -> all ones (after +inf), -0 -> +0.
//   - The range: the first histogram spreads [least, greatest finite] over
//     2047 bins (keys above it, +inf and NaN, share bin 2047), so values
//     that crowd a few binades still spread over the bins. When the chosen
//     bin holds at most 32 keys, one pass copies them out and one warp
//     ranks them by shuffles. Otherwise each later pass splits the bin's
//     key range in up to 2048 bins (11 bits) until it holds one key T (at
//     most three passes); the first also copies the range's keys into a
//     2048-key buffer when they fit, so later passes read only those.
//     Histograms are in shared memory; a warp whose active lanes all hit
//     one bin adds once (rows of +inf pads), and a warp with no key in the
//     range skips its quads.
//   - The kept values: a block-wide prefix sum in flat order over tiles of
//     4096 values (8 a thread) gives each value below T, and each of the
//     first (r - #below) values equal to T, its output slot.
//
// The block-wide functions (block_scan, find_bin, block_range, threshold,
// for_each_kept) are called by every thread of a block of kThreads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;  // 4 a thread
constexpr int kBuf = kBins;  // keys of the chosen bin kept after pass 1
constexpr uint32_t kInfKey = 0xff800000u;  // the key of +inf
constexpr uint32_t kNaNKey = 0xffffffffu;
constexpr uint32_t kZeroKey = 0x80000000u;  // the key of +0 and -0
static_assert(kBins == 4 * kThreads, "find_bin takes 4 bins a thread");

struct Shared {
  uint32_t warp[kWarps];  // block_scan's warp totals
  uint32_t mn[kWarps], mx[kWarps];
  uint32_t bin, below, count;  // find_bin's result
  uint32_t kept;               // keys copied to the buffer
  uint32_t key;                // the threshold key, when one warp ranks it
};

__device__ __forceinline__ uint32_t to_key(uint32_t bits) {
  if ((bits & 0x7fffffffu) > 0x7f800000u) return kNaNKey;
  if (bits == 0x80000000u) bits = 0u;
  return bits ^ (static_cast<uint32_t>(static_cast<int32_t>(bits) >> 31) |
                 0x80000000u);
}

__device__ __forceinline__ uint32_t from_key(uint32_t key) {
  return (key & 0x80000000u) ? key ^ 0x80000000u : ~key;
}

__device__ __forceinline__ uint4 to_keys(uint4 v) {
  return make_uint4(to_key(v.x), to_key(v.y), to_key(v.z), to_key(v.w));
}

__device__ __forceinline__ uint32_t elem(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Values 4q .. 4q + 3 of the row as bits; past n (or past the row's
// quads) NaN, whose key sorts last. vec: the row is 16-byte aligned.
__device__ __forceinline__ uint4 load_quad(const float* src, int q, int n,
                                           bool vec) {
  if (4 * q >= n) return make_uint4(kNaNKey, kNaNKey, kNaNKey, kNaNKey);
  if (vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
    return make_uint4(__float_as_uint(f.x), __float_as_uint(f.y),
                      __float_as_uint(f.z), __float_as_uint(f.w));
  }
  uint32_t e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    e[i] = 4 * q + i < n ? __float_as_uint(__ldg(src + 4 * q + i)) : kNaNKey;
  return make_uint4(e[0], e[1], e[2], e[3]);
}

// Exclusive prefix sum of v over the block in thread order; the block's
// total in *total. Two barriers.
__device__ __forceinline__ uint32_t block_scan(uint32_t v, Shared& sh,
                                               uint32_t* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sh.warp[w] = x;
  __syncthreads();
  uint32_t s = lane < kWarps ? sh.warp[lane] : 0u;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += y;
  }
  const uint32_t before = __shfl_sync(0xffffffffu, s, (w + 31) & 31);
  *total = __shfl_sync(0xffffffffu, s, kWarps - 1);
  __syncthreads();
  return (w ? before : 0u) + x - v;
}

// The bin that holds the key of rank `rank` (0-based) in the histogram:
// sh.bin, sh.below (keys in lower bins), sh.count (keys in it). Zeroes the
// histogram for the next pass.
__device__ __forceinline__ void find_bin(uint32_t* hist, uint32_t rank,
                                         Shared& sh) {
  uint4* h4 = reinterpret_cast<uint4*>(hist);
  const uint4 c = h4[threadIdx.x];
  h4[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  const uint32_t sum = c.x + c.y + c.z + c.w;
  uint32_t total;
  uint32_t cum = block_scan(sum, sh, &total);
  if (cum <= rank && rank < cum + sum) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t ci = elem(c, i);
      if (rank < cum + ci) {
        sh.bin = 4 * threadIdx.x + i;
        sh.below = cum;
        sh.count = ci;
        break;
      }
      cum += ci;
    }
  }
  __syncthreads();
}

// Adds one to hist[bin] for each lane with `in`; once for the warp when all
// such lanes share a bin. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(uint32_t* hist, uint32_t bin,
                                         bool in) {
  const unsigned lanes = __ballot_sync(0xffffffffu, in);
  if (!lanes) return;
  const int lead = __ffs(lanes) - 1;
  const uint32_t lead_bin = __shfl_sync(0xffffffffu, bin, lead);
  if (__ballot_sync(0xffffffffu, in && bin == lead_bin) == lanes) {
    if ((threadIdx.x & 31) == lead) atomicAdd(hist + lead_bin, __popc(lanes));
  } else if (in) {
    atomicAdd(hist + bin, 1u);
  }
}

// Appends the key of each lane with `in` to buf at *count (the lanes of a
// warp in lane order). Every lane of the warp must call it.
__device__ __forceinline__ void append(uint32_t* buf, uint32_t* count,
                                       uint32_t key, bool in) {
  const unsigned lanes = __ballot_sync(0xffffffffu, in);
  if (!lanes) return;
  const int lane = threadIdx.x & 31, lead = __ffs(lanes) - 1;
  uint32_t at = 0u;
  if (lane == lead) at = atomicAdd(count, __popc(lanes));
  at = __shfl_sync(0xffffffffu, at, lead);
  if (in) buf[at + __popc(lanes & ((1u << lane) - 1u))] = key;
}

// The shift that spreads keys lo .. lo + span over at most 2048 bins.
__device__ __forceinline__ int bin_shift(uint32_t span) {
  const int bits = 32 - __clz(span);
  return bits > 11 ? bits - 11 : 0;
}

// The last key of the bin that starts at lo, 2^s keys wide, within hi.
__device__ __forceinline__ uint32_t bin_top(uint32_t lo, uint32_t hi, int s) {
  const unsigned long long top = lo + ((1ull << s) - 1ull);
  return top < hi ? static_cast<uint32_t>(top) : hi;
}

// The row's key range from each thread's least key `mn` and greatest key
// below +inf `mx`: *lo the least key of the row, *hi the greatest below
// +inf (*lo where the row has none). Also zeroes the histogram and the
// buffer's count for the select. One barrier.
__device__ __forceinline__ void block_range(uint32_t mn, uint32_t mx,
                                            uint32_t* hist, Shared& sh,
                                            uint32_t* lo, uint32_t* hi) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    sh.mn[w] = mn;
    sh.mx[w] = mx;
  }
  reinterpret_cast<uint4*>(hist)[t] = make_uint4(0u, 0u, 0u, 0u);
  if (t == 0) sh.kept = 0u;
  __syncthreads();
  uint32_t l = kNaNKey, h = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    l = min(l, sh.mn[i]);
    h = max(h, sh.mx[i]);
  }
  *lo = l;
  *hi = max(h, l);  // no finite value: the range is the least key alone
}

// The key T of rank r - 1 (0-based) of the row's n keys (quad(q) gives the
// keys of quad q; nq quads), given block_range's lo and hi: returns T and
// *need, how many of the keys equal to T rank below r. hist and buf (kBins
// and kBuf keys) are free again when it returns.
template <class Quad>
__device__ __forceinline__ uint32_t threshold(Quad&& quad, int nq, int n,
                                              int r, uint32_t lo, uint32_t hi,
                                              uint32_t* hist, uint32_t* buf,
                                              Shared& sh, uint32_t* need) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  // Pass 1: [lo, hi] over bins 0 .. 2046, keys above hi in bin 2047.
  uint32_t rank = static_cast<uint32_t>(r - 1);
  {
    int s = 0;
    while (((hi - lo) >> s) >= kBins - 1) ++s;
    uint32_t over = 0u;
    for (int q = t; q < nq; q += kThreads) {
      const uint4 k = quad(q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(k, i);
        if (4 * q + i >= n) break;
        if (key > hi) {
          ++over;
        } else {
          atomicAdd(hist + ((key - lo) >> s), 1u);
        }
      }
    }
    over = __reduce_add_sync(0xffffffffu, over);
    if (lane == 0 && over) atomicAdd(hist + kBins - 1, over);
    __syncthreads();
    find_bin(hist, rank, sh);
    const uint32_t d = sh.bin;
    rank -= sh.below;
    if (d == kBins - 1) {
      lo = hi + 1u;
      hi = kNaNKey;
    } else {
      lo += d << s;
      hi = bin_top(lo, hi, s);
    }
  }
  // Later passes: split [lo, hi] until it holds one key. Where the range
  // holds at most 32 keys, one pass copies them out and one warp ranks
  // them. Otherwise each pass histograms the range; the first reads the
  // row and keeps the range's keys when they fit the buffer, the others
  // read the buffer.
  auto row_pass = [&](auto&& visit) {
    for (int q0 = 0; q0 < nq; q0 += kThreads) {
      const int q = q0 + t;
      const uint4 k = q < nq ? quad(q) : make_uint4(kNaNKey, kNaNKey,
                                                    kNaNKey, kNaNKey);
      bool any = false;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(k, i);
        any |= 4 * q + i < n && key >= lo && key <= hi;
      }
      if (!__any_sync(0xffffffffu, any)) continue;  // most warps
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(k, i);
        visit(key, 4 * q + i < n && key >= lo && key <= hi);
      }
    }
  };
  if (lo != hi && sh.count <= 32) {
    row_pass([&](uint32_t key, bool in) { append(buf, &sh.kept, key, in); });
    __syncthreads();
    if (w == 0) {
      const uint32_t m = sh.kept;
      const uint32_t key = lane < m ? buf[lane] : kNaNKey;
      uint32_t less = 0u, upto = 0u;
      for (uint32_t i = 0; i < m; ++i) {
        const uint32_t other = __shfl_sync(0xffffffffu, key, i);
        less += other < key;
        upto += other <= key;
      }
      if (lane < m && less <= rank && rank < upto) {
        sh.key = key;  // lanes that hold T write the same
        sh.below = less;
      }
    }
    __syncthreads();
    lo = hi = sh.key;
    rank -= sh.below;
  }
  bool keep = sh.count <= kBuf, kept = false;
  while (lo != hi) {
    const int s = bin_shift(hi - lo);
    if (!kept) {
      row_pass([&](uint32_t key, bool in) {
        hist_add(hist, (key - lo) >> s, in);
        if (keep) append(buf, &sh.kept, key, in);
      });
    } else {
      const uint32_t m = sh.kept;
      for (uint32_t i0 = 0; i0 < m; i0 += kThreads) {
        const uint32_t i = i0 + t;
        const uint32_t key = i < m ? buf[i] : kNaNKey;
        hist_add(hist, (key - lo) >> s, i < m && key >= lo && key <= hi);
      }
    }
    __syncthreads();
    find_bin(hist, rank, sh);
    kept = kept || keep;
    keep = false;
    rank -= sh.below;
    lo += sh.bin << s;
    hi = bin_top(lo, hi, s);
  }
  *need = rank + 1u;
  return lo;
}

// Calls emit(slot, j, key) for every value of the row below key_t and for
// the first `need` values equal to it, in flat order (j ascending), with
// its output slot in [0, #below + need): each tile's slots from a
// block-wide prefix sum of (below, equal) counts packed in 16-bit halves.
template <class Quad, class Emit>
__device__ __forceinline__ void for_each_kept(Quad&& quad, int nq, int n,
                                              uint32_t key_t, uint32_t need,
                                              Shared& sh, Emit&& emit) {
  const int t = threadIdx.x;
  uint32_t done_lt = 0u, done_eq = 0u;
  for (int q0 = 0; q0 < nq; q0 += 2 * kThreads) {
    const int q = q0 + 2 * t;  // this thread's 8 values: quads q, q + 1
    uint4 k[2];
    uint32_t n_lt = 0u, n_eq = 0u;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      k[u] = q + u < nq ? quad(q + u) : make_uint4(kNaNKey, kNaNKey,
                                                   kNaNKey, kNaNKey);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(k[u], i);
        const bool ok = 4 * (q + u) + i < n;
        n_lt += ok && key < key_t;
        n_eq += ok && key == key_t;
      }
    }
    uint32_t total;
    const uint32_t pre = block_scan(n_lt | (n_eq << 16), sh, &total);
    uint32_t lt = done_lt + (pre & 0xffffu), eq = done_eq + (pre >> 16);
    done_lt += total & 0xffffu;
    done_eq += total >> 16;
    if (!(n_lt | n_eq)) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 4 * q + e;
      const uint32_t key = elem(k[e / 4], e % 4);
      if (j >= n || key > key_t) continue;
      uint32_t slot;
      if (key < key_t) {
        slot = lt + min(eq, need);
        ++lt;
      } else {
        if (eq >= need) continue;
        slot = lt + eq;
        ++eq;
      }
      emit(slot, static_cast<uint32_t>(j), key);
    }
  }
}

}  // namespace radix
