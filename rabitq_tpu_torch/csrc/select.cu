// Exact rerank-candidate selection for Hopper (sm_90a): per query, the R
// lowest of its rough estimates, decoded into index rows.
//
// Replaces no TPU kernel: the JAX package selects with lax.top_k
// (rabitq_tpu/index/search.py, _exact_two_stage), and the port did so with
// two torch.topk calls (a per-task top-min(R, width), then a global top-R
// over the survivors) and about eight elementwise launches of slot decode.
// At the benchmark's shapes those were 58-64% of a batch's device time,
// about 50x (sift) and 130x (gist) this stage's byte bound. For query b,
// with n = probe * width values in rough[b] (the scan's [B, n] output,
// flat index j = task * width + slot):
//
//   keep the R values of lowest rank by (value, j): NaN after +inf, -0 equal
//   to +0, and among equal values the lower flat index first (lax.top_k's
//   rule; a stable sort's);
//   task = j / width, base = starts[b, task];
//   folded (slot_bits > 0): pos = base + (bits & mask), lb = bits & ~mask
//   with mask = 2^slot_bits - 1 (the scan packs a value's window slot into
//   its low mantissa bits); unfolded: pos = base + j % width, lb = value;
//   pos = min(pos, n_rows - 1).
//
// The kept values are written in ascending flat index, which is task
// order, so neighbouring candidates are neighbouring rows for gather_l2;
// no consumer needs them sorted by bound. The plain PyTorch version is
// rabitq_tpu_torch/ops/select_kernel.py:select_candidates_reference (two
// stable sorts, its output sorted by value): the same (lb, pos) pairs.
//
// What bounds it on this card: bytes, one read of the row (4 n B a query),
// the starts, and R * 12 B of output: 235 MB and 70 us at the sift cell's
// batch (8192 x 28 x 256), 67 MB and 20 us at gist's (1024 x 64 x 256).
// The work is a few integer operations a value a pass.
//
// Design: one block of 512 threads a query.
//   - Load: the row is read once with 16-byte loads (4 a thread in flight),
//     each value mapped to an order-preserving uint32 key (flip every bit
//     of a negative value, the sign bit of a positive one; NaN -> all ones,
//     -0 -> +0). Rows of at most kResidentMax values keep their keys in
//     dynamic shared memory (96 KB; sift's row is 28 KB, gist's 64 KB);
//     longer rows (probe 384 x 256 at blobs, filtered or adaptive shapes)
//     are read again from global memory on each pass ("streamed"). The
//     same pass takes the least key and the greatest key below +inf.
//   - Radix select over the keys' range, not their raw digits: the first
//     histogram spreads [least, greatest finite] over 2047 bins (keys
//     above it, +inf and NaN, share bin 2047), so values that crowd a few
//     binades still spread over the bins and the bin holding the R-th
//     value is small (5 keys on average at the sift cell's shape, 11 at
//     gist's). When it holds at most 32 keys, one pass copies them out and
//     one warp ranks them by shuffles. Otherwise each later pass splits the
//     bin's key range in up to 2048 bins (11 bits) until it holds one key
//     T, the R-th lowest (at most three passes); the first also copies the
//     range's keys into a 2048-key buffer when they fit, so later passes
//     read only those. Histograms are in shared memory; a warp whose
//     active lanes all hit one bin adds once (rows of +inf pads), and a
//     warp with no key in the range skips its quads.
//   - Output: a block-wide prefix sum in flat order over tiles of 4096
//     values (8 a thread) gives each value below T, and each of the first
//     (R - #below) values equal to T, its output slot. Up to 2048 slots
//     are staged in shared memory and decoded together after the last
//     tile, so that no tile's barrier waits on a read of the starts. Keys
//     are inverted back to the value's bits (+0 and NaN, which the key
//     mapping merges, are read again from the row).
//
// Measured (H100, L2 cold): 0.218 ms at the sift cell's shape (33% of the
// byte bound), 0.068 ms at gist's (30%); PERF.md's kernel table.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;  // 4 a thread
constexpr int kBuf = kBins;  // keys of the chosen bin kept after pass 1
constexpr int kUnroll = 4;   // 16-byte loads a thread in flight
constexpr int kResidentMax = 24576;  // values of a row kept in shared memory
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
// total in *total. Two barriers; every thread must call it.
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
// histogram for the next pass. Every thread must call it.
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

template <bool kResident>
__global__ void __launch_bounds__(kThreads)
select_kernel(const float* __restrict__ rough,
              const int32_t* __restrict__ starts, int64_t* __restrict__ pos,
              float* __restrict__ lb, int n, int width, int probe, int r,
              int slot_bits, long long n_rows, bool vec) {
  extern __shared__ uint4 row4[];  // the row's keys (kResident)
  __shared__ __align__(16) uint32_t hist[kBins];
  __shared__ uint32_t buf[kBuf];
  __shared__ Shared sh;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int b = blockIdx.x;
  const float* src = rough + static_cast<size_t>(b) * n;
  const int nq = (n + 3) / 4;

  auto quad = [&](int q) -> uint4 {
    if (kResident) return row4[q];
    return to_keys(load_quad(src, q, n, vec));
  };

  // Load (keep the keys when resident); the least key, the greatest
  // below +inf.
  uint32_t mn = kNaNKey, mx = 0u;
  for (int q0 = 0; q0 < nq; q0 += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      v[u] = load_quad(src, q0 + u * kThreads + t, n, vec);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads + t;
      if (q >= nq) break;
      const uint4 k = to_keys(v[u]);
      if (kResident) row4[q] = k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(k, i);
        mn = min(mn, key);  // past n the key is kNaNKey: no effect
        if (key < kInfKey) mx = max(mx, key);
      }
    }
  }
  mn = __reduce_min_sync(0xffffffffu, mn);
  mx = __reduce_max_sync(0xffffffffu, mx);
  if (lane == 0) {
    sh.mn[w] = mn;
    sh.mx[w] = mx;
  }
  reinterpret_cast<uint4*>(hist)[t] = make_uint4(0u, 0u, 0u, 0u);
  if (t == 0) sh.kept = 0u;
  __syncthreads();
  uint32_t lo = kNaNKey, hi = 0u;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    lo = min(lo, sh.mn[i]);
    hi = max(hi, sh.mx[i]);
  }
  hi = max(hi, lo);  // no finite value: the range is the least key alone

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

  // Output: every key below T = lo, then the first `need` keys equal to
  // it, in flat order; each tile's slots from a block-wide prefix sum of
  // (below, equal) counts packed in 16-bit halves. Up to kBins slots are
  // staged as (flat index, key) in the histogram and the buffer, free
  // now, and decoded after the last tile, so that no tile waits on a
  // read of the starts.
  const uint32_t key_t = lo, need = rank + 1u;
  const bool staged = r <= kBins;
  uint32_t* stage_j = hist;
  uint32_t* stage_key = buf;
  uint32_t done_lt = 0u, done_eq = 0u;
  auto emit = [&](uint32_t slot, uint32_t j, uint32_t key) {
    const uint32_t bits = key == kZeroKey || key == kNaNKey
                              ? __float_as_uint(__ldg(src + j))
                              : from_key(key);
    const uint32_t task = j / width;
    long long p = starts[static_cast<size_t>(b) * probe + task];
    uint32_t lbits = bits;
    if (slot_bits) {
      const uint32_t mask = (1u << slot_bits) - 1u;
      p += bits & mask;
      lbits = bits & ~mask;
    } else {
      p += j - task * width;
    }
    const size_t at = static_cast<size_t>(b) * r + slot;
    pos[at] = p < n_rows - 1 ? p : n_rows - 1;
    lb[at] = __uint_as_float(lbits);
  };
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
      if (staged) {
        stage_j[slot] = j;
        stage_key[slot] = key;
      } else {
        emit(slot, j, key);
      }
    }
  }
  if (staged) {
    __syncthreads();
    for (int i = t; i < r; i += kThreads) emit(i, stage_j[i], stage_key[i]);
  }
}

}  // namespace

// Longest row (values) whose keys stay in shared memory; longer rows take
// the streamed instance. The wrapper counts launches by it.
extern "C" int rabitq_select_resident_max() { return kResidentMax; }

// Launches the selection on `stream` and returns a CUDA error code (0 =
// ok). rough [b, n] f32 (n = probe * width), starts [b, probe] int32, pos
// [b, r] int64 and lb [b, r] f32 out; 1 <= r <= n; slot_bits 0 (unfolded)
// or the fold's slot bits. Preconditions, checked by the Python wrapper:
// the tensors are contiguous, n % width == 0.
extern "C" int rabitq_select_candidates(const void* rough, const void* starts,
                                        void* pos, void* lb, int b, int n,
                                        int width, int r, int slot_bits,
                                        long long n_rows, void* stream) {
  if (b <= 0) return 0;
  if (r < 1 || r > n || width < 1 || n % width)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(rough) % 16 == 0;
  const auto* x = static_cast<const float*>(rough);
  const auto* s = static_cast<const int32_t*>(starts);
  auto* p = static_cast<int64_t*>(pos);
  auto* l = static_cast<float*>(lb);
  if (n > kResidentMax) {
    select_kernel<false><<<b, kThreads, 0, st>>>(
        x, s, p, l, n, width, n / width, r, slot_bits, n_rows, vec);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  {
    static std::mutex mu;
    static std::map<int, bool> smem_set;
    std::lock_guard<std::mutex> lock(mu);
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(select_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kResidentMax * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[device] = true;
    }
  }
  const int smem = ((n + 3) / 4) * 16;
  select_kernel<true><<<b, kThreads, smem, st>>>(
      x, s, p, l, n, width, n / width, r, slot_bits, n_rows, vec);
  return static_cast<int>(cudaGetLastError());
}
