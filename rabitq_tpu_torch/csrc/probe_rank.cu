// Top-probe cluster ranking for Hopper (sm_90a): per query, the ids of the
// `probe` clusters of lowest ranking key, best first.
//
// Replaces no TPU kernel: the JAX package ranks with lax.top_k over the
// [B, K] centroid distances (rabitq_tpu/index/search.py), and the port did
// so with pairwise_l2sq's epilogue (four elementwise passes that write the
// [B, K] key) and a stable torch.sort of all K columns, sliced to probe: at
// the sift cell (16384 x 4096, probe 28) 66% of a batch's device time, to
// keep 28 of 4,096. For query b (x the [B, K] f32 input):
//
//   fused (xx and cc given; x the GEMM's cross term xc): key[j] =
//   max((xx[b] - 2 x[b, j]) + cc[j], 0) in f32, each operation rounded on
//   its own in that order, as ops/distances.py:l2sq_epilogue computes it.
//   nvcc contracts a * b + c into one fma under its default -fmad=true, so
//   the three steps are __fmul_rn, __fsub_rn and __fadd_rn, which it never
//   contracts, whatever the flags. A NaN stays NaN, as through torch.clamp,
//   and every key <= 0 is the clamp's +0;
//   finished (no xx): key[j] = x[b, j] (the annulus bound, or a built
//   distance matrix);
//   out[b, :] = the probe lowest j by (key, j), ascending: NaN after +inf,
//   -0 equal to +0, and among equal keys the lower id first. That is
//   torch.sort(key, dim=-1, stable=True).indices[:, :probe], bit for bit
//   (split clusters' duplicated centroids tie exactly).
//
// The plain PyTorch version is rabitq_tpu_torch/ops/probe_rank.py:
// probe_rank_reference (the epilogue, then the stable sort).
//
// What bounds it on this card: bytes, one read of the row (4 K B a query),
// xx, cc once, and probe ids written (8 B each): 270 MB and 81 us at the
// sift cell's batch, 135 MB and 41 us at gist's (8192 x 4096, probe 64).
// The work is a few operations a value a pass.
//
// Design: one block of 512 threads a query.
//   - Load: the row (and cc, from L2) is read once with 16-byte loads where
//     K % 4 == 0 (2 quads a thread in flight: 4 took 14 more registers and
//     ran 24% slower at the sift cell's shape), each key formed in registers
//     and mapped to radix_select.cuh's order-preserving uint32 key; the
//     [B, K] key is never written. Rows of at most kResidentMax keys stay
//     in dynamic shared memory (16 KB at K 4,096, 21 KB at 5,327); longer
//     rows are read and formed again from global memory on each pass
//     ("streamed").
//   - radix_select.cuh's range-binned radix select, as csrc/select.cu's,
//     finds the key T of rank probe and how many keys equal to T rank
//     below it (the lowest ids).
//   - Winners: each kept key goes to its slot as (key << 32 | id), in id
//     order, into the select's histogram and buffer, free by then (up to
//     2048 winners), or else into the output row itself.
//   - Order: up to 512 winners, each warp sorts a run of 32 in registers
//     (a bitonic network of shuffles), and each winner's rank is its place
//     in its run plus, for every other run, the count of that run's
//     winners below it (a binary search in shared memory: 5 reads, where
//     counting against every winner took 384 at the blobs cell's probe);
//     more, a bitonic sort of the composites in place whose every
//     comparator puts the lower at the lower index, so it sorts any length
//     (the missing elements of a power of two are +inf at the end and never
//     move). The ids are written last.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

#include "radix_select.cuh"

namespace {

using namespace radix;

constexpr int kUnroll = 2;  // quads a thread in flight (K 4,096: all)
constexpr int kResidentMax = 16384;  // keys of a row kept in shared memory
constexpr int kWinShared = (kBins + kBuf) / 2;  // winners in hist + buf
constexpr int kRunMax = kThreads;  // winners ranked in warp runs

// The ranking key of max((qn - 2 xc) + c, 0), as radix_select's to_key
// maps it: NaN last, every value <= 0 the key of +0.
__device__ __forceinline__ uint32_t dist_key(float qn, uint32_t xc_bits,
                                             uint32_t c_bits) {
  const float v = __fadd_rn(
      __fsub_rn(qn, __fmul_rn(2.0f, __uint_as_float(xc_bits))),
      __uint_as_float(c_bits));
  if (isnan(v)) return kNaNKey;
  return v > 0.0f ? (__float_as_uint(v) | 0x80000000u) : kZeroKey;
}

template <bool kFused>
__device__ __forceinline__ uint4 make_keys(float qn, uint4 v, uint4 c) {
  if (!kFused) return to_keys(v);
  return make_uint4(dist_key(qn, v.x, c.x), dist_key(qn, v.y, c.y),
                    dist_key(qn, v.z, c.z), dist_key(qn, v.w, c.w));
}

constexpr unsigned long long kLast = ~0ull;  // above every winner

// The 64-bit values of a warp's lanes, sorted ascending in lane order (a
// bitonic network of shuffles).
__device__ __forceinline__ unsigned long long warp_sort(unsigned long long v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool take_min = ((lane & size) == 0) == ((lane & stride) == 0);
      v = take_min == (o < v) ? o : v;
    }
  }
  return v;
}

// How many of the 32 ascending values of run[] lie below v.
__device__ __forceinline__ int count_below(const unsigned long long* run,
                                           unsigned long long v) {
  int n = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (run[n + step - 1] < v) n += step;
  return n + (run[n] < v);
}

// a[lo] <= a[hi] after it; a position past n is +inf and stays put.
__device__ __forceinline__ void order_pair(unsigned long long* a, int lo,
                                           int hi, int n) {
  if (hi >= n) return;
  const unsigned long long x = a[lo], y = a[hi];
  if (y < x) {
    a[lo] = y;
    a[hi] = x;
  }
}

// Sorts a[0 .. n) ascending (shared or global memory); every thread of
// the block calls it.
__device__ void bitonic_sort(unsigned long long* a, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int size = 2; size <= n2; size <<= 1) {
    const int half = size >> 1;
    for (int p = threadIdx.x; p < n2 / 2; p += kThreads) {
      const int start = (p / half) * size, off = p % half;
      order_pair(a, start + off, start + size - 1 - off, n);
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n2 / 2; p += kThreads) {
        const int lo = (p / stride) * 2 * stride + p % stride;
        order_pair(a, lo, lo + stride, n);
      }
      __syncthreads();
    }
  }
}

template <bool kFused, bool kResident>
__global__ void __launch_bounds__(kThreads)
probe_rank_kernel(const float* __restrict__ x, const float* __restrict__ xx,
                  const float* __restrict__ cc, int64_t* out, int k,
                  int probe, bool vec) {
  extern __shared__ uint4 row4[];  // the row's keys (kResident)
  __shared__ __align__(16) uint32_t scratch[kBins + kBuf];
  __shared__ Shared sh;
  uint32_t* hist = scratch;
  uint32_t* buf = scratch + kBins;
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const float* src = x + static_cast<size_t>(b) * k;
  const float qn = kFused ? xx[b] : 0.0f;
  const int nq = (k + 3) / 4;
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);

  auto quad = [&](int q) -> uint4 {
    if (kResident) return row4[q];
    return make_keys<kFused>(qn, load_quad(src, q, k, vec),
                             kFused ? load_quad(cc, q, k, vec) : none);
  };

  // Load (keep the keys when resident); the least key, the greatest
  // below +inf. Past K a value reads as NaN, whose key sorts last.
  uint32_t mn = kNaNKey, mx = 0u;
  for (int q0 = 0; q0 < nq; q0 += kThreads * kUnroll) {
    uint4 v[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = load_quad(src, q0 + u * kThreads + t, k, vec);
      c[u] = kFused ? load_quad(cc, q0 + u * kThreads + t, k, vec) : none;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kThreads + t;
      if (q >= nq) break;
      const uint4 key4 = make_keys<kFused>(qn, v[u], c[u]);
      if (kResident) row4[q] = key4;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t key = elem(key4, i);
        mn = min(mn, key);
        if (key < kInfKey) mx = max(mx, key);
      }
    }
  }
  uint32_t lo, hi, need;
  block_range(mn, mx, hist, sh, &lo, &hi);
  const uint32_t key_t = threshold(quad, nq, k, probe, lo, hi, hist, buf, sh,
                                   &need);

  int64_t* row_out = out + static_cast<size_t>(b) * probe;
  unsigned long long* win =
      probe <= kWinShared ? reinterpret_cast<unsigned long long*>(scratch)
                          : reinterpret_cast<unsigned long long*>(row_out);
  for_each_kept(quad, nq, k, key_t, need, sh,
                [&](uint32_t slot, uint32_t j, uint32_t key) {
                  win[slot] = (static_cast<unsigned long long>(key) << 32) | j;
                });
  __syncthreads();
  if (probe <= kRunMax) {
    const int runs = (probe + 31) / 32, w = t >> 5, lane = t & 31;
    unsigned long long mine = kLast;
    if (w < runs) mine = warp_sort(t < probe ? win[t] : kLast);
    if (runs > 1) {
      __syncthreads();
      if (w < runs) win[t] = mine;
      __syncthreads();
    }
    if (w < runs && mine != kLast) {
      int rank = lane;
      for (int r = 0; r < runs; ++r)
        if (r != w) rank += count_below(win + 32 * r, mine);
      row_out[rank] = static_cast<uint32_t>(mine);
    }
    return;
  }
  bitonic_sort(win, probe);
  for (int i = t; i < probe; i += kThreads)
    row_out[i] = static_cast<uint32_t>(win[i]);
}

template <bool kFused, bool kResident>
int launch(const float* x, const float* xx, const float* cc, int64_t* out,
           int b, int k, int probe, bool vec, cudaStream_t st) {
  int smem = 0;
  if (kResident) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    static std::mutex mu;
    static std::map<int, bool> smem_set;
    std::lock_guard<std::mutex> lock(mu);
    if (!smem_set[device]) {
      err = cudaFuncSetAttribute(probe_rank_kernel<kFused, true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kResidentMax * 4);
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set[device] = true;
    }
    smem = ((k + 3) / 4) * 16;
  }
  probe_rank_kernel<kFused, kResident><<<b, kThreads, smem, st>>>(
      x, xx, cc, out, k, probe, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Longest row (keys) kept in shared memory; longer rows take the streamed
// instance. The wrapper counts launches by it.
extern "C" int rabitq_probe_rank_resident_max() { return kResidentMax; }

// Launches the ranking on `stream` and returns a CUDA error code (0 = ok).
// x [b, k] f32: the cross term xc with xx [b] and cc [k] f32 (fused), or
// the finished key with xx and cc null; out [b, probe] int64, 1 <= probe
// <= k. Preconditions, checked by the Python wrapper: the tensors are
// contiguous and on the current device.
extern "C" int rabitq_probe_rank(const void* x, const void* xx,
                                 const void* cc, void* out, int b, int k,
                                 int probe, void* stream) {
  if (b <= 0) return 0;
  const bool fused = xx != nullptr;
  if (probe < 1 || probe > k || fused != (cc != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* st = static_cast<cudaStream_t>(stream);
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cc) % 16 == 0;
  const auto* xs = static_cast<const float*>(x);
  const auto* xxs = static_cast<const float*>(xx);
  const auto* ccs = static_cast<const float*>(cc);
  auto* o = static_cast<int64_t*>(out);
  const bool resident = k <= kResidentMax;
  if (fused) {
    return resident ? launch<true, true>(xs, xxs, ccs, o, b, k, probe, vec, st)
                    : launch<true, false>(xs, xxs, ccs, o, b, k, probe, vec,
                                          st);
  }
  return resident ? launch<false, true>(xs, xxs, ccs, o, b, k, probe, vec, st)
                  : launch<false, false>(xs, xxs, ccs, o, b, k, probe, vec,
                                         st);
}
