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
//   - Radix select over the keys' range, not their raw digits
//     (radix_select.cuh, shared with probe_rank.cu): the first histogram
//     spreads [least, greatest finite] over 2047 bins, so the bin holding
//     the R-th value is small (5 keys on average at the sift cell's shape,
//     11 at gist's) and at most three more passes find T, the R-th lowest.
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

#include "radix_select.cuh"

namespace {

using namespace radix;

constexpr int kUnroll = 4;   // 16-byte loads a thread in flight
constexpr int kResidentMax = 24576;  // values of a row kept in shared memory

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
  const int t = threadIdx.x;
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
  uint32_t lo, hi, need;
  block_range(mn, mx, hist, sh, &lo, &hi);
  const uint32_t key_t = threshold(quad, nq, n, r, lo, hi, hist, buf, sh,
                                   &need);

  // Output: every key below T, then the first `need` keys equal to it, in
  // flat order. Up to kBins slots are staged as (flat index, key) in the
  // histogram and the buffer, free now, and decoded after the last tile,
  // so that no tile waits on a read of the starts.
  const bool staged = r <= kBins;
  uint32_t* stage_j = hist;
  uint32_t* stage_key = buf;
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
  for_each_kept(quad, nq, n, key_t, need, sh,
                [&](uint32_t slot, uint32_t j, uint32_t key) {
                  if (staged) {
                    stage_j[slot] = j;
                    stage_key[slot] = key;
                  } else {
                    emit(slot, j, key);
                  }
                });
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
