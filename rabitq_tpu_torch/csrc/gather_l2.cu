// Exact-rerank gather + squared L2 for Hopper (sm_90a).
//
// Replaces the TPU kernel rabitq_tpu/ops/rerank_kernel.py:pallas_gather_l2
// (Pallas body _kernel), which DMAs each candidate row from a lane-tiled
// copy of the base. This kernel reads the dense [N, D] f32 base directly:
//
//   out[b, i] = sum_d (base[pos[b, i], d] - q[b, d])^2
//
// for pos [B, R] int64 rows of base and q [B, D] f32; a position outside
// [0, N) is not read and gives NaN. The plain PyTorch twin is
// rabitq_tpu_torch/ops/rerank_kernel.py:gather_l2_reference; the sums run
// in another order, so the two agree to f32 rounding, not bit for bit.
//
// What bounds it on this card: bytes, each distinct valid row of base once
// (4 D bytes; a row that several positions name is needed once), B * R *
// 12 of positions and output, and 4 B D of queries; 3 fp32 operations a
// valid element are far below the byte time. A row is only 512 B at D 128,
// so the bound is met only with many independent row reads in flight:
// ~25-40 KB an SM at HBM latency. The design this replaces (one row at a
// time a warp, each row's read waiting on its position's load: 512 B a warp
// in flight) reached about 60% of the bound at D 128. The kernel reads a
// row again for every position that names it; only L2 catches the repeats.
//
// Design. A warp takes one item: 32 consecutive positions of one query.
//   - Positions: lane l loads position l of the item (one coalesced 256 B
//     read); rows are handed out with __shfl_sync, so no row read waits on
//     a dependent position load.
//   - Two instances, chosen from D at launch. D <= 128: 8 lanes a row, 4
//     float4s a lane, 4 rows a group a step: every load instruction covers
//     4 rows of 128 contiguous bytes, 16 float4 a lane and 8 KB a warp in
//     flight. D > 128: 32 lanes a row in chunks of 1024 floats, 8 float4s a
//     lane, one 4 KB row a warp a step (98 registers). Lane s of a group
//     takes vectors s, s + kLanes, ... of its chunk; vectors past the row
//     are masked. Cache hints (L1::no_allocate, an L2 256-byte prefetch)
//     measured no better than the plain read-only load.
//   - Query: each lane keeps its kVpl float4s of the query in registers
//     (reloaded per chunk only when D spans several chunks): no shared
//     memory, no block barrier.
//   - Reduce: __shfl_xor_sync within each lane group, then lane j of the
//     warp collects position j's sum, so the 32 outputs of an item are one
//     coalesced 128 B store; NaN where the position is outside [0, N).
//   - Grid: one warp per item, 8 items a block, consecutive items of a
//     query in one block (its query rows shared in L1). At the sift shape
//     (B 2048, R 32) that is 256 blocks: one wave at two blocks an SM
//     (__launch_bounds__(256, 2)).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItem = 32;  // positions a warp takes: one a lane

// 16 bytes of a row through the read-only path. Volatile, so that a load
// the caller guards is never speculated past its guard.
__device__ __forceinline__ float4 ld_row(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

template <int kLanes, int kVpl, int kUnroll>
__global__ void __launch_bounds__(kThreads, 2)
gather_l2_kernel(const float4* __restrict__ base,
                 const int64_t* __restrict__ pos,
                 const float4* __restrict__ q, float* __restrict__ out,
                 int64_t n, int b, int r, int vecs) {
  constexpr int kGroups = 32 / kLanes;       // rows a load instruction covers
  constexpr int kStep = kGroups * kUnroll;   // rows a step
  constexpr int kChunk = kLanes * kVpl;      // vectors of a row a chunk
  static_assert(kItem % kStep == 0, "a step must divide an item");
  const int lane = threadIdx.x & 31;
  const int grp = lane / kLanes;
  const int sub = lane % kLanes;
  const int tiles = (r + kItem - 1) / kItem;
  const long long item =
      (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (item >= (long long)b * tiles) return;  // warp-uniform
  const int qb = static_cast<int>(item / tiles);
  const int i0 = static_cast<int>(item - (long long)qb * tiles) * kItem;
  const int rows = min(kItem, r - i0);
  const int64_t my_pos =
      lane < rows ? pos[(size_t)qb * r + i0 + lane] : int64_t(-1);
  const float4* q_b = q + (size_t)qb * vecs;
  const int chunks = (vecs + kChunk - 1) / kChunk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[kVpl];
  auto load_q = [&](int c) {
#pragma unroll
    for (int v = 0; v < kVpl; ++v) {
      const int k = c * kChunk + sub + kLanes * v;
      qr[v] = k < vecs ? __ldg(q_b + k) : zero;
    }
  };
  if (chunks == 1) load_q(0);

  float res = 0.f;
  for (int s = 0; s * kStep < rows; ++s) {
    const float4* row[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = __shfl_sync(0xffffffffu, my_pos,
                                    s * kStep + u * kGroups + grp);
      ok[u] = p >= 0 && p < n;
      row[u] = base + (ok[u] ? p : 0) * vecs + sub;
    }
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc[u] = 0.f;
    for (int c = 0; c < chunks; ++c) {
      if (chunks > 1) load_q(c);
      float4 x[kUnroll][kVpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
          const int k = c * kChunk + kLanes * v;
          x[u][v] = ok[u] && k + sub < vecs ? ld_row(row[u] + k) : zero;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
          const float dx = x[u][v].x - qr[v].x, dy = x[u][v].y - qr[v].y;
          const float dz = x[u][v].z - qr[v].z, dw = x[u][v].w - qr[v].w;
          acc[u] += dx * dx + dy * dy + dz * dz + dw * dw;
        }
    }
    // Reduce within each group, then lane j takes row j of the item.
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      const float v =
          __shfl_sync(0xffffffffu, acc[u], (lane % kGroups) * kLanes);
      if (lane / kGroups == s * kUnroll + u) res = v;
    }
  }
  if (lane < rows)
    out[(size_t)qb * r + i0 + lane] =
        my_pos >= 0 && my_pos < n ? res : __int_as_float(0x7fc00000);
}

template <int kLanes, int kVpl, int kUnroll>
void launch(const void* base, const void* pos, const void* q, void* out,
            long long n, int b, int r, int dim, cudaStream_t stream) {
  const long long items = (long long)b * ((r + kItem - 1) / kItem);
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  gather_l2_kernel<kLanes, kVpl, kUnroll><<<blocks, kThreads, 0, stream>>>(
      static_cast<const float4*>(base), static_cast<const int64_t*>(pos),
      static_cast<const float4*>(q), static_cast<float*>(out), n, b, r,
      dim >> 2);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Preconditions, checked by the Python wrapper: every pointer is 16-byte
// aligned and dim % 4 == 0.
extern "C" int rabitq_gather_l2(const void* base, const void* pos,
                                const void* q, void* out, long long n,
                                int b, int r, int dim, void* stream) {
  if (b <= 0 || r <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dim <= 128) {
    launch<8, 4, 4>(base, pos, q, out, n, b, r, dim, s);
  } else {
    launch<32, 8, 1>(base, pos, q, out, n, b, r, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
