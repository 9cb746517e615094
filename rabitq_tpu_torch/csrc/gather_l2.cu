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
// A second instance reads a bf16 base (the two-level rerank's first level,
// SearchParams.rerank_bf16; in JAX an XLA gather, _gather_l2(...,
// cast_f32=True) in rabitq_tpu/index/search.py):
//
//   out[b, i] = sum_d (f32(base_bf16[pos[b, i], d]) - q[b, d])^2
//
// with q and out f32. Widening bf16 to f32 is exact (a bf16 is the high
// half of an f32), so the instance differs from the f32 one only in the
// row type: rows are read as 16-byte vectors of 8 bf16 values instead of 4
// floats, widened in registers, and the query stays f32 (two float4s a row
// vector). Its bound is the same count with 2 D bytes a distinct row.
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
// Design (both row types). A warp takes one item: 32 consecutive
// positions of one query.
//   - Positions: lane l loads position l of the item (one coalesced 256 B
//     read); rows are handed out with __shfl_sync, so no row read waits on
//     a dependent position load.
//   - Two instances a row type, chosen from D at launch. f32, D <= 128: 8
//     lanes a row, 4 vectors a lane, 4 rows a group a step: every load
//     instruction covers 4 rows of 128 contiguous bytes, 16 vectors a lane
//     and 8 KB a warp in flight. f32, D > 128: 32 lanes a row in chunks of
//     1024 floats, 8 vectors a lane, one 4 KB row a warp a step (98
//     registers). bf16, D <= 128 (a 256-byte row, 16 vectors): 8 lanes a
//     row, 2 vectors a lane, 4 rows a group a step, 4 KB a warp in flight:
//     as many rows in flight as the f32 instance. bf16, D > 128: 32 lanes
//     a row in chunks of 1024 values, 4 vectors a lane, two 2 KB rows a
//     warp a step. Lane s of a group takes vectors s, s + kLanes, ... of
//     its chunk; vectors past the row are masked. Cache hints
//     (L1::no_allocate, an L2 256-byte prefetch) measured no better than
//     the plain read-only load (f32).
//   - Query: each lane keeps the query values of its kVpl row vectors in
//     registers as float4s (reloaded per chunk only when D spans several
//     chunks): no shared memory, no block barrier.
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
__device__ __forceinline__ uint4 ld_row(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// The row types: values a 16-byte vector, and their f32 values.
struct F32Rows {
  static constexpr int kElems = 4;
  __device__ static void widen(const uint4& v, float (&x)[4]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

// bf16 is the high half of an f32, and a 32-bit word holds element 2j in
// its low half (little endian): widening is a shift or a mask, exact, as
// __bfloat1622float2 does.
struct Bf16Rows {
  static constexpr int kElems = 8;
  __device__ static void widen(const uint4& v, float (&x)[8]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

template <class Rows, int kLanes, int kVpl, int kUnroll>
__global__ void __launch_bounds__(kThreads, 2)
gather_l2_kernel(const uint4* __restrict__ base,
                 const int64_t* __restrict__ pos,
                 const float4* __restrict__ q, float* __restrict__ out,
                 int64_t n, int b, int r, int vecs) {
  constexpr int kE = Rows::kElems;           // row values a vector
  constexpr int kQv = kE / 4;                // query float4s a vector
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
  const float4* q_b = q + (size_t)qb * vecs * kQv;
  const int chunks = (vecs + kChunk - 1) / kChunk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint4 zero_row = make_uint4(0u, 0u, 0u, 0u);

  float4 qr[kVpl][kQv];
  auto load_q = [&](int c) {
#pragma unroll
    for (int v = 0; v < kVpl; ++v) {
      const int k = c * kChunk + sub + kLanes * v;
#pragma unroll
      for (int j = 0; j < kQv; ++j)
        qr[v][j] = k < vecs ? __ldg(q_b + k * kQv + j) : zero;
    }
  };
  if (chunks == 1) load_q(0);

  float res = 0.f;
  for (int s = 0; s * kStep < rows; ++s) {
    const uint4* row[kUnroll];
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
      uint4 x[kUnroll][kVpl];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
          const int k = c * kChunk + kLanes * v;
          x[u][v] = ok[u] && k + sub < vecs ? ld_row(row[u] + k) : zero_row;
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int v = 0; v < kVpl; ++v) {
          float e[kE];
          Rows::widen(x[u][v], e);
#pragma unroll
          for (int j = 0; j < kQv; ++j) {
            const float dx = e[4 * j] - qr[v][j].x;
            const float dy = e[4 * j + 1] - qr[v][j].y;
            const float dz = e[4 * j + 2] - qr[v][j].z;
            const float dw = e[4 * j + 3] - qr[v][j].w;
            acc[u] += dx * dx + dy * dy + dz * dz + dw * dw;
          }
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

template <class Rows, int kLanes, int kVpl, int kUnroll>
void launch(const void* base, const void* pos, const void* q, void* out,
            long long n, int b, int r, int dim, cudaStream_t stream) {
  const long long items = (long long)b * ((r + kItem - 1) / kItem);
  const unsigned blocks = static_cast<unsigned>((items + kWarps - 1) / kWarps);
  gather_l2_kernel<Rows, kLanes, kVpl, kUnroll>
      <<<blocks, kThreads, 0, stream>>>(
          static_cast<const uint4*>(base), static_cast<const int64_t*>(pos),
          static_cast<const float4*>(q), static_cast<float*>(out), n, b, r,
          dim / Rows::kElems);
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
    launch<F32Rows, 8, 4, 4>(base, pos, q, out, n, b, r, dim, s);
  } else {
    launch<F32Rows, 32, 8, 1>(base, pos, q, out, n, b, r, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16-row instance: `base` holds bf16 values, q and out f32. The same
// preconditions, with dim % 8 == 0.
extern "C" int rabitq_gather_l2_bf16(const void* base, const void* pos,
                                     const void* q, void* out, long long n,
                                     int b, int r, int dim, void* stream) {
  if (b <= 0 || r <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  if (dim <= 128) {
    launch<Bf16Rows, 8, 2, 4>(base, pos, q, out, n, b, r, dim, s);
  } else {
    launch<Bf16Rows, 32, 4, 2>(base, pos, q, out, n, b, r, dim, s);
  }
  return static_cast<int>(cudaGetLastError());
}
