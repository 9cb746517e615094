// Exact-rerank gather + squared L2 for Hopper (sm_90a).
//
// Replaces the TPU kernel rabitq_tpu/ops/rerank_kernel.py:pallas_gather_l2
// (Pallas body _kernel), which DMAs each candidate row from a lane-tiled
// copy of the base. This kernel reads the dense [N, D] f32 base directly:
//
//   out[b, i] = sum_d (base[pos[b, i], d] - q[b, d])^2
//
// for pos [B, R] int64 rows of base and q [B, D] f32; a position outside
// [0, N) is not read and gives NaN. The plain PyTorch
// twin is rabitq_tpu_torch/ops/rerank_kernel.py:gather_l2_reference; the
// sums run in another order, so the two agree to f32 rounding, not bit
// for bit.
//
// Design: one block per query. The block stages q_b in shared memory;
// each warp takes candidates i = warp, warp + warps, ...; its lanes read
// the candidate's row as consecutive float4s (16 B a thread, coalesced),
// accumulate (x - q)^2 in fp32, and reduce with __shfl_xor_sync; lane 0
// writes out[b, i].
//
// What bounds it on this card: the B * R * D * 4 bytes of candidate rows,
// with one dependent row read per warp in flight (D / 128 float4 loads a
// lane). The design does nothing about that yet. Several rows in flight
// per warp, or cp.async prefetch of the next row, is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
gather_l2_kernel(const float4* __restrict__ base,
                 const int64_t* __restrict__ pos,
                 const float4* __restrict__ q,
                 float* __restrict__ out, int64_t n, int r, int dim) {
  extern __shared__ float4 q_s[];  // dim / 4 float4s of query b
  const int b = blockIdx.x;
  const int vecs = dim >> 2;
  for (int v = threadIdx.x; v < vecs; v += kThreads)
    q_s[v] = q[(size_t)b * vecs + v];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t* pos_b = pos + (size_t)b * r;
  float* out_b = out + (size_t)b * r;
  for (int i = warp; i < r; i += kWarps) {
    const int64_t p = pos_b[i];
    if (p < 0 || p >= n) {  // warp-uniform branch
      if (lane == 0) out_b[i] = __int_as_float(0x7fc00000);  // NaN
      continue;
    }
    const float4* row = base + (size_t)p * vecs;
    float acc = 0.0f;
#pragma unroll 4
    for (int v = lane; v < vecs; v += 32) {
      const float4 x = row[v];
      const float4 y = q_s[v];
      const float dx = x.x - y.x, dy = x.y - y.y;
      const float dz = x.z - y.z, dw = x.w - y.w;
      acc += dx * dx + dy * dy + dz * dz + dw * dw;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) out_b[i] = acc;
  }
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
// Preconditions, checked by the Python wrapper: every pointer is 16-byte
// aligned and dim % 4 == 0.
extern "C" int rabitq_gather_l2(const void* base, const void* pos,
                                const void* q, void* out, long long n,
                                int b, int r, int dim, void* stream) {
  if (b > 0 && r > 0) {
    gather_l2_kernel<<<b, kThreads, (size_t)dim * sizeof(float),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(base), static_cast<const int64_t*>(pos),
        static_cast<const float4*>(q), static_cast<float*>(out), n, r, dim);
  }
  return static_cast<int>(cudaGetLastError());
}
