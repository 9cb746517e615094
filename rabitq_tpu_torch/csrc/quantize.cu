// Fused query-residual quantization for Hopper (sm_90a).
//
// The search stage before the rough scan: the JAX package computes it as
// one XLA fusion (rabitq_tpu/index/search.py:392-407 with
// rabitq_tpu/ops/quantize.py:quantize_query_residuals, and the nibble
// packing of the scan's qpack operand); it is not a Pallas kernel.
//
// A task t = b * probe + j is one (query, probed cluster) pair. With
// r = y[b] - centroids[cids[b, j]] (f32, D values):
//
//   ycd      = sum r^2
//   lo, hi   = min r, max r
//   delta    = max((hi - lo) * scalar, tiny)
//   q[d]     = clamp(rint((r[d] - lo) / delta), 0, qmax)            (round)
//            = clamp(floor((r[d] - lo) / delta + rand_bias[d]), 0, qmax)
//   code_sum = sum q
//
// Outputs: qvals [S, D] int8, or with pack [S, D/2] int8 in the split-half
// layout (byte i = q[i] | q[i + D/2] << 4, the scan's qpack operand), and
// scal [S, 4] f32 = (lo, delta, code_sum, ycd). The scale is written with
// explicitly rounded intrinsics (IEEE division, no FMA contraction), so q,
// lo, delta and code_sum equal the plain PyTorch version
// (rabitq_tpu_torch/ops/quantize.py:quantize_residuals_reference) bit for
// bit. ycd sums in another order than torch.sum: it agrees to f32
// rounding.
//
// What bounds it on this card: bytes. A batch must read y [B, D], each
// distinct probed centroid row once, cids, and write the quantized values
// and scal once: at gist p80 (B 1024, probe 80, D 1024, packed) about
// 64 MB, ~0.019 ms at 3.35 TB/s; a few f32 operations a value cost far
// less. The plain version writes and re-reads the [B, probe, D] f32
// residual (335 MB at gist p80) in several passes.
//
// Design: one warp per task, four tasks a block. The warp reads its query
// row and centroid row once (16 bytes a lane, coalesced), keeps r in
// shared memory, reduces min, max and sum of squares across the warp with
// shuffles, then quantizes from shared memory and writes 4 output bytes a
// lane at a time. Tasks of one query sit in adjacent warps, so y[b] is read
// from HBM about once and from L2 after; a centroid probed by many queries
// is read from L2 after its first read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // tasks a block

__device__ __forceinline__ float quant(float v, float lo, float delta,
                                       const float* __restrict__ bias, int d,
                                       float qmax) {
  float s = __fdiv_rn(__fsub_rn(v, lo), delta);
  s = bias ? floorf(__fadd_rn(s, bias[d])) : rintf(s);
  return fminf(fmaxf(s, 0.0f), qmax);
}

// q of the four values of v (dims d0 .. d0 + 3) as four bytes, shifted.
__device__ __forceinline__ uint32_t quant4(float4 v, float lo, float delta,
                                           const float* __restrict__ bias,
                                           int d0, float qmax, int& sum) {
  const int a = static_cast<int>(quant(v.x, lo, delta, bias, d0, qmax));
  const int b = static_cast<int>(quant(v.y, lo, delta, bias, d0 + 1, qmax));
  const int c = static_cast<int>(quant(v.z, lo, delta, bias, d0 + 2, qmax));
  const int e = static_cast<int>(quant(v.w, lo, delta, bias, d0 + 3, qmax));
  sum += a + b + c + e;
  return static_cast<uint32_t>(a) | (static_cast<uint32_t>(b) << 8) |
         (static_cast<uint32_t>(c) << 16) | (static_cast<uint32_t>(e) << 24);
}

__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ y,
                const float* __restrict__ centroids,
                const int64_t* __restrict__ cids,
                const float* __restrict__ rand_bias,
                int8_t* __restrict__ qvals, float4* __restrict__ scal,
                int n_tasks, int probe, int dim, int pack, float scalar,
                float tiny, float qmax) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kWarps + warp;
  if (t >= n_tasks) return;  // no block-wide barrier follows
  float4* r = reinterpret_cast<float4*>(smem + warp * dim);
  const int n4 = dim >> 2;
  const float4* yr =
      reinterpret_cast<const float4*>(y + (size_t)(t / probe) * dim);
  const float4* cr =
      reinterpret_cast<const float4*>(centroids + (size_t)cids[t] * dim);

  float lo = __int_as_float(0x7f800000), hi = -lo, ss = 0.0f;
  for (int c = lane; c < n4; c += 32) {
    const float4 a = yr[c], b = cr[c];
    const float4 v = make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                                 __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
    r[c] = v;
    lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
    hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    ss = __fadd_rn(ss, __fmul_rn(v.x, v.x));
    ss = __fadd_rn(ss, __fmul_rn(v.y, v.y));
    ss = __fadd_rn(ss, __fmul_rn(v.z, v.z));
    ss = __fadd_rn(ss, __fmul_rn(v.w, v.w));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  }
  const float delta = fmaxf(__fmul_rn(__fsub_rn(hi, lo), scalar), tiny);
  __syncwarp();

  int sum = 0;
  if (pack) {
    // Output word c: dims 4c .. 4c+3 in the low nibbles, the same dims
    // + D/2 in the high ones.
    const int half = dim >> 1;
    uint32_t* out = reinterpret_cast<uint32_t*>(qvals + (size_t)t * half);
    for (int c = lane; c < (dim >> 3); c += 32) {
      const uint32_t ql =
          quant4(r[c], lo, delta, rand_bias, 4 * c, qmax, sum);
      const uint32_t qh = quant4(r[c + (dim >> 3)], lo, delta, rand_bias,
                                 half + 4 * c, qmax, sum);
      out[c] = ql | (qh << 4);
    }
  } else {
    uint32_t* out = reinterpret_cast<uint32_t*>(qvals + (size_t)t * dim);
    for (int c = lane; c < n4; c += 32)
      out[c] = quant4(r[c], lo, delta, rand_bias, 4 * c, qmax, sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) scal[t] = make_float4(lo, delta, __int2float_rn(sum), ss);
}

}  // namespace

// Launches the quantize kernel on `stream` and returns a CUDA error code
// (0 = ok). y [B, D] f32, centroids [K, D] f32, cids [B * probe] int64,
// rand_bias [D] f32 or null (null: round to nearest, else floor + bias),
// qvals [S, D] int8 or, with pack, [S, D / 2] int8, scal [S, 4] f32.
// Preconditions: every pointer is 16-byte aligned and dim % 8 == 0
// (checked by the Python wrapper); 0 <= cids < K (the caller's: search
// takes them from a sort of the K centroid distances).
extern "C" int rabitq_quantize_residuals(const void* y, const void* centroids,
                                         const void* cids,
                                         const void* rand_bias, void* qvals,
                                         void* scal, int n_tasks, int probe,
                                         int dim, int pack, float scalar,
                                         float tiny, float qmax,
                                         void* stream) {
  if (n_tasks <= 0) return 0;
  const int smem = kWarps * dim * static_cast<int>(sizeof(float));
  // Above the 48 KB default (D > 3072) the function needs the larger
  // dynamic shared-memory maximum set on the current device.
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        quantize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_tasks + kWarps - 1) / kWarps;
  quantize_kernel<<<grid, kWarps * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(centroids),
      static_cast<const int64_t*>(cids), static_cast<const float*>(rand_bias),
      static_cast<int8_t*>(qvals), static_cast<float4*>(scal), n_tasks,
      probe, dim, pack, scalar, tiny, qmax);
  return static_cast<int>(cudaGetLastError());
}
