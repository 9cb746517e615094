// RaBitQ rough-distance scan for Hopper (sm_90a).
//
// Replaces the TPU kernel rabitq_tpu/ops/scan_kernel.py:pallas_rough_scan
// (Pallas body _kernel) in its unfolded, unpacked form.
//
// A task t is one (query, probed cluster) pair. For every slot j < span of
// task t, row = starts[t] + j of the cluster-sorted index:
//
//   dot  = <qvals[t], codes[row]>            (int8 x int8, int32 sum)
//   out  = ((((cdsq + ycd) + lo*ppc) + (dot*ip)*delta) - err*sqrt(ycd))
//
// for j < sizes[t], and +inf for j >= sizes[t]. codes [N, D] int8 hold the
// code grid v = 2u - (2^bits - 1); factors [N, 4] f32 hold (ip, ppc, err,
// cdsq); scal [S, 4] f32 holds (lo, delta, code_sum, ycd) per task. The
// estimator is written with explicitly rounded intrinsics and an IEEE
// square root, in the operation order of the plain PyTorch twin
// (rabitq_tpu_torch/ops/scan_kernel.py:rough_scan_reference), so nvcc
// cannot contract it to FMAs and the kernel equals the twin bit for bit.
//
// Design: one block per task. The block stages q_t in shared memory as
// 32-bit words; each warp takes rows, its lanes read consecutive words of
// the code row (coalesced), accumulate with __dp4a and reduce with
// __shfl_xor_sync; lane 0 applies the estimator and writes the slot.
//
// What bounds it on this card: the code-window bytes read per task
// (span * D bytes of codes plus span * 16 bytes of factors), because every
// task re-reads its cluster's rows even when many queries of a batch probe
// the same cluster. The design does nothing about that yet. The next step
// is grouping the tasks that share a cluster so one window read (and one
// int8 tensor-core product, mma/wgmma) serves the whole group.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
rough_scan_kernel(const int8_t* __restrict__ codes,
                  const float4* __restrict__ factors,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ sizes,
                  const int8_t* __restrict__ qvals,
                  const float4* __restrict__ scal,
                  float* __restrict__ out,
                  int dim, int span) {
  extern __shared__ int q_words[];  // dim / 4 packed int8 query values
  const int t = blockIdx.x;
  const int words = dim >> 2;
  const int* q_t = reinterpret_cast<const int*>(qvals + (size_t)t * dim);
  for (int w = threadIdx.x; w < words; w += kThreads) q_words[w] = q_t[w];
  __syncthreads();

  const int start = starts[t];
  const int size = min(sizes[t], span);
  const float4 sc = scal[t];  // lo, delta, code_sum, ycd
  const float sqrt_ycd = __fsqrt_rn(sc.w);
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* out_t = out + (size_t)t * span;

  for (int j = warp; j < span; j += kWarps) {
    if (j >= size) {  // warp-uniform branch
      if (lane == 0) out_t[j] = inf;
      continue;
    }
    const size_t row = (size_t)start + j;
    const int* c = reinterpret_cast<const int*>(codes + row * dim);
    int acc = 0;
    for (int w = lane; w < words; w += 32) acc = __dp4a(c[w], q_words[w], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float4 f = factors[row];  // ip, ppc, err, cdsq
      float e = __fadd_rn(f.w, sc.w);
      e = __fadd_rn(e, __fmul_rn(sc.x, f.y));
      e = __fadd_rn(e, __fmul_rn(__fmul_rn(__int2float_rn(acc), f.x), sc.y));
      e = __fsub_rn(e, __fmul_rn(f.z, sqrt_ycd));
      out_t[j] = e;
    }
  }
}

}  // namespace

// Launches the scan on `stream` and returns cudaGetLastError() (0 = ok).
// Preconditions, checked by the Python wrapper: every pointer is
// 16-byte aligned, dim % 4 == 0, and for every task
// starts[t] + min(sizes[t], span) <= N.
extern "C" int rabitq_rough_scan(const void* codes, const void* factors,
                                 const void* starts, const void* sizes,
                                 const void* qvals, const void* scal,
                                 void* out, int n_tasks, int dim, int span,
                                 void* stream) {
  if (n_tasks > 0) {
    rough_scan_kernel<<<n_tasks, kThreads, (size_t)dim,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(codes),
        static_cast<const float4*>(factors),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(sizes),
        static_cast<const int8_t*>(qvals),
        static_cast<const float4*>(scal), static_cast<float*>(out), dim,
        span);
  }
  return static_cast<int>(cudaGetLastError());
}
