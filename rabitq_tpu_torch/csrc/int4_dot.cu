// Packed int4 products for Hopper (sm_90a): out = A . B^T, int32.
//
// Replaces the two TPU kernels of tools/int4probe.py:main:
//   k2 (pallas_call at :73): int4 VMEM blocks widened to int8, then the
//      int32-accumulated product                 -> int4_dot_direct;
//   k3 (pallas_call at :98): the same product after an explicit async
//      HBM->VMEM copy of the int4 A block (make_async_copy + semaphore)
//                                                -> int4_dot_staged.
//
// Operands: A [M, K/2] and B [N, K/2] uint8, two's-complement nibbles,
// the low nibble holding the even column (rabitq_tpu_torch/ops/int4.py:
// pack_int4). out [M, N] int32. The plain PyTorch twin is
// int4_dot_reference in the same module; integer arithmetic, so kernel ==
// twin exactly.
//
// Design: a block computes a 16-row x 64-column output tile with 8 warps.
// Warp w owns A rows 2w and 2w+1, lane l owns B rows l and l+32, so each
// thread holds a 2 x 2 tile of int32 sums. The K axis goes by 16-byte
// chunks (32 nibbles): every 32-bit word of eight nibbles widens in
// registers to two int8x4 words (even and odd columns), each nibble
// sign-extended as (n ^ 8) - 8 with per-byte __vsub4, and accumulates
// with __dp4a. int4_dot_direct reads A from global memory (the warp's
// lanes share each A word); int4_dot_staged first copies the block's A
// tile into shared memory with cp.async 16-byte chunks (commit_group /
// wait_group, the counterpart of the TPU kernel's DMA + semaphore wait)
// and reads A from there.
//
// What bounds it on this card: at the scan-window shape (M rows of codes,
// N queries, N small) the A bytes, M * K / 2, which packing halves
// against int8 codes; the B tile stays in L1/L2. Widening costs about as
// many integer instructions as the __dp4a themselves. The design does
// nothing about either yet: tensor-core int8 mma on the widened tiles is
// the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 16;  // A rows per block: 2 per warp
constexpr int kTileN = 64;  // B rows per block: 2 per lane

__device__ __forceinline__ int widen(unsigned nibbles) {
  // Four nibbles, one in the low half of each byte -> four int8s.
  return static_cast<int>(
      __vsub4((nibbles & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u));
}

__device__ __forceinline__ int dot_word(unsigned a, unsigned b, int acc) {
  acc = __dp4a(widen(a), widen(b), acc);            // even columns
  return __dp4a(widen(a >> 4), widen(b >> 4), acc);  // odd columns
}

__device__ __forceinline__ int dot_chunk(uint4 a, uint4 b, int acc) {
  acc = dot_word(a.x, b.x, acc);
  acc = dot_word(a.y, b.y, acc);
  acc = dot_word(a.z, b.z, acc);
  return dot_word(a.w, b.w, acc);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
int4_dot_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                int32_t* __restrict__ out, int m, int n, int chunks) {
  extern __shared__ uint4 a_s[];  // staged: [kTileM, chunks]
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;
  const int rows = min(kTileM, m - row0);
  if (kStaged) {
    for (int c = threadIdx.x; c < rows * chunks; c += kThreads)
      cp_async16(&a_s[c], &a[(size_t)row0 * chunks + c]);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Out-of-range rows and columns read row 0 of the tile / of B and are
  // never stored.
  int ra[2], cb[2];
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    ra[i] = r < rows ? r : 0;
    const int c = col0 + lane + 32 * i;
    cb[i] = c < n ? c : col0;
  }
  int acc[2][2] = {{0, 0}, {0, 0}};
  for (int k = 0; k < chunks; ++k) {
    uint4 av[2], bv[2];
    for (int i = 0; i < 2; ++i) {
      av[i] = kStaged ? a_s[ra[i] * chunks + k]
                      : a[(size_t)(row0 + ra[i]) * chunks + k];
      bv[i] = b[(size_t)cb[i] * chunks + k];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = dot_chunk(av[i], bv[j], acc[i][j]);
  }
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    if (r >= rows) continue;
    for (int j = 0; j < 2; ++j) {
      const int c = col0 + lane + 32 * j;
      if (c < n) out[(size_t)(row0 + r) * n + c] = acc[i][j];
    }
  }
}

}  // namespace

// Launches int4_dot_staged (staged != 0) or int4_dot_direct on `stream`
// and returns cudaGetLastError() (0 = ok). Preconditions, checked by the
// Python wrapper: a and b 16-byte aligned; kb = K/2 bytes a row, a
// multiple of 16; n <= 65535 * 64 (column tiles go on gridDim.y); staged:
// the 16 * kb bytes of the A tile fit a block's shared memory.
extern "C" int rabitq_int4_dot(const void* a, const void* b, void* out,
                               int m, int n, int kb, int staged,
                               void* stream) {
  if (m > 0 && n > 0) {
    const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
    const int chunks = kb / 16;
    const auto* a4 = static_cast<const uint4*>(a);
    const auto* b4 = static_cast<const uint4*>(b);
    auto* o = static_cast<int32_t*>(out);
    auto s = static_cast<cudaStream_t>(stream);
    if (staged) {
      const size_t smem = (size_t)kTileM * kb;
      cudaError_t e = cudaFuncSetAttribute(
          int4_dot_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      int4_dot_kernel<true><<<grid, kThreads, smem, s>>>(a4, b4, o, m, n,
                                                         chunks);
    } else {
      int4_dot_kernel<false><<<grid, kThreads, 0, s>>>(a4, b4, o, m, n,
                                                       chunks);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
