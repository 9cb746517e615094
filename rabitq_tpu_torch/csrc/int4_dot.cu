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
// What bounds it on this card: at the scan-window shape (M = 65,536 code
// rows, N = 64 queries, K = 1024) the bytes: M K / 2 of packed A plus the
// M N * 4 of output, 50 MB, 15 us at 3.35 TB/s, against 8.6 G int8
// operations, 4.3 us at 1,979 TOP/s. Widening nibbles and multiplying
// with __dp4a on the CUDA cores (the design this replaces) spent ~3 G
// integer instructions there and ran at 5% of the bound.
//
// Design. The product runs on the int8 tensor cores: mma.sync m16n8k32
// s8 x s8 -> s32, A as the row-major m16 x k32 operand, B as the
// column-major k32 x n8 one (a stored [N, K] row is a column of B^T).
//   - K order. The mma's k axis may take the columns in any order, as long
//     as A and B agree. A packed 32-bit word holds 8 columns; widened, its
//     even columns fill one int8x4 register and its odd ones another. For
//     k step j of a 128-column chunk, lane (g, t) of the mma quad layout
//     (g = lane / 4, t = lane % 4) takes word 4 t + j of its rows' chunk:
//     even columns -> a0/a1 (mma k 4t..4t+3), odd -> a2/a3 (k 16+4t..).
//   - A (the long code side) widens in registers, three integer
//     instructions a word: (w << 4) & 0xF0F0F0F0 and w & 0xF0F0F0F0 put
//     each nibble in the high half of its byte, which is 16 times its
//     signed value as an int8 (the nibble's sign bit is the byte's). The
//     sum is then 16 times the product, shifted back exactly (>> 4) at the
//     store; |sum| <= 16 * 64 * K stays in int32 for K < 2^21.
//   - B (the <= 64 query side) is widened once per block into shared
//     memory as exact int8 ((n ^ 8) - 8 a byte, __vsub4), each packed word
//     as 8 bytes (even columns, odd columns), so a lane's b0/b1 of one n8
//     tile and k step is one 8-byte shared load. Rows are padded by 8 bytes
//     so the 8 rows x 4 lanes of a load fall in distinct banks. K beyond
//     2048 columns is widened 2048 at a time (between barriers), so any K
//     fits.
//   - A warp owns 32 A rows (two m16 tiles) by the block's 64 B rows
//     (eight n8 tiles, those past N skipped): 64 int32 accumulators a lane,
//     two mma a shared load of B.
//   - int4_dot_direct streams A's packed 16-byte pieces (a quad reads 64
//     contiguous bytes of a row) from global memory into registers, one
//     128-column chunk ahead. int4_dot_staged brings A chunks of 256 rows
//     x 64 bytes through a kStages-deep cp.async ring in shared memory
//     (commit_group / wait_group, the counterpart of k3's DMA + semaphore),
//     carried across the block's tiles. A's first loads are issued before B
//     is widened, so the two overlap. An L2 prefetch hint on A's loads
//     (.L2::256B) and a bulk L2 prefetch of each warp's rows both measured
//     slower; a 4-stage ring at one block an SM slower than 3 stages at two.
//   - Grid: persistent over 256-row M tiles (x), one 64-column B tile per
//     block (y), as many blocks as fit the card at once (two an SM at K
//     1024: 128 registers, 66 KB of widened B plus the staged ring's 48 KB).
//   - Output: each lane stores its accumulator pairs as 8-byte int2 (when N
//     is even): a warp's store writes 8 rows x 32 contiguous bytes, whole
//     32-byte sectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarpRows = 32;  // A rows a warp: two m16 tiles
constexpr int kTileM = (kThreads / 32) * kWarpRows;  // 256 A rows a tile
constexpr int kTileN = 64;     // B rows a block: eight n8 tiles
constexpr int kChunkBytes = 64;  // packed bytes of a row a chunk (128 columns)
constexpr int kSuperChunks = 16;  // chunks of B widened at once (2048 columns)
constexpr int kStages = 3;        // staged: depth of the cp.async ring
constexpr int kStageBytes = kTileM * kChunkBytes;  // 16 KB

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes == 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 packed bytes of A through the read-only path. Volatile, so that a
// guarded load is never speculated past its guard.
__device__ __forceinline__ uint4 ld_a(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// c += a (16x32 s8, row) * b (32x8 s8, col), s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Word j (a compile-time constant after unrolling) of four.
__device__ __forceinline__ unsigned word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// The even / odd columns of a packed word as int8x4 of 16 x their values.
__device__ __forceinline__ unsigned even16(unsigned w) {
  return (w << 4) & 0xF0F0F0F0u;
}
__device__ __forceinline__ unsigned odd16(unsigned w) {
  return w & 0xF0F0F0F0u;
}

// The four nibbles in the low halves of the bytes as exact int8x4.
__device__ __forceinline__ unsigned widen(unsigned nibbles) {
  return __vsub4((nibbles & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
int4_dot_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                int32_t* __restrict__ out, int m, int n, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_chunks = max(1, (kb + kChunkBytes - 1) / kChunkBytes);
  const int n_super = (n_chunks + kSuperChunks - 1) / kSuperChunks;
  const int ldb = min(n_chunks, kSuperChunks) * 2 * kChunkBytes + 8;
  unsigned char* b_s = smem;                   // [kTileN][ldb] widened B
  unsigned char* ring = smem + kTileN * ldb;   // staged: the A ring
  const int col0 = blockIdx.y * kTileN;
  const int cols = min(kTileN, n - col0);
  const int n8 = (cols + 7) >> 3;
  const int m_tiles = (m + kTileM - 1) / kTileM;
  const int my_tiles = (m_tiles - 1 - blockIdx.x) / gridDim.x + 1;
  const int n_stages = my_tiles * n_chunks;  // (tile, chunk) pairs, in order

  // B's columns of super-chunk sc, widened; zero past K and past N. A
  // thread issues its (up to) 4 loads a round before widening any.
  auto widen_b = [&](int sc) {
    const int byte0 = sc * kSuperChunks * kChunkBytes;
    const int pieces = min(kSuperChunks, n_chunks - sc * kSuperChunks) *
                       (kChunkBytes / 16);  // 16-byte pieces a row
    for (int p0 = 0; p0 < kTileN * pieces; p0 += 4 * kThreads) {
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + i * kThreads + tid;
        const int row = p / pieces;
        const int byte = byte0 + (p - row * pieces) * 16;
        w[i] = row < cols && byte < kb
                   ? *reinterpret_cast<const uint4*>(
                         b + (size_t)(col0 + row) * kb + byte)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = p0 + i * kThreads + tid;
        const int row = p / pieces;
        if (row >= kTileN) break;
        uint2* dst = reinterpret_cast<uint2*>(b_s + row * ldb +
                                              (p - row * pieces) * 32);
        dst[0] = make_uint2(widen(w[i].x), widen(w[i].x >> 4));
        dst[1] = make_uint2(widen(w[i].y), widen(w[i].y >> 4));
        dst[2] = make_uint2(widen(w[i].z), widen(w[i].z >> 4));
        dst[3] = make_uint2(widen(w[i].w), widen(w[i].w >> 4));
      }
    }
  };
  auto tile_row0 = [&](int s) {
    return (blockIdx.x + (s / n_chunks) * gridDim.x) * kTileM;
  };
  // This lane's 16 packed bytes of A for stage s: rows warp*32 + mt*16 +
  // h*8 + g of the tile, bytes 16 t of the chunk; zero past M and K.
  auto load_a = [&](int s, uint4 (&av)[2][2]) {
    const int byte = (s % n_chunks) * kChunkBytes + t * 16;
    const int row0 = tile_row0(s) + warp * kWarpRows + g;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + mt * 16 + h * 8;
        av[mt][h] = row < m && byte < kb
                        ? ld_a(a + (size_t)row * kb + byte)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
  };
  // Staged: the block's 256 rows x 64 bytes of stage s into ring slot
  // s % kStages; always commits, so group counts stay uniform.
  auto load_stage = [&](int s) {
    if (s < n_stages) {
      const int byte0 = (s % n_chunks) * kChunkBytes;
      const int row0 = tile_row0(s);
      unsigned char* buf = ring + (s % kStages) * kStageBytes;
      for (int p = tid; p < kTileM * (kChunkBytes / 16); p += kThreads) {
        const int r = p >> 2;
        const int byte = byte0 + (p & 3) * 16;
        const bool ok = row0 + r < m && byte < kb;
        cp_async16(smem_u32(buf + r * kChunkBytes + (p & 3) * 16),
                   ok ? a + (size_t)(row0 + r) * kb + byte : a, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // A's first loads go out before B is widened, so the two overlap.
  uint4 nxt[2][2];
  if constexpr (kStaged) {
    for (int s = 0; s < kStages - 1; ++s) load_stage(s);
  } else {
    load_a(0, nxt);
  }
  if (n_super == 1) widen_b(0);
  if constexpr (!kStaged) __syncthreads();
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 64; ++i) (&acc[0][0][0])[i] = 0;

  for (int s = 0; s < n_stages; ++s) {
    const int c = s % n_chunks;
    uint4 av[2][2];
    if constexpr (kStaged) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // stage s landed; stage s - 1's slot is free
      if (n_super > 1 && c % kSuperChunks == 0) {
        widen_b(c / kSuperChunks);
        __syncthreads();
      }
      load_stage(s + kStages - 1);
      const unsigned char* buf =
          ring + (s % kStages) * kStageBytes +
          (warp * kWarpRows + g) * kChunkBytes + t * 16;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          av[mt][h] = *reinterpret_cast<const uint4*>(
              buf + (mt * 16 + h * 8) * kChunkBytes);
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) av[mt][h] = nxt[mt][h];
      if (s + 1 < n_stages) load_a(s + 1, nxt);
      if (n_super > 1 && c % kSuperChunks == 0) {
        __syncthreads();  // every warp is done with the last super-chunk
        widen_b(c / kSuperChunks);
        __syncthreads();
      }
    }

    // Four k32 steps: word j of each 16-byte piece.
    const unsigned char* bq =
        b_s + g * ldb + (c % kSuperChunks) * 2 * kChunkBytes + t * 32;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const unsigned w0 = word(av[mt][0], j);  // row g
        const unsigned w1 = word(av[mt][1], j);  // row g + 8
        af[mt][0] = even16(w0);
        af[mt][1] = even16(w1);
        af[mt][2] = odd16(w0);
        af[mt][3] = odd16(w1);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (nt < n8) {
          const uint2 bv =
              *reinterpret_cast<const uint2*>(bq + nt * 8 * ldb + j * 8);
          mma_s8(acc[0][nt], af[0], bv.x, bv.y);
          mma_s8(acc[1][nt], af[1], bv.x, bv.y);
        }
      }
    }

    if (c == n_chunks - 1) {
      // Accumulator (mt, nt)[h * 2 + e]: row mt*16 + h*8 + g of the warp's
      // 32, column nt*8 + 2t + e of the block's 64; 16 x the product.
      const int row0 = tile_row0(s) + warp * kWarpRows + g;
      const bool pairs = (n & 1) == 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + mt * 16 + h * 8;
          if (row >= m) continue;
          int32_t* o = out + (size_t)row * n + col0;
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const int col = nt * 8 + 2 * t;
            const int v0 = acc[mt][nt][h * 2] >> 4;
            const int v1 = acc[mt][nt][h * 2 + 1] >> 4;
            if (pairs && col + 1 < cols) {
              *reinterpret_cast<int2*>(o + col) = make_int2(v0, v1);
            } else {
              if (col < cols) o[col] = v0;
              if (col + 1 < cols) o[col + 1] = v1;
            }
          }
        }
#pragma unroll
      for (int i = 0; i < 64; ++i) (&acc[0][0][0])[i] = 0;
    }
  }
  if constexpr (kStaged) cp_async_wait<0>();  // the trailing commits are empty
}

// The blocks of one instance that fit the card at once at this
// shared-memory size. Queried on every call: these probe kernels serve no
// search path, so the few microseconds of host time are not worth a cache.
template <bool kStaged>
int resident_blocks(int smem, int* resident) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(int4_dot_kernel<kStaged>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, int4_dot_kernel<kStaged>, kThreads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *resident = per_sm * sms;
  return 0;
}

template <bool kStaged>
int launch(const void* a, const void* b, void* out, int m, int n, int kb,
           cudaStream_t stream) {
  const int n_chunks = kb > 0 ? (kb + kChunkBytes - 1) / kChunkBytes : 1;
  const int ldb =
      (n_chunks < kSuperChunks ? n_chunks : kSuperChunks) * 2 * kChunkBytes +
      8;
  const int smem = kTileN * ldb + (kStaged ? kStages * kStageBytes : 0);
  int resident = 0;
  const int err = resident_blocks<kStaged>(smem, &resident);
  if (err) return err;
  const int m_tiles = (m + kTileM - 1) / kTileM;
  const int n_tiles = (n + kTileN - 1) / kTileN;
  int gx = resident / n_tiles;
  gx = gx < 1 ? 1 : (gx > m_tiles ? m_tiles : gx);
  int4_dot_kernel<kStaged><<<dim3(gx, n_tiles), kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<int32_t*>(out), m, n, kb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches int4_dot_staged (staged != 0) or int4_dot_direct on `stream`
// and returns a CUDA error code (0 = ok). Preconditions, checked by the
// Python wrapper: a and b 16-byte aligned; kb = K/2 bytes a row, a
// multiple of 16; n <= 65535 * 64 (column tiles go on gridDim.y).
extern "C" int rabitq_int4_dot(const void* a, const void* b, void* out,
                               int m, int n, int kb, int staged,
                               void* stream) {
  if (m <= 0 || n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return staged ? launch<true>(a, b, out, m, n, kb, s)
                : launch<false>(a, b, out, m, n, kb, s);
}
