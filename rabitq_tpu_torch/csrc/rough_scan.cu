// RaBitQ rough-distance scan for Hopper (sm_90a), grouped by cluster.
//
// Replaces the TPU kernel rabitq_tpu/ops/scan_kernel.py:pallas_rough_scan
// (Pallas body _kernel): its full output, its lane fold (reduce 1 or 2) and
// its nibble-packed query operand (qpack).
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
// The dot is exact in int32 (|dot| <= 127 * 15 * D < 2^24 for D <= 8192).
//
// The row-filter penalty (optional, any depth): penalty [N] f32 holds 0 for
// an allowed row and +inf for a filtered one, in the dense row order of
// codes (rabitq_tpu_torch/index/filter.py). When the pointer is set, out =
// estimate + penalty[row], added after the estimate and before the store
// or the fold's slot packing, so a filtered row is +inf unfolded and, its
// packed value a NaN or +inf, never enters a fold bucket. A row tile's
// penalties ride the cp.async ring with its factors (4 bytes a row), so a
// group's tasks read them from shared memory. The JAX search adds the same
// penalty as a [S, span] window after its kernel
// (rabitq_tpu/index/search.py:502-518).
//
// The lane fold (template depth kFold = 1 or 2, chosen by the wrapper's
// effective_fold): out is [S, kFold * 128] instead of [S, span]. Column
// r < 128 holds the smallest slot-packed value of bucket {j < size :
// j % 128 == r}, column 128 + r (kFold 2) the second smallest. A packed
// value is the estimate's bits with the low slot_bits mantissa bits
// replaced by j (slot_bits = bit length of span - 1); buckets without
// enough valid slots hold +inf. Values enter each bucket in slot order
// through the strict < chain of the JAX kernel (scan_kernel.py:276-280),
// so NaN estimates drop and the result equals the twin's bit for bit.
//
// qpack (a runtime flag, any depth): qvals are [S, D/2] int8, byte i =
// q[i] | q[i + D/2] << 4 (D % 256 == 0), as the fused quantize kernel
// (csrc/quantize.cu) writes them. The JAX kernel contracts the two nibble
// halves against the two code halves (scan_kernel.py:180-203); here the
// group's packed rows are widened once into the same shared [kQpc][lda]
// query tile the unpacked mode stages, so the product and the epilogue are
// the unpacked mode's and the output is bit-equal to it. The mode halves
// the query bytes a group reads (S x D/2 instead of S x D).
//
// What bounds it on this card: bytes. A batch must read each probed
// cluster's rows once (D + 16 bytes a row, codes and factors), each task's
// query values once and write the [S, span] f32 output once: at D 1024
// about 1.45 GB a batch, ~0.43 ms at 3.35 TB/s, against 48 G int8
// operations, ~0.024 ms at 1,979 TOP/s. The fold at depth 2 writes 256
// columns a task instead of span (1.41 GB at span 384). One block per task re-read a
// cluster's rows for each of the ~14 (D 128) to ~20 (D 1024) tasks that
// probe it.
//
// Design. The wrapper sorts the tasks by (start, size) (ops/scan_kernel.py:
// group_tasks, the port of the JAX kernel's _group_tasks) and cuts each run
// of equal keys into groups of at most kQpc tasks (glue in torch, on the
// device, no host sync). A persistent grid of blocks takes groups in key
// order from an atomic counter, so a hot cluster's groups run at the same
// time and its window is read from HBM about once and from L2 after. For
// one group, a block
//   - stages the group's query values (kQpc x D int8, zero rows past the
//     group) in shared memory once with cp.async; with qpack it loads the
//     packed rows into registers after the ring's first stages are in
//     flight and writes both nibble halves to the tile (w & 0x0F0F0F0F is
//     dims 4c..4c+3, (w >> 4) & 0x0F0F0F0F the same dims + D/2);
//   - streams the window rows [start, start + size) through a kStages-deep
//     cp.async ring, kRows rows x kChunk code bytes a stage, the factors
//     (and the penalties, when given) riding with a row tile's last chunk;
//   - multiplies on the int8 tensor cores: mma.sync m16n8k32 s8 x s8 ->
//     s32 with ldmatrix fragments. A is the queries (two m16 tiles), B the
//     code rows: a stored [rows, D] row is the column-major k32 x n8
//     operand. Each warp owns 16 window rows of a tile;
//   - applies the estimator to the s32 accumulators and writes out[t, j]
//     by task id, then +inf for slots [size, span); or, folded, keeps
//     each bucket's best kFold values in registers. A thread owns the
//     same window row r of every tile (accumulator (mt, nt, h, e) is row
//     warp*16 + nt*8 + (lane%4)*2 + e), and slot tile*128 + r falls in
//     bucket r, so the running best of its 16 (task, row) pairs needs no
//     shared memory and no second pass; it writes them once a group, as
//     float2 pairs, +inf included. The fold writes kFold * 128 columns a
//     task instead of span.
// Shared rows are padded by 16 bytes so ldmatrix's eight 16-byte rows of
// a phase fall in distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kQpc = 32;       // tasks per group: two m16 tiles
constexpr int kRows = 128;     // window rows per tile: 16 per warp
constexpr int kChunk = 128;    // code bytes (K) per pipeline stage
constexpr int kLdb = kChunk + 16;
constexpr int kStages = 3;
// Codes, factors and penalties of a stage.
constexpr int kStageBytes = kRows * kLdb + kRows * 16 + kRows * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; bytes == 0 zero-fills without reading.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared (through L1); bytes == 0 zero-fills.
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

template <int kFold>
__global__ void __launch_bounds__(kThreads, 2)
rough_scan_kernel(const int8_t* __restrict__ codes,
                  const float4* __restrict__ factors,
                  const int32_t* __restrict__ starts,
                  const int32_t* __restrict__ sizes,
                  const int8_t* __restrict__ qvals,
                  const float4* __restrict__ scal,
                  const float* __restrict__ penalty,
                  const int64_t* __restrict__ order,
                  const int32_t* __restrict__ group_first,
                  int32_t* __restrict__ next_group,
                  float* __restrict__ out,
                  int n_tasks, int dim, int span, int qpack) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_task[kQpc];
  __shared__ float4 s_scal[kQpc];
  __shared__ float s_sqrt[kQpc];
  __shared__ int s_group;

  const int lda = dim + 16;
  unsigned char* s_q = smem;                   // [kQpc][lda] query values
  unsigned char* s_stage = smem + kQpc * lda;  // kStages x kStageBytes
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = (dim + kChunk - 1) / kChunk;
  const float inf = __int_as_float(0x7f800000);
  // Folded: the window slot's bits, and per (mt, h, nt, e) the running
  // best (b1) and second best (b2) packed value of that thread's bucket.
  const int slot_mask = (1 << max(1, 32 - __clz(span - 1))) - 1;
  constexpr int kOutW = kFold * kRows;
  float b1[2][2][2][2], b2[2][2][2][2];

  for (;;) {
    if (tid == 0) s_group = atomicAdd(next_group, 1);
    __syncthreads();
    const int g = s_group;
    // group_first[g] == n_tasks past the last group (and at g == n_tasks).
    if (g >= n_tasks) break;
    const int first = group_first[g];
    if (first >= n_tasks) break;
    const int count = group_first[g + 1] - first;  // 1..kQpc, same key
    const int lead = static_cast<int>(order[first]);
    const int start = starts[lead];
    const int size = max(0, min(sizes[lead], span));
    if (tid < kQpc) {
      const int t = tid < count ? static_cast<int>(order[first + tid]) : -1;
      s_task[tid] = t;
      if (t >= 0) {
        const float4 sc = scal[t];  // lo, delta, code_sum, ycd
        s_scal[tid] = sc;
        s_sqrt[tid] = __fsqrt_rn(sc.w);
      }
    }
    __syncthreads();
    if constexpr (kFold > 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        (&b1[0][0][0][0])[i] = inf;
        (&b2[0][0][0][0])[i] = inf;
      }
    }

    const int n_stages = ((size + kRows - 1) / kRows) * n_chunks;
    if (n_stages > 0 && !qpack) {
      const int qpieces = dim >> 4;
      for (int p = tid; p < kQpc * qpieces; p += kThreads) {
        const int r = p / qpieces;
        const int c = p - r * qpieces;
        const bool ok = r < count;
        const int8_t* src =
            ok ? qvals + (size_t)s_task[r] * dim + c * 16 : qvals;
        cp_async16(smem_u32(s_q + r * lda + c * 16), src, ok ? 16 : 0);
      }
    }

    // Loads stage s (row tile s / n_chunks, K chunk s % n_chunks) into ring
    // slot s % kStages; always commits, so group counts stay uniform.
    auto load_stage = [&](int s) {
      if (s < n_stages) {
        const int tile = s / n_chunks;
        const int chunk = s - tile * n_chunks;
        const int k0 = chunk * kChunk;
        const int pieces = min(kChunk, dim - k0) >> 4;
        unsigned char* buf = s_stage + (s % kStages) * kStageBytes;
        const int row0 = tile * kRows;
        for (int p = tid; p < kRows * pieces; p += kThreads) {
          const int r = p / pieces;
          const int c = p - r * pieces;
          const bool ok = row0 + r < size;
          const int8_t* src =
              ok ? codes + (size_t)(start + row0 + r) * dim + k0 + c * 16
                 : codes;
          cp_async16(smem_u32(buf + r * kLdb + c * 16), src, ok ? 16 : 0);
        }
        if (chunk == n_chunks - 1 && tid < kRows) {
          const bool ok = row0 + tid < size;
          const float4* src = ok ? factors + start + row0 + tid : factors;
          cp_async16(smem_u32(buf + kRows * kLdb + tid * 16), src,
                     ok ? 16 : 0);
          if (penalty != nullptr)
            cp_async4(smem_u32(buf + kRows * (kLdb + 16) + tid * 4),
                      ok ? penalty + start + row0 + tid : penalty,
                      ok ? 4 : 0);
        }
      }
      cp_async_commit();
    };

    for (int s = 0; s < kStages - 1; ++s) load_stage(s);

    if (n_stages > 0 && qpack) {
      // kLoads 16-byte pieces a thread in flight at once; the stores reach
      // the tile before the barrier at the top of stage 0.
      constexpr int kLoads = 4;
      const int half = dim >> 1;
      const int pieces = half >> 4;
      const int total = kQpc * pieces;
      for (int p0 = tid; p0 < total; p0 += kThreads * kLoads) {
        uint4 w[kLoads];
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int p = p0 + i * kThreads;
          const int r = p / pieces;
          w[i] = make_uint4(0, 0, 0, 0);
          if (p < total && r < count)
            w[i] = __ldg(reinterpret_cast<const uint4*>(
                qvals + (size_t)s_task[r] * half + (p - r * pieces) * 16));
        }
#pragma unroll
        for (int i = 0; i < kLoads; ++i) {
          const int p = p0 + i * kThreads;
          if (p >= total) break;
          const int r = p / pieces;
          unsigned char* row = s_q + r * lda + (p - r * pieces) * 16;
          const unsigned m = 0x0F0F0F0Fu;
          *reinterpret_cast<uint4*>(row) =
              make_uint4(w[i].x & m, w[i].y & m, w[i].z & m, w[i].w & m);
          *reinterpret_cast<uint4*>(row + half) =
              make_uint4((w[i].x >> 4) & m, (w[i].y >> 4) & m,
                         (w[i].z >> 4) & m, (w[i].w >> 4) & m);
        }
      }
    }

    const bool two_m = count > 16;
    int acc[2][2][4];
    for (int s = 0; s < n_stages; ++s) {
      cp_async_wait<kStages - 2>();
      __syncthreads();
      load_stage(s + kStages - 1);  // into the slot stage s - 1 left
      const int tile = s / n_chunks;
      const int chunk = s - tile * n_chunks;
      const int k0 = chunk * kChunk;
      const unsigned char* buf = s_stage + (s % kStages) * kStageBytes;
      if (chunk == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0;
      }
      // ldmatrix x4 addresses: lane l feeds row (l & 7) of matrix l >> 3.
      // A: matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31) -> a0..a3.
      // B: matrices (n-tile 0 | 1) x (k 0-15 | 16-31) -> b0..b3.
      const unsigned a_addr =
          smem_u32(s_q + (((lane >> 3) & 1) * 8 + (lane & 7)) * lda + k0 +
                   (lane >> 4) * 16);
      const unsigned b_addr =
          smem_u32(buf + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * kLdb +
                   ((lane >> 3) & 1) * 16);
      const int ksteps = min(kChunk, dim - k0) >> 5;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[4], b[4];
        ldmatrix_x4(b_addr + ks * 32, b);
        ldmatrix_x4(a_addr + ks * 32, a);
        mma_s8(acc[0][0], a, b[0], b[1]);
        mma_s8(acc[0][1], a, b[2], b[3]);
        if (two_m) {
          ldmatrix_x4(a_addr + 16 * lda + ks * 32, a);
          mma_s8(acc[1][0], a, b[0], b[1]);
          mma_s8(acc[1][1], a, b[2], b[3]);
        }
      }
      if (chunk == n_chunks - 1) {
        // Accumulator (mt, nt)[h * 2 + e]: task mt*16 + h*8 + lane/4,
        // window row warp*16 + nt*8 + (lane%4)*2 + e of this tile.
        const float4* fac =
            reinterpret_cast<const float4*>(buf + kRows * kLdb);
        const float* pen =
            reinterpret_cast<const float*>(buf + kRows * (kLdb + 16));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = mt * 16 + h * 8 + (lane >> 2);
            if (m >= count) continue;
            const float4 sc = s_scal[m];
            const float sq = s_sqrt[m];
            float* out_t = out + (size_t)s_task[m] * span;  // unfolded
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int r = warp * 16 + nt * 8 + (lane & 3) * 2 + e;
                const int j = tile * kRows + r;
                if (j >= size) continue;
                const float4 f = fac[r];  // ip, ppc, err, cdsq
                const int dot = acc[mt][nt][h * 2 + e];
                float v = __fadd_rn(f.w, sc.w);
                v = __fadd_rn(v, __fmul_rn(sc.x, f.y));
                v = __fadd_rn(
                    v, __fmul_rn(__fmul_rn(__int2float_rn(dot), f.x), sc.y));
                v = __fsub_rn(v, __fmul_rn(f.z, sq));
                if (penalty != nullptr) v = __fadd_rn(v, pen[r]);
                if constexpr (kFold == 0) {
                  out_t[j] = v;
                } else {
                  const float pe =
                      __int_as_float((__float_as_int(v) & ~slot_mask) | j);
                  float& v1 = b1[mt][h][nt][e];
                  const bool lt1 = pe < v1;
                  if constexpr (kFold >= 2) {
                    float& v2 = b2[mt][h][nt][e];
                    v2 = lt1 ? v1 : (pe < v2 ? pe : v2);
                  }
                  if (lt1) v1 = pe;
                }
              }
            }
          }
        }
      }
    }

    if constexpr (kFold == 0) {
      const int pad = span - size;
      for (int p = tid; p < count * pad; p += kThreads) {
        const int i = p / pad;
        out[(size_t)s_task[i] * span + size + (p - i * pad)] = inf;
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + h * 8 + (lane >> 2);
          if (m >= count) continue;
          float* out_t = out + (size_t)s_task[m] * kOutW;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int r = warp * 16 + nt * 8 + (lane & 3) * 2;
            *reinterpret_cast<float2*>(out_t + r) =
                make_float2(b1[mt][h][nt][0], b1[mt][h][nt][1]);
            if constexpr (kFold >= 2)
              *reinterpret_cast<float2*>(out_t + kRows + r) =
                  make_float2(b2[mt][h][nt][0], b2[mt][h][nt][1]);
          }
        }
      }
    }
    cp_async_wait<0>();  // the ring's trailing commits are empty
    __syncthreads();
  }
}

// The launch of one depth's kernel. The attribute and occupancy queries
// cost host time every batch, so the resident-block count is kept per
// (device, smem) for the process, per depth (each instantiation is a
// function of its own). The shared-memory maximum is a per-device
// attribute of the function: it only ever grows, so a launch never finds
// it below its own size.
template <int kFold>
int launch_scan(const void* codes, const void* factors, const void* starts,
                const void* sizes, const void* qvals, const void* scal,
                const void* penalty, const void* order,
                const void* group_first, void* next_group, void* out,
                int n_tasks, int dim, int span, int qpack,
                cudaStream_t stream) {
  const int smem = kQpc * (dim + 16) + kStages * kStageBytes;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::pair<int, int>, int> resident_of;
  static std::map<int, int> smem_set;
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = resident_of.find({device, smem});
    if (it != resident_of.end()) {
      resident = it->second;
    } else {
      int& set = smem_set[device];
      if (smem > set) {
        err = cudaFuncSetAttribute(rough_scan_kernel<kFold>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        set = smem;
      }
      int sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, rough_scan_kernel<kFold>, kThreads, smem)) !=
              cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      resident = per_sm * sms;
      resident_of[{device, smem}] = resident;
    }
  }
  const int grid = n_tasks < resident ? n_tasks : resident;
  rough_scan_kernel<kFold><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float4*>(factors),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sizes),
      static_cast<const int8_t*>(qvals), static_cast<const float4*>(scal),
      static_cast<const float*>(penalty), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(group_first),
      static_cast<int32_t*>(next_group), static_cast<float*>(out), n_tasks,
      dim, span, qpack);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Tasks per group that the kernel was built for; the wrapper's grouping
// must cut at the same count.
extern "C" int rabitq_rough_scan_qpc() { return kQpc; }

// Launches the scan on `stream` and returns a CUDA error code (0 = ok).
// order [S] int64 and group_first [S + 1] int32 come from the wrapper's
// grouping: the tasks of group g are order[group_first[g] ..
// group_first[g + 1]), at most kQpc of them, all with one (start, size);
// group_first is S past the last group. next_group is one int32 set to 0.
// fold is the effective depth: 0 writes out [S, span], 1 or 2 the folded
// [S, fold * 128] (the wrapper applies effective_fold, so span > fold *
// 128). qpack != 0: qvals are nibble-packed [S, dim / 2]. penalty is the
// row filter's [N] f32 (0 or +inf) added to every estimate, or null.
// Preconditions, checked by the Python wrapper: every pointer is 16-byte
// aligned, dim % 32 == 0 (dim % 256 == 0 with qpack), and starts[t] +
// min(sizes[t], span) <= N for every task.
extern "C" int rabitq_rough_scan(const void* codes, const void* factors,
                                 const void* starts, const void* sizes,
                                 const void* qvals, const void* scal,
                                 const void* penalty, const void* order,
                                 const void* group_first, void* next_group,
                                 void* out, int n_tasks,
                                 int dim, int span, int fold, int qpack,
                                 void* stream) {
  if (n_tasks <= 0) return 0;
  auto* st = static_cast<cudaStream_t>(stream);
  switch (fold) {
    case 0:
      return launch_scan<0>(codes, factors, starts, sizes, qvals, scal,
                            penalty, order, group_first, next_group, out,
                            n_tasks, dim, span, qpack, st);
    case 1:
      return launch_scan<1>(codes, factors, starts, sizes, qvals, scal,
                            penalty, order, group_first, next_group, out,
                            n_tasks, dim, span, qpack, st);
    case 2:
      return launch_scan<2>(codes, factors, starts, sizes, qvals, scal,
                            penalty, order, group_first, next_group, out,
                            n_tasks, dim, span, qpack, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
