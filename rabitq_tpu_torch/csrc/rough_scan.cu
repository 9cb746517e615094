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
// qpack (any depth; a template argument of the kernel): qvals are [S, D/2]
// int8, byte i = q[i] | q[i + D/2] << 4 (D % 256 == 0), as the fused
// quantize kernel (csrc/quantize.cu) writes them. The JAX kernel contracts
// the two nibble halves against the two code halves (scan_kernel.py:
// 180-203); here the group's packed rows are staged as they are, in a
// [kQpc][D/2 + 16] tile, and each A fragment is widened in registers after
// its ldmatrix: (a >> s) & 0x0F0F0F0F, s = 0 for dims below D/2 (low
// nibbles) and 4 above (high nibbles of the same bytes; a kChunk-wide K
// chunk never straddles D/2). So the products and the epilogue are the
// unpacked mode's and the output is bit-equal to it. The mode halves the
// query bytes a group reads (S x D/2 instead of S x D) and the query tile.
//
// What bounds it on this card: bytes at the roofline, latency and the
// consumers' instructions in practice. A batch must read each probed
// cluster's rows once (D + 16 bytes a row, codes and factors), each task's
// query values once and write its output once: at D 1024 about 1.45 GB a
// batch unfolded, ~0.43 ms at 3.35 TB/s, against 48 G int8 operations,
// ~0.024 ms at 1,979 TOP/s. The fold at depth 2 writes 256 columns a task
// instead of span. A group (up to kQpc tasks on one window) is a short
// chain of dependent steps: its descriptor (group_first, then order, then
// starts, sizes and scal), its query tile, the window's row tiles, the
// products, the fold's stores. At D 128 a window is one to four row tiles,
// so a block that runs those steps one group after another waits on memory
// most of the time; at D 1024 a group streams 8 stages a row tile and needs
// bytes in flight to cover HBM's latency. With the loads overlapped (below)
// the consumer warps' estimator and fold bound the kernel.
//
// Design: a persistent, warp-specialised block whose load ring runs across
// groups. The wrapper sorts the tasks by (start, size) (ops/scan_kernel.py:
// group_tasks, the port of the JAX kernel's _group_tasks) and cuts each run
// of equal keys into groups of at most kQpc tasks (glue in torch, on the
// device, no host sync). A grid of resident blocks takes groups in key order
// from an atomic counter, so a hot cluster's groups run at the same time and
// its window is read from HBM about once and from L2 after. A block is eight
// consumer warps and one producer warp.
//   - The producer warp takes the next group from the counter and fetches
//     its descriptor (task ids, scalars, their square roots, the window)
//     one dependent step a ring stage while the current group streams; it
//     publishes the group in one of kQbufs query slots as soon as the slot
//     is free (the descriptor, and the query tile by cp.async), and streams
//     each published group's window through a ring of shared-memory stages,
//     kRows rows x kChunk code bytes a stage, the factors (and the
//     penalties, when given) riding with a row tile's last chunk. Its 32
//     lanes issue every load as cp.async, four whole 128-byte row chunks an
//     instruction, and each lane's cp.async.mbarrier.arrive completes the
//     stage's full mbarrier; the consumers release the stage on its empty
//     mbarrier, and each query slot has the same pair. So group g+1's
//     descriptor, query tile and first stages are loaded while the
//     consumers still multiply, fold and store group g. (A bulk copy a row,
//     cp.async.bulk, cost about 30 ns a request on the H100: the gist
//     cell's scan took 11.3 ms instead of 2.6.)
//   - The consumer warps multiply on the int8 tensor cores: mma.sync
//     m16n8k32 s8 x s8 -> s32 with ldmatrix fragments. A is the queries
//     (two m16 tiles), B the code rows: a stored [rows, D] row is the
//     column-major k32 x n8 operand. Each warp owns 16 window rows of a
//     tile. They apply the estimator to the s32 accumulators and write
//     out[t, j] by task id, then +inf for slots [size, span); or, folded,
//     keep each bucket's best kFold values in registers. A thread owns the
//     same window row r of every tile (accumulator (mt, nt, h, e) is row
//     warp*16 + nt*8 + (lane%4)*2 + e), and slot tile*128 + r falls in
//     bucket r, so the running best of its 16 (task, row) pairs needs no
//     shared memory and no second pass; it writes them once a group, as
//     float2 pairs, +inf included. Then they release the group's slot and
//     go on to the next group, whose stages are already in the ring.
//   - Depth (launch_scan's plan): two blocks an SM where each keeps at
//     least kMinSlots stages beside kQbufs query slots (D 128: 4 stages,
//     ~93 KB a block; D 1024 packed: 3 stages, ~96 KB), else one block an
//     SM with up to kMaxSlots stages (D 1024 unpacked: 7). The consumers
//     bound the scan: their fold epilogue issues ~20 instructions a (task,
//     row) pair, and with it taken out the kernel ran 13-27% faster. So a
//     second block's eight warps are worth more than a deeper ring: at the
//     gist cell one block of 8 stages took 3.07 ms, two of 3 stages 2.00
//     ms; a third query slot, one block of 8 stages at D 128, three blocks
//     (72 registers, spilling) and descriptors fetched in adjacent pairs
//     (which keeps more one-stage windows overlapped) were no faster
//     (H100, L2 cold).
// Shared rows are padded by 16 bytes so ldmatrix's eight 16-byte rows of a
// phase fall in distinct banks; a stage's rows past the window are not
// loaded, and their slots are never read.
//
// Counters: at exit each block adds to counts[0] the groups it ran and to
// counts[1] those whose first stage (or, for an empty window, whose
// descriptor) the producer issued before the consumers had released the
// block's previous group: the groups whose loads overlapped another group's
// work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kQpc = 32;       // tasks per group: two m16 tiles
constexpr int kRows = 128;     // window rows per tile: 16 per warp
constexpr int kChunk = 128;    // code bytes (K) per pipeline stage
constexpr int kLdb = kChunk + 16;
// Codes, factors and penalties of a stage.
constexpr int kStageBytes = kRows * kLdb + kRows * 16 + kRows * 4;
constexpr int kQbufs = 2;     // groups staged at once: the current and next
constexpr int kMinSlots = 3;  // stages a block at two blocks an SM
constexpr int kMaxSlots = 8;

// One group as the producer hands it to the consumers.
struct Group {
  int task[kQpc];       // task ids, -1 past count
  float4 scal[kQpc];    // lo, delta, code_sum, ycd
  float sqrt_ycd[kQpc];
  int start, size;      // the window, size clamped to [0, span]
  int count;            // 1..kQpc tasks; 0: no group is left
  int n_stages;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared.
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

// 4 bytes global -> shared (through L1).
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// An arrival once every cp.async this thread issued has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_done(unsigned bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// A fragment of nibble-packed query values -> int8 values 0..15: each byte's
// low (shift 0) or high (shift 4) nibble.
__device__ __forceinline__ void widen(unsigned (&a)[4], unsigned shift) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = (a[i] >> shift) & 0x0F0F0F0Fu;
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

// Shared memory of a block: n_slots ring stages, then n_q query buffers
// [kQpc][qw + 16] (qw: a query row's bytes), then n_q Group slots, then the
// mbarriers (full and empty a stage, full and empty a query slot).
int smem_bytes(int qw, int n_slots, int n_q) {
  return n_slots * kStageBytes +
         n_q * (kQpc * (qw + 16) + static_cast<int>(sizeof(Group))) +
         (2 * n_slots + 2 * n_q) * 8;
}

template <int kFold, bool kPack>
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
                  unsigned long long* __restrict__ counts,
                  float* __restrict__ out,
                  int n_tasks, int dim, int span, int n_slots, int n_q) {
  extern __shared__ __align__(16) unsigned char smem[];
  // A query row's bytes, nibble-packed or not, and its stride in the tile.
  const int qw = kPack ? dim >> 1 : dim;
  const int lda = qw + 16;
  const int q_bytes = kQpc * lda;
  unsigned char* ring = smem;
  unsigned char* qbuf = ring + n_slots * kStageBytes;
  Group* groups = reinterpret_cast<Group*>(qbuf + n_q * q_bytes);
  const unsigned bars = smem_u32(groups + n_q);
  // mbarrier addresses: 8 bytes each.
  auto full = [&](int i) { return bars + 8 * i; };
  auto empty = [&](int i) { return bars + 8 * (n_slots + i); };
  auto q_full = [&](int i) { return bars + 8 * (2 * n_slots + i); };
  auto q_empty = [&](int i) { return bars + 8 * (2 * n_slots + n_q + i); };

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_chunks = (dim + kChunk - 1) / kChunk;

  if (tid == 0) {
    for (int i = 0; i < n_slots; ++i) {
      mbar_init(full(i), 32);  // each producer lane's cp.async arrival
      mbar_init(empty(i), kConsumerWarps);
    }
    for (int i = 0; i < n_q; ++i) {
      mbar_init(q_full(i), 64);  // two arrivals a producer lane
      mbar_init(q_empty(i), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // The producer. Slot parities start at 0; a fresh empty barrier passes
    // a wait for parity 1 at once. qs is the query slot whose group the
    // ring streams, qp the next one to publish into; `ahead` counts the
    // groups published and not yet streamed.
    int slot = 0, qs = 0, qp = 0, prev_qs = -1, ahead = 0;
    unsigned phase = 0, qs_phase = 0, qp_phase = 0, prev_qs_phase = 0;
    bool ended = false;  // the end of the groups is published
    unsigned long long n_run = 0, n_prefetched = 0;
    // The next group's descriptor in registers: this lane's task, its
    // scalars and the window, by a chain of four dependent steps (the
    // counter; group_first; order; starts, sizes and scal). One step is
    // taken a ring stage while a group streams, and each step only issues
    // loads that a later step reads, so their latency passes while the
    // producer waits for free stages instead of stalling it.
    // group_first[g] == n_tasks past the last group (and at g == n_tasks).
    int step = 0, g = 0, f0 = n_tasks, f1 = n_tasks, t = -1, st = 0, sz = 0;
    float4 sc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto fetch_step = [&] {
      if (step == 0) {
        if (lane == 0) g = atomicAdd(next_group, 1);
      } else if (step == 1) {
        g = __shfl_sync(~0u, g, 0);
        f0 = f1 = n_tasks;
        if (g < n_tasks) {
          f0 = group_first[g];
          f1 = group_first[g + 1];
        }
      } else if (step == 2) {
        // 1..kQpc tasks with one key, or none.
        const int n = f0 < n_tasks ? f1 - f0 : 0;
        t = lane < n ? static_cast<int>(order[f0 + lane]) : -1;
      } else if (step == 3) {
        const int lead = __shfl_sync(~0u, t, 0);
        if (lead >= 0) {
          st = starts[lead];
          sz = sizes[lead];
        }
        if (t >= 0) sc = scal[t];
      }
      ++step;
    };
    // Publishes the fetched group in query slot qp (free): its descriptor,
    // and its query tile, count x qw / 16 pieces by cp.async, consecutive
    // lanes on consecutive pieces of a row; then starts the next fetch.
    auto publish = [&] {
      while (step < 4) fetch_step();
      const int count = f0 < n_tasks ? f1 - f0 : 0;
      const int size = count > 0 ? max(0, min(sz, span)) : 0;
      const int n_stages = ((size + kRows - 1) / kRows) * n_chunks;
      Group& grp = groups[qp];
      unsigned char* s_q = qbuf + qp * q_bytes;
      grp.task[lane] = t;
      if (t >= 0) {
        grp.scal[lane] = sc;
        grp.sqrt_ycd[lane] = __fsqrt_rn(sc.w);
      }
      if (lane == 0) {
        grp.start = st;
        grp.size = size;
        grp.count = count;
        grp.n_stages = n_stages;
      }
      if (n_stages > 0) {
        const int pieces = qw >> 4;
        for (int p0 = 0; p0 < count * pieces; p0 += 32) {
          const int p = p0 + lane;
          const int r = p / pieces;
          const int tr = __shfl_sync(~0u, t, r & 31);
          if (r < count)
            cp_async16(smem_u32(s_q + r * lda + (p - r * pieces) * 16),
                       qvals + (size_t)tr * qw + (p - r * pieces) * 16);
        }
      }
      // Two arrivals a lane: the descriptor's stores (a release), and its
      // query pieces once they land.
      mbar_arrive(q_full(qp));
      mbar_arrive_cp_async(q_full(qp));
      __syncwarp();  // lane 0's stores, for the other lanes' reads
      ended = count == 0;
      ++ahead;
      if (++qp == n_q) {
        qp = 0;
        qp_phase ^= 1;
      }
      step = 0;
    };
    for (;;) {
      if (ahead == 0) {
        mbar_wait(q_empty(qp), qp_phase ^ 1);
        publish();
      }
      const Group& grp = groups[qs];
      const int count = grp.count;
      const int start = grp.start;
      const int size = grp.size;
      const int n_stages = grp.n_stages;
      --ahead;
      if (count == 0) break;
      ++n_run;
      // Whether the consumers still hold the block's previous group.
      auto overlapped = [&] {
        return prev_qs >= 0 && !mbar_done(q_empty(prev_qs), prev_qs_phase);
      };
      if (n_stages == 0) n_prefetched += overlapped();

      // The window, stage s into the ring slot after stage s - 1's; after
      // each, a step of the next group's descriptor, or its publication
      // once its query slot is free.
      for (int s = 0; s < n_stages; ++s) {
        const int tile = s / n_chunks;
        const int chunk = s - tile * n_chunks;
        const int k0 = chunk * kChunk;
        const int cb = min(kChunk, dim - k0);
        const int row0 = tile * kRows;
        const int valid = min(kRows, size - row0);
        const bool last = chunk == n_chunks - 1;
        unsigned char* buf = ring + slot * kStageBytes;
        mbar_wait(empty(slot), phase ^ 1);
        // Lane l loads 16-byte piece l % 8 of rows l / 8, l / 8 + 4, ...:
        // four whole 128-byte row chunks an instruction.
        const int8_t* src = codes + (size_t)(start + row0) * dim + k0;
        const int pc = lane & 7;
        if (pc < cb >> 4)
          for (int r = lane >> 3; r < valid; r += 4)
            cp_async16(smem_u32(buf + r * kLdb + pc * 16),
                       src + (size_t)r * dim + pc * 16);
        if (last) {
          for (int r = lane; r < valid; r += 32) {
            cp_async16(smem_u32(buf + kRows * kLdb + r * 16),
                       factors + start + row0 + r);
            if (penalty != nullptr)
              cp_async4(smem_u32(buf + kRows * (kLdb + 16) + r * 4),
                        penalty + start + row0 + r);
          }
        }
        mbar_arrive_cp_async(full(slot));
        if (s == 0) n_prefetched += overlapped();
        if (!ended) {
          if (step < 4)
            fetch_step();
          else if (mbar_done(q_empty(qp), qp_phase ^ 1))
            publish();
        }
        if (++slot == n_slots) {
          slot = 0;
          phase ^= 1;
        }
      }
      prev_qs = qs;
      prev_qs_phase = qs_phase;
      if (++qs == n_q) {
        qs = 0;
        qs_phase ^= 1;
      }
    }
    if (lane == 0) {
      atomicAdd(counts, n_run);
      atomicAdd(counts + 1, n_prefetched);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // The consumers.
  const float inf = __int_as_float(0x7f800000);
  // Folded: the window slot's bits, and per (mt, h, nt, e) the running
  // best (b1) and second best (b2) packed value of that thread's bucket.
  const int slot_mask = (1 << max(1, 32 - __clz(span - 1))) - 1;
  constexpr int kOutW = kFold * kRows;
  float b1[2][2][2][2], b2[2][2][2][2];
  int slot = 0, qb = 0;
  unsigned phase = 0, q_phase = 0;
  for (;;) {
    mbar_wait(q_full(qb), q_phase);
    const Group& grp = groups[qb];
    const int count = grp.count;
    if (count == 0) break;
    const int size = grp.size;
    const int n_stages = grp.n_stages;
    const unsigned char* s_q = qbuf + qb * q_bytes;
    if constexpr (kFold > 0) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        (&b1[0][0][0][0])[i] = inf;
        (&b2[0][0][0][0])[i] = inf;
      }
    }

    const bool two_m = count > 16;
    int acc[2][2][4];
    for (int s = 0; s < n_stages; ++s) {
      const int tile = s / n_chunks;
      const int chunk = s - tile * n_chunks;
      const int k0 = chunk * kChunk;
      const unsigned char* buf = ring + slot * kStageBytes;
      mbar_wait(full(slot), phase);
      __syncwarp();
      if (chunk == 0) {
#pragma unroll
        for (int i = 0; i < 16; ++i) (&acc[0][0][0])[i] = 0;
      }
      // ldmatrix x4 addresses: lane l feeds row (l & 7) of matrix l >> 3.
      // A: matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31) -> a0..a3.
      // B: matrices (n-tile 0 | 1) x (k 0-15 | 16-31) -> b0..b3.
      // Packed, dims k0.. are the low nibbles of bytes k0.. below D/2 and
      // the high nibbles of bytes k0 - D/2.. above: a chunk never
      // straddles D/2 (D % 256 == 0).
      const bool hi = kPack && k0 >= qw;
      const unsigned a_addr =
          smem_u32(s_q + (((lane >> 3) & 1) * 8 + (lane & 7)) * lda +
                   (hi ? k0 - qw : k0) + (lane >> 4) * 16);
      const unsigned a_shift = hi ? 4 : 0;
      const unsigned b_addr =
          smem_u32(buf + (warp * 16 + (lane >> 4) * 8 + (lane & 7)) * kLdb +
                   ((lane >> 3) & 1) * 16);
      const int ksteps = min(kChunk, dim - k0) >> 5;
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a[4], b[4];
        ldmatrix_x4(b_addr + ks * 32, b);
        ldmatrix_x4(a_addr + ks * 32, a);
        if constexpr (kPack) widen(a, a_shift);
        mma_s8(acc[0][0], a, b[0], b[1]);
        mma_s8(acc[0][1], a, b[2], b[3]);
        if (two_m) {
          ldmatrix_x4(a_addr + 16 * lda + ks * 32, a);
          if constexpr (kPack) widen(a, a_shift);
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
            const float4 sc = grp.scal[m];
            const float sq = grp.sqrt_ycd[m];
            float* out_t = out + (size_t)grp.task[m] * span;  // unfolded
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
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(slot));
      if (++slot == n_slots) {
        slot = 0;
        phase ^= 1;
      }
    }

    if constexpr (kFold == 0) {
      const int pad = span - size;
      for (int p = tid; p < count * pad; p += kConsumers) {
        const int i = p / pad;
        out[(size_t)grp.task[i] * span + size + (p - i * pad)] = inf;
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + h * 8 + (lane >> 2);
          if (m >= count) continue;
          float* out_t = out + (size_t)grp.task[m] * kOutW;
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
    __syncwarp();
    if (lane == 0) mbar_arrive(q_empty(qb));
    if (++qb == n_q) {
      qb = 0;
      q_phase ^= 1;
    }
  }
}

// The launch plan of one query row width: the ring's stages, the query
// slots, the blocks an SM and the shared memory of a block. Two blocks an
// SM where each keeps kMinSlots stages, else one with up to kMaxSlots;
// one query slot only where two do not fit a block.
struct Plan {
  int slots, qbufs, per_sm, smem;
};

Plan plan_for(int qw, int sm_smem, int block_smem, int reserved) {
  for (int qbufs = kQbufs; qbufs >= 1; --qbufs) {
    for (int per_sm = 2; per_sm >= 1; --per_sm) {
      const int budget = std::min(block_smem, sm_smem / per_sm - reserved);
      int slots = kMaxSlots;
      while (slots > 0 && smem_bytes(qw, slots, qbufs) > budget) --slots;
      if (slots >= (per_sm == 2 ? kMinSlots : 2))
        return {slots, qbufs, per_sm, smem_bytes(qw, slots, qbufs)};
    }
  }
  return {0, 0, 0, 0};
}

// The launch of one depth's kernel. The attribute and occupancy queries
// cost host time every batch, so the plan and the resident-block count are
// kept per (device, query row width) for the process, per instance (each
// is a function of its own). The shared-memory maximum is a per-device
// attribute of the function: it only ever grows, so a launch never finds
// it below its own size.
template <int kFold, bool kPack>
int launch_scan(const void* codes, const void* factors, const void* starts,
                const void* sizes, const void* qvals, const void* scal,
                const void* penalty, const void* order,
                const void* group_first, void* next_group, void* counts,
                void* out, int n_tasks, int dim, int span,
                cudaStream_t stream) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  static std::mutex mu;
  static std::map<std::pair<int, int>, std::pair<Plan, int>> plan_of;
  const int qw = kPack ? dim / 2 : dim;
  static std::map<int, int> smem_set;
  Plan plan;
  int resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = plan_of.find({device, qw});
    if (it != plan_of.end()) {
      plan = it->second.first;
      resident = it->second.second;
    } else {
      int sms = 0, sm_smem = 0, block_smem = 0, reserved = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
               device)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &block_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
               device)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(
               &reserved, cudaDevAttrReservedSharedMemoryPerBlock,
               device)) != cudaSuccess)
        return static_cast<int>(err);
      plan = plan_for(qw, sm_smem, block_smem, reserved);
      if (plan.slots == 0)
        return static_cast<int>(cudaErrorInvalidConfiguration);
      int& set = smem_set[device];
      if (plan.smem > set) {
        err = cudaFuncSetAttribute(rough_scan_kernel<kFold, kPack>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   plan.smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        set = plan.smem;
      }
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, rough_scan_kernel<kFold, kPack>, kThreads, plan.smem)) !=
          cudaSuccess)
        return static_cast<int>(err);
      if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
      resident = std::min(per_sm, plan.per_sm) * sms;
      plan_of[{device, qw}] = {plan, resident};
    }
  }
  const int grid = n_tasks < resident ? n_tasks : resident;
  rough_scan_kernel<kFold, kPack><<<grid, kThreads, plan.smem, stream>>>(
      static_cast<const int8_t*>(codes), static_cast<const float4*>(factors),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(sizes),
      static_cast<const int8_t*>(qvals), static_cast<const float4*>(scal),
      static_cast<const float*>(penalty), static_cast<const int64_t*>(order),
      static_cast<const int32_t*>(group_first),
      static_cast<int32_t*>(next_group),
      static_cast<unsigned long long*>(counts), static_cast<float*>(out),
      n_tasks, dim, span, plan.slots, plan.qbufs);
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
// counts is two int64 the kernel adds to: the groups run, and those of them
// loaded while the block's previous group was still being worked on.
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
                                 void* counts, void* out, int n_tasks,
                                 int dim, int span, int fold, int qpack,
                                 void* stream) {
  if (n_tasks <= 0) return 0;
  auto* st = static_cast<cudaStream_t>(stream);
  switch (fold * 2 + (qpack != 0)) {
#define RABITQ_SCAN_CASE(F, P)                                              \
  case F * 2 + P:                                                           \
    return launch_scan<F, P>(codes, factors, starts, sizes, qvals, scal,    \
                             penalty, order, group_first, next_group,       \
                             counts, out, n_tasks, dim, span, st);
    RABITQ_SCAN_CASE(0, false)
    RABITQ_SCAN_CASE(0, true)
    RABITQ_SCAN_CASE(1, false)
    RABITQ_SCAN_CASE(1, true)
    RABITQ_SCAN_CASE(2, false)
    RABITQ_SCAN_CASE(2, true)
#undef RABITQ_SCAN_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
