// Fused query-residual quantization for Hopper (sm_90a).
//
// The search stage before the rough scan: the JAX package computes it as
// one XLA fusion (rabitq_tpu/index/search.py:335-379 and 392-407 with
// rabitq_tpu/ops/quantize.py:quantize_query_residuals, and the nibble
// packing of the scan's qpack operand at :403-407); it is not a Pallas
// kernel.
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
// What bounds it on this card. Its HBM bytes (y, each distinct probed
// centroid row, cids, the outputs once: ~64 MB at gist p80, B 1024, probe
// 80, D 1024, packed; 0.019 ms at 3.35 TB/s) are far from what sets its
// pace: every task must bring its own centroid row into an SM (335 MB
// through L2 at gist p80; random queries share few centroids), and each
// value costs instructions: with an IEEE division and float-to-int
// conversions (quarter-rate on this card) about 25, three of them
// quarter-rate.
//
// Design (the register path, D <= 1024 in whole 16-byte output words):
//   - Lane groups of G lanes a task: G = 32 (a warp), or 8 at D <= 256 so
//     that a warp works on four rows at once and reduces in three shuffle
//     steps. The grid holds as many blocks as fit the card at once; each
//     group takes an equal run of consecutive tasks (one query's, or the
//     end of one and the start of the next), so no wave is left half full.
//   - A group holds its lanes' slice of y[b] in registers across the run's
//     tasks of query b, and the dither across the whole run: y is read
//     once or twice a group, not once a task. r never leaves registers.
//   - Centroid rows stream through a register double buffer: a group loads
//     the next task's row into registers while it reduces and quantizes the
//     current one. (A ring of shared-memory rows filled by 1-D bulk copies,
//     cp.async.bulk on an mbarrier, was no faster without the dither, the
//     setting search runs: rabitq_tpu_torch/tools/quantize_ab.py.)
//   - Each lane owns whole 16-byte output words: unit u is output bytes
//     16u .. 16u + 15, i.e. dims 16u .. 16u + 15 (and D/2 + 16u .. with
//     pack), and loads y, the dither and the centroid row in the same map.
//   - No division and no conversion a value (qfast): one fused
//     multiply-add with the task's rounded 1/delta, and the rounding done
//     by an add of 1.5 * 2^23, whose result's low byte is the value; bytes
//     are gathered by byte_perm and summed by dp4a. A task with a value
//     within 2^-16 of a rounding edge (a few in a hundred at D 1024) is
//     quantized again by the exact rule, so the output stays bit-equal.
// Other shapes (D > 1024, or rows that are not whole 16-byte words: D % 16
// != 0, or D % 32 != 0 packed) take the shared-memory path: one warp a
// task, r kept in shared memory, the exact rule, 4-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kMaxSlots = 8;      // float4 of r a lane holds (32 f32)
constexpr int kWarps = 4;         // warps a block on the register path
constexpr int kSmemWarps = 4;     // tasks a block on the shared-memory path

__device__ __forceinline__ float quant(float v, float lo, float delta,
                                       float bias, bool dither, float qmax) {
  float s = __fdiv_rn(__fsub_rn(v, lo), delta);
  s = dither ? floorf(__fadd_rn(s, bias)) : rintf(s);
  return fminf(fmaxf(s, 0.0f), qmax);
}

// q of the four values of v as four bytes (v.x lowest), added to sum.
__device__ __forceinline__ uint32_t quant4(float4 v, float lo, float delta,
                                           float4 b, bool dither, float qmax,
                                           int& sum) {
  const int q0 = static_cast<int>(quant(v.x, lo, delta, b.x, dither, qmax));
  const int q1 = static_cast<int>(quant(v.y, lo, delta, b.y, dither, qmax));
  const int q2 = static_cast<int>(quant(v.z, lo, delta, b.z, dither, qmax));
  const int q3 = static_cast<int>(quant(v.w, lo, delta, b.w, dither, qmax));
  sum += q0 + q1 + q2 + q3;
  return static_cast<uint32_t>(q0) | (static_cast<uint32_t>(q1) << 8) |
         (static_cast<uint32_t>(q2) << 16) | (static_cast<uint32_t>(q3) << 24);
}

__device__ __forceinline__ float4 sub4(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

// The register path's quantization of one value, without a division:
// z = clamp(v * rcp + c0 [+ bias - 1/2], 0, qmax) with rcp = 1/delta and
// c0 = -lo * rcp rounded, and rint(z) read from the low mantissa bits of
// z + 1.5 * 2^23 (an f32 add rounds half to even at that magnitude). While
// |c0| < 16 (lo within 16 steps of 0: always when lo <= 0 <= hi), z lies
// within 10 * 2^-20 of the value the exact rule rounds, (v - lo) / delta
// rounded once (and its sum with the dither rounded once, less 1/2 with
// the dither). The two round alike unless z lies that close to a rounding
// edge (a half-integer): `dmax` collects |z - rint z|, and a task with a
// value within 2^-16 of an edge is quantized again by the exact rule.
constexpr float kRoundBits = 12582912.0f;    // 1.5 * 2^23
constexpr float kEdge = 0.5f - 0x1p-16f;     // |z - rint z| beyond: near
constexpr float kFastMin = 0x1p-100f;        // delta in [min, max):
constexpr float kFastMax = 0x1p100f;         //   rcp is normal
constexpr float kFastC0 = 16.0f;             // |c0| below

__device__ __forceinline__ uint32_t qfast(float v, float rcp, float c0,
                                          float bh, bool dither, float qmax,
                                          float& dmax) {
  float z = fmaf(v, rcp, c0);
  if (dither) z = __fadd_rn(z, bh);
  z = fminf(fmaxf(z, 0.0f), qmax);
  const float t = __fadd_rn(z, kRoundBits);
  dmax = fmaxf(dmax, fabsf(__fsub_rn(z, __fsub_rn(t, kRoundBits))));
  return __float_as_uint(t);  // rint(z) in the low byte
}

// A lane's slots of one row (slot s: float4 off[s], if its unit is live).
template <int NS, int PER_UNIT>
__device__ __forceinline__ void load_slots(float4 (&dst)[NS],
                                           const float* row,
                                           const int (&off)[NS],
                                           const bool (&live)[NS / PER_UNIT]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    if (live[s / PER_UNIT]) dst[s] = __ldg(r4 + off[s]);
}

// Bytes 0 of a, b, c, d as one word (a lowest).
__device__ __forceinline__ uint32_t low_bytes(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ uint32_t quant4_fast(float4 v, float rcp, float c0,
                                                float4 bh, bool dither,
                                                float qmax, float& dmax) {
  return low_bytes(qfast(v.x, rcp, c0, bh.x, dither, qmax, dmax),
                   qfast(v.y, rcp, c0, bh.y, dither, qmax, dmax),
                   qfast(v.z, rcp, c0, bh.z, dither, qmax, dmax),
                   qfast(v.w, rcp, c0, bh.w, dither, qmax, dmax));
}

// The register path. G lanes a task, NU 16-byte output units a lane
// (unit u: float4 4u .. 4u + 3 of r, and with PACK also float4
// D/8 + 4u .. of the high half). Requires the row to be whole units
// (4 * units * (PACK ? 2 : 1) float4 = D / 4) and NU * 4 * (PACK ? 2 : 1)
// <= kMaxSlots. Lane group `gid` (of gridDim.x * groups) takes tasks
// [gid * run, (gid + 1) * run): a run spans one query or a few, and the
// group loads y[b] when b changes. The next task's centroid row is loaded
// into registers while the current one is reduced and quantized.
template <int G, int NU, bool PACK, bool DITHER>
__global__ void __launch_bounds__(kWarps * 32)
quantize_kernel(const float* __restrict__ y,
                const float* __restrict__ centroids,
                const int64_t* __restrict__ cids,
                const float* __restrict__ rand_bias,
                int8_t* __restrict__ qvals, float4* __restrict__ scal,
                int n_tasks, int probe, int dim, int run, float scalar,
                float tiny, float qmax) {
  constexpr int P = PACK ? 2 : 1;   // float4 of r a word takes
  constexpr int NS = NU * 4 * P;    // float4 slots a lane
  static_assert(NS <= kMaxSlots, "too many slots a lane");

  constexpr int groups = kWarps * 32 / G;
  const int g = threadIdx.x / G;
  const int gl = threadIdx.x % G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu
              : ((1u << (G & 31)) - 1) << (threadIdx.x & 31 & ~(G - 1));
  const int t0 = (blockIdx.x * groups + g) * run;
  const int n_mine = min(run, n_tasks - t0);
  if (n_mine <= 0) return;

  // This lane's slots: slot k of unit n is float4 `off[n*4P + k]` of the
  // row (k < 4: the unit's four low float4, k >= 4: the four high ones).
  const int units = dim / (16 * P);
  int off[NS];
  bool live[NU];
#pragma unroll
  for (int n = 0; n < NU; ++n) {
    const int u = gl + G * n;
    live[n] = u < units;
#pragma unroll
    for (int k = 0; k < 4 * P; ++k)
      off[n * 4 * P + k] = (k < 4 ? 0 : dim / 8) + 4 * u + (k & 3);
  }
  const float4* b4 = reinterpret_cast<const float4*>(rand_bias);
  float4 yv[NS], bh[NS];  // y[b]; the dither less 1/2
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    bh[s] = make_float4(0, 0, 0, 0);
    if (DITHER && live[s / (4 * P)]) {
      const float4 b = __ldg(b4 + off[s]);
      bh[s] = make_float4(__fsub_rn(b.x, 0.5f), __fsub_rn(b.y, 0.5f),
                          __fsub_rn(b.z, 0.5f), __fsub_rn(b.w, 0.5f));
    }
  }
  int cur_b = -1;
  float4 cn[NS];  // the next task's centroid slots
  load_slots<NS, 4 * P>(cn, centroids + cids[t0] * dim, off, live);

  for (int i = 0; i < n_mine; ++i) {
    const int t = t0 + i;
    const int b = t / probe;
    if (b != cur_b) {  // uniform across the group
      const float4* y4 =
          reinterpret_cast<const float4*>(y + static_cast<size_t>(b) * dim);
#pragma unroll
      for (int s = 0; s < NS; ++s)
        yv[s] = live[s / (4 * P)] ? __ldg(y4 + off[s]) : make_float4(0, 0, 0, 0);
      cur_b = b;
    }
    float4 r[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      if (live[s / (4 * P)]) r[s] = sub4(yv[s], cn[s]);
    if (i + 1 < n_mine)
      load_slots<NS, 4 * P>(cn, centroids + cids[t + 1] * dim, off, live);

    float lo = __int_as_float(0x7f800000), hi = -lo, ss = 0.0f, ss2 = 0.0f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!live[s / (4 * P)]) continue;
      const float4 v = r[s];
      lo = fminf(lo, fminf(fminf(v.x, v.y), fminf(v.z, v.w)));
      hi = fmaxf(hi, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      ss = fmaf(v.x, v.x, fmaf(v.y, v.y, ss));
      ss2 = fmaf(v.z, v.z, fmaf(v.w, v.w, ss2));
    }
    ss = __fadd_rn(ss, ss2);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(gmask, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(gmask, hi, o));
      ss = __fadd_rn(ss, __shfl_xor_sync(gmask, ss, o));
    }
    const float delta = fmaxf(__fmul_rn(__fsub_rn(hi, lo), scalar), tiny);
    const float rcp = __frcp_rn(delta);
    const float c0 = __fmul_rn(-lo, rcp);
    // An edge beyond 0.5 forces the exact rule where the fast one's error
    // bound does not hold.
    float dmax = delta >= kFastMin && delta < kFastMax && fabsf(c0) < kFastC0
                     ? 0.0f : 1.0f;

    // Word k of unit n: slot k's four values (with PACK, slot k + 4's in
    // the high nibbles); its code sum by dp4a over the byte lanes.
    uint32_t w[NU][4];
    int sum = 0;
#pragma unroll
    for (int n = 0; n < NU; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = n * 4 * P + k;
        w[n][k] = 0;
        if (!live[n]) continue;
        w[n][k] = quant4_fast(r[s], rcp, c0, bh[s], DITHER, qmax, dmax);
        sum = __dp4a(static_cast<int>(w[n][k]), 0x01010101, sum);
        if (PACK) {
          const uint32_t hi4 =
              quant4_fast(r[s + 4], rcp, c0, bh[s + 4], DITHER, qmax, dmax);
          sum = __dp4a(static_cast<int>(hi4), 0x01010101, sum);
          w[n][k] += hi4 << 4;
        }
      }
    if (__any_sync(gmask, dmax > kEdge)) {  // rare: the exact rule
      sum = 0;
#pragma unroll
      for (int n = 0; n < NU; ++n)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int s = n * 4 * P + k;
          if (!live[n]) continue;
          w[n][k] = quant4(r[s], lo, delta,
                           DITHER ? __ldg(b4 + off[s]) : make_float4(0, 0, 0, 0),
                           DITHER, qmax, sum);
          if (PACK)
            w[n][k] |= quant4(r[s + 4], lo, delta,
                              DITHER ? __ldg(b4 + off[s + 4])
                                     : make_float4(0, 0, 0, 0),
                              DITHER, qmax, sum)
                       << 4;
        }
    }

    uint4* out =
        reinterpret_cast<uint4*>(qvals + static_cast<size_t>(t) * dim / P);
#pragma unroll
    for (int n = 0; n < NU; ++n)
      if (live[n]) out[gl + G * n] = make_uint4(w[n][0], w[n][1], w[n][2],
                                                w[n][3]);
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(gmask, sum, o);
    if (gl == 0) scal[t] = make_float4(lo, delta, __int2float_rn(sum), ss);
  }
}

// The shared-memory path: one warp a task, four tasks a block; the warp
// reads its query row and centroid row (16 bytes a lane, coalesced),
// keeps r in shared memory, reduces across the warp with shuffles, then
// quantizes from shared memory and writes 4 output bytes a lane at a time.
__global__ void __launch_bounds__(kSmemWarps * 32)
quantize_kernel_smem(const float* __restrict__ y,
                     const float* __restrict__ centroids,
                     const int64_t* __restrict__ cids,
                     const float* __restrict__ rand_bias,
                     int8_t* __restrict__ qvals, float4* __restrict__ scal,
                     int n_tasks, int probe, int dim, int pack, float scalar,
                     float tiny, float qmax) {
  extern __shared__ __align__(16) float smem_f[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kSmemWarps + warp;
  if (t >= n_tasks) return;  // no block-wide barrier follows
  float4* r = reinterpret_cast<float4*>(smem_f + warp * dim);
  const int n4 = dim >> 2;
  const float4* yr =
      reinterpret_cast<const float4*>(y + (size_t)(t / probe) * dim);
  const float4* cr =
      reinterpret_cast<const float4*>(centroids + (size_t)cids[t] * dim);
  const float4* b4 = reinterpret_cast<const float4*>(rand_bias);
  const bool dither = rand_bias != nullptr;
  const float4 zero = make_float4(0, 0, 0, 0);

  float lo = __int_as_float(0x7f800000), hi = -lo, ss = 0.0f;
  for (int c = lane; c < n4; c += 32) {
    const float4 v = sub4(yr[c], cr[c]);
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
    const int half4 = dim >> 3;
    uint32_t* out = reinterpret_cast<uint32_t*>(qvals + (size_t)t * (dim >> 1));
    for (int c = lane; c < half4; c += 32) {
      const uint32_t ql = quant4(r[c], lo, delta, dither ? b4[c] : zero,
                                 dither, qmax, sum);
      const uint32_t qh =
          quant4(r[c + half4], lo, delta, dither ? b4[c + half4] : zero,
                 dither, qmax, sum);
      out[c] = ql | (qh << 4);
    }
  } else {
    uint32_t* out = reinterpret_cast<uint32_t*>(qvals + (size_t)t * dim);
    for (int c = lane; c < n4; c += 32)
      out[c] = quant4(r[c], lo, delta, dither ? b4[c] : zero, dither, qmax,
                      sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) scal[t] = make_float4(lo, delta, __int2float_rn(sum), ss);
}

// The launch plan of a call: lanes a task (0: the shared-memory path),
// warps a block, 16-byte output units a lane, blocks, and the run of
// consecutive tasks each lane group takes.
struct Plan {
  int lanes, warps, units, blocks, run;
};

using RegKernel = void (*)(const float*, const float*, const int64_t*,
                           const float*, int8_t*, float4*, int, int, int,
                           int, float, float, float);

template <int G, int NU, bool PACK>
RegKernel pick_dither(bool dither) {
  return dither ? quantize_kernel<G, NU, PACK, true>
                : quantize_kernel<G, NU, PACK, false>;
}

RegKernel pick(const Plan& plan, bool pack, bool dither) {
  if (plan.lanes == 8) {
    if (pack) return pick_dither<8, 1, true>(dither);
    return plan.units == 1 ? pick_dither<8, 1, false>(dither)
                           : pick_dither<8, 2, false>(dither);
  }
  if (pack) return pick_dither<32, 1, true>(dither);
  return plan.units == 1 ? pick_dither<32, 1, false>(dither)
                         : pick_dither<32, 2, false>(dither);
}

// The blocks of `kernel` the current device holds at once (blocks an SM
// times SMs): asked of the occupancy API once per kernel and device, so a
// launch makes no query.
cudaError_t resident_blocks(RegKernel kernel, int* most) {
  static std::mutex mu;
  static std::map<std::pair<RegKernel, int>, int> known;
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const std::pair<RegKernel, int> key{kernel, device};
  {
    const std::lock_guard<std::mutex> lock(mu);
    const auto it = known.find(key);
    if (it != known.end()) {
      *most = it->second;
      return cudaSuccess;
    }
  }
  int sms, per_sm;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWarps * 32, 0);
  if (err != cudaSuccess) return err;
  *most = (per_sm > 0 ? per_sm : 1) * sms;
  const std::lock_guard<std::mutex> lock(mu);
  known[key] = *most;
  return cudaSuccess;
}

// Lanes: 8 where a row fits 8 lanes in kMaxSlots float4 each (D <= 256),
// else 32 (D <= 1024). Blocks: as many as fit the card at once, or fewer
// when there are fewer tasks than lane groups; each group then takes an
// equal run of consecutive tasks, so no wave of blocks is left half full.
cudaError_t plan_for(int n_tasks, int dim, int pack, bool dither,
                     Plan* plan) {
  const int p = pack ? 2 : 1;
  *plan = Plan{0, kSmemWarps, 0, (n_tasks + kSmemWarps - 1) / kSmemWarps, 1};
  if (dim % (16 * p)) return cudaSuccess;  // rows are not whole 16-byte units
  const int units = dim / (16 * p);
  const int options[2] = {8, 32};
  for (int lanes : options) {
    const int nu = (units + lanes - 1) / lanes;
    if (nu * 4 * p > kMaxSlots) continue;
    Plan reg{lanes, kWarps, nu, 0, 0};
    int most;
    const cudaError_t err =
        resident_blocks(pick(reg, pack != 0, dither), &most);
    if (err != cudaSuccess) return err;
    const int groups = kWarps * 32 / lanes;
    const int needed = (n_tasks + groups - 1) / groups;
    reg.blocks = needed < most ? needed : most;
    reg.run = (n_tasks + reg.blocks * groups - 1) / (reg.blocks * groups);
    *plan = reg;
    return cudaSuccess;
  }
  return cudaSuccess;
}

}  // namespace

// The plan the launcher takes for (n_tasks, dim, pack, dither) on the
// current device, written to out[0..4]: lanes a task (8 or 32; 0 = the
// shared-memory path), warps a block, 16-byte output units a lane,
// blocks, and tasks a lane group. Returns a CUDA error code.
extern "C" int rabitq_quantize_plan(int n_tasks, int dim, int pack,
                                    int dither, int* out) {
  Plan plan;
  const cudaError_t err = plan_for(n_tasks, dim, pack, dither != 0, &plan);
  out[0] = plan.lanes;
  out[1] = plan.warps;
  out[2] = plan.units;
  out[3] = plan.blocks;
  out[4] = plan.run;
  return static_cast<int>(err);
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* yf = static_cast<const float*>(y);
  const float* cf = static_cast<const float*>(centroids);
  const int64_t* ci = static_cast<const int64_t*>(cids);
  const float* bf = static_cast<const float*>(rand_bias);
  int8_t* qv = static_cast<int8_t*>(qvals);
  float4* sc = static_cast<float4*>(scal);
  Plan plan;
  cudaError_t err = plan_for(n_tasks, dim, pack, bf != nullptr, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (plan.lanes == 0) {
    const int smem = kSmemWarps * dim * static_cast<int>(sizeof(float));
    // Above the 48 KB default (D > 3072) the function needs the larger
    // dynamic shared-memory maximum set on the current device.
    if (smem > (48 << 10)) {
      err = cudaFuncSetAttribute(quantize_kernel_smem,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    quantize_kernel_smem<<<plan.blocks, kSmemWarps * 32, smem, s>>>(
        yf, cf, ci, bf, qv, sc, n_tasks, probe, dim, pack, scalar, tiny,
        qmax);
    return static_cast<int>(cudaGetLastError());
  }
  const RegKernel kernel = pick(plan, pack != 0, bf != nullptr);
  kernel<<<plan.blocks, plan.warps * 32, 0, s>>>(yf, cf, ci, bf, qv, sc,
                                                 n_tasks, probe, dim,
                                                 plan.run, scalar, tiny, qmax);
  return static_cast<int>(cudaGetLastError());
}
