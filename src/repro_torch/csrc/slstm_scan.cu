// The sLSTM recurrence of xLSTM (arXiv:2405.04517) over T steps:
//
//   rec   = einsum("bhd,hde->bhe", h.reshape(B, H, Dh), r).reshape(B, 4D)
//   pre   = pre_x_t + rec;   i, f, z, o = split(pre, 4)   (D units each)
//   m'    = max(f + m, i)
//   c'    = exp(f + m - m') c + exp(i - m') tanh(z)
//   n'    = exp(f + m - m') n + exp(i - m')
//   h'    = sigmoid(o) c' / max(n', 1e-6)
//
// pre_x (B, T, 4D) in the compute type (float32 or bfloat16), r (H, Dh,
// 4Dh) and the state c, n, h, m (B, D) in float32; hs (B, T, D) float32
// and the final state, which may be written over the state it started
// from (a cache's rows).  The split is of the flat product: gate g of
// unit u is output j = g D + u, of head j / 4Dh, column j % 4Dh, so
// every unit's gates read all of h_{t-1}, not its own head's Dh.
//
// Replaces the `lax.scan` of `slstm_block` in src/repro/models/xlstm.py
// (:187, the step at :203-215, the scan at :217; a float32 scan, not a
// Pallas kernel: on the card a loop of PyTorch ops over T launches
// about 18 kernels a step), and the gradient JAX takes through it
// (slstm_bwd_kernel, below: the `cluster` layout in reverse time).  A
// forward with grad also writes each step's pre-activations and c, n
// and m, which the backward reads.
//
// Bound on an H100: the sequential chain.  A step is 2 B H Dh 4Dh
// operations (4.72 MFLOP at B 4 and xlstm-125m's D 768, H 4), which the
// card's 67 TFLOP/s of float32 would do in 0.07 us; step t + 1 cannot
// start before every unit of step t is known.  At B 4, T 2048 the
// operations bound is 0.144 ms and the byte bound (pre_x, hs, r once)
// 0.023 ms; what a step costs is the latency of one dot product, the
// gates and one exchange of h among the blocks that hold r.
//
// The first design (one 16-block cluster per 4 batch rows, r in shared
// memory, two block barriers and a cluster barrier a step) took 9.9227
// ms at B 4, T 2048, D 768 (4.845 us a step) and 0.0616 ms a decode
// call back to back (NVIDIA H100 80GB HBM3, 700.00 W).  It was held
// back by (1) 16 of 132 SMs at B 4, (2) r re-read from shared memory
// every step, (3) a serial exchange ending in a full cluster barrier,
// and (4) a decode call paying the whole set-up (147 KB of r a block
// into shared memory, a non-portable cluster) for one step.  Two
// variants replace it; the wrapper picks one from the shape
// (slstm_variant) and launches it by its code through
// slstm_scan_kernel_hd, while slstm_scan_hd applies the same rule
// (variant_for) for a caller that names none:
//
// `cluster`, for a prefill: the whole chain in one launch, for latency.
//  (1) One cluster of kCluster = 16 blocks a batch row, so at B 4 four
//      clusters on 64 SMs.  Block k owns U = ceil(D / 16) units (48 at
//      D 768) and their 4U gate columns.
//  (2) The block's slice of r (Dh x 4U floats, 147 KB at D 768) stays
//      in registers for the whole launch.  A warp takes kCols = 4
//      neighbouring units, all four gates: lane g 8 + dg holds the 4
//      columns of gate g (one head) over its d-group's 24 d, 96 floats,
//      so each h value it loads feeds 4 FMAs, and the 8 d-groups take
//      interleaved 16-byte chunks (4 (dg + 8 k)), so the 8 lanes of a
//      quarter warp read 8 chunks on distinct banks.  The 8 partial
//      sums of the 4 columns reduce by a transposing shuffle (4
//      shuffles, each lane ends with one column), and the gates of a
//      unit meet by 4 more: no block barrier in the step loop.  The
//      only shared-memory reads of a step are the h_{t-1} values.
//  (3) The exchange: each block sends its units' new h into every
//      block's next h buffer with st.async, which completes the bytes
//      that buffer's mbarrier expects (4 D a step); a warp's units are
//      neighbours, so it sends them as one 16-byte store per
//      destination block.  A block waits only on its own buffer's
//      mbarrier.  Three buffers: a block can only send h_t once every
//      unit of h_{t-1} has reached it, so every peer has finished its
//      reads of the buffer that h_t overwrites (h_{t-3}'s, read at step
//      t - 2).  Each step's pre_x is loaded two steps ahead, and the
//      hs stores go out after the sends, while the block waits.
// `step`, for short T (a decode step is T = 1), with no cluster.
//  (4) Blocks of kStepUnits units x kStepRows rows take all four gates
//      of their units: 96 blocks at D 768, B 4, 2 an SM at most, so at
//      most kStepMaxBlocks = 192 (D up to 1536 at B 4).  A thread reads
//      r straight from L2 or device memory as 16-byte loads of four
//      neighbouring units (a warp reads 32-byte runs of 4 rows of r),
//      for d = its d-group, + 32, ..., the first kStepPre into
//      registers before the block fills h_{-1}, so the two latencies
//      overlap; the 32 d-groups reduce by shuffles and shared memory,
//      and one warp does the gates and writes h.  No shared-memory fill
//      of r, no cluster.
//      The hazard: with out = state every block reads all of h_{-1},
//      and writes its units' h_T.  Each block copies the h_{-1} of its
//      rows into shared memory, then arrives at a grid barrier (a
//      count and generation in device memory, one of kBarSlots slots
//      taken in turn by the host, so launches on other streams do not
//      share one); it waits on that barrier only before writing the
//      final state, by when every block has long arrived.  A split
//      arrive / wait hides the barrier's latency, which a cooperative
//      launch's grid.sync() would put on the path; the launch is
//      still cooperative, so that the runtime refuses a grid that
//      could not be resident at once.  For T > 1 the steps meet at the
//      same kind of barrier after each step's h is written to hs.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py and
// tools/slstm_scan_variants.py, CUDA events and torch.profiler): at B
// 4, T 2048, D 768 in bf16 from a state `cluster` takes 3.0182 ms,
// 1.474 us a step, against the first design's 9.9208 in the same run.
// What bounds it is the chain, in series: the exchange alone (the
// probe: the step loop without the product and the gates) 0.81 us a
// step, the product 0.48, the gates 0.16 (probes of each cut, in
// builds that also held the layouts below).  Layouts tried, in builds
// of this file that were not kept: one cluster for 4 rows (4.8 us a
// step) or 2 (2.6), both spilling; 2 columns a lane (1.85); one column
// split over 2 lanes (3.40: one h load an FMA, the heads' h on the same
// banks); a bulk copy a peer in place of the st.asyncs (1.55); spinning
// on the mbarrier (1.45).  `step` takes 0.0056-0.0061 ms of device time
// a decode call (B 4, T 1), 7.5-8.1x its bound (r's 2.36 MB read once,
// 0.00074 ms), bound by latency: the launch, the h_{-1} fill and r's
// loads (overlapped), the reduction and the gates; `cluster` is faster
// from T 3 (kStepMaxT).
//
// Numbers: accurate expf and tanhf and IEEE division (no fast math);
// the dot products are float32 FMAs summed in another order than
// PyTorch's einsum (partial sums over lanes or d-groups).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// component k of a float4 (k known at compile time once unrolled)
__device__ __forceinline__ float component(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// one step of a unit's gates and state
__device__ __forceinline__ void gate_step(float i_, float f_, float z_,
                                          float o_, float& cs, float& ns,
                                          float& ms, float& hv) {
  const float fm = f_ + ms;
  const float m_new = fmaxf(fm, i_);
  const float ig = expf(i_ - m_new);
  const float fg = expf(fm - m_new);
  cs = fg * cs + ig * tanhf(z_);
  ns = fg * ns + ig;
  ms = m_new;
  hv = (1.0f / (1.0f + expf(-o_))) * (cs / fmaxf(ns, 1e-6f));
}

// What a forward with grad saves for the backward, per step: pre (B, T,
// 4D) = pre_x + the recurrent product, and the state c, n, m (B, T, D),
// all float32 (h is hs); every pointer null when nothing is saved
struct Saved {
  float* pre;
  float* c;
  float* n;
  float* m;
};

// Sets a kernel's launch attributes once per device (bit `dev` of
// `ready`); returns the CUDA error.
template <typename K>
cudaError_t prepare(K* kernel, std::atomic<unsigned long long>& ready,
                    cudaFuncAttribute attr, int value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit != 0 && (ready.load(std::memory_order_acquire) & bit)) return err;
  err = cudaFuncSetAttribute(kernel, attr, value);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------
// `cluster`
// ---------------------------------------------------------------------
constexpr int kCluster = 16;   // blocks a cluster: all units of its row
constexpr int kUnits = 48;     // units a block at most: D <= 768
constexpr int kMaxDh = 192;    // head width the registers hold
constexpr int kDGroups = 8;    // lanes a column: 4 gates x 8 = a warp
constexpr int kBufs = 3;       // h buffers a block
constexpr int kCols = 4;       // units a warp, columns a lane

__host__ __device__ inline int units_per_block(int D) {
  return (D + kCluster - 1) / kCluster;
}

// a head's places in an h buffer: Dh rounded up to 16-byte chunks
__host__ __device__ inline int head_stride(int Dh) { return (Dh + 3) / 4 * 4; }

// dynamic shared memory of a `cluster` block: kBufs h buffers, each H x
// head_stride(Dh) floats
__host__ __device__ inline size_t cluster_smem(int D, int H) {
  return sizeof(float) * kBufs * (size_t)H * head_stride(D / H);
}

__host__ __device__ inline int cluster_threads(int D) {
  return (units_per_block(D) + kCols - 1) / kCols * 32;
}

__host__ __device__ inline bool cluster_fits(int D, int H) {
  return units_per_block(D) <= kUnits && D / H <= kMaxDh;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// the address of the same shared variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr,
                                                uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// asynchronous stores of 4 floats or 1 into the shared memory of a block
// of the cluster, each completing its bytes of the transaction count of
// that block's mbarrier `bar` (no fence: the receiver's wait on the
// barrier sees the values)
__device__ __forceinline__ void st_async4(uint32_t addr, const float* v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v[0]), "f"(v[1]), "f"(v[2]), "f"(v[3]), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async1(uint32_t addr, float v,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], "
      "%1, [%2];\n" ::"r"(addr),
      "f"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` of a local mbarrier has
// completed.  The thread sleeps in the wait (up to the 10 ms hint).  h
// arrives within microseconds; a wait beyond 2^32 cycles (over 2 s)
// traps, so a fault ends the launch with an error, not a hang.
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity), "r"(10000000)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// Grid (kCluster, B), clusters of kCluster along x: cluster y takes
// batch row y.  Block `rank` owns units [rank U, rank U + U); its warp w
// the kCols units uw .. uw + 3, uw = rank U + w kCols: lane g 8 + dg
// holds the 4 columns j = g D + uw + c of gate g and the d of its chunks
// 4 (dg + 8 k) + (0 .. 3), and after the reduction the sum of column c
// = dg >> 1, whose unit's gates and state it keeps (lanes dg and dg ^ 1
// of each gate alike).  kProbe: the exchange probe, the step loop
// without the product and the gates (not the function).  c0 == nullptr:
// a zero state.
template <typename In, bool kProbe>
__global__ void __launch_bounds__(kUnits / kCols * 32, 1)
slstm_cluster_kernel(const In* __restrict__ px, const float* __restrict__ r,
                     const float* c0, const float* n0, const float* h0,
                     const float* m0, float* __restrict__ hs, float* c1,
                     float* n1, float* h1, float* m1, Saved sv, int B, int T,
                     int D, int H, long long psb, long long pst) {
  constexpr int kD = kMaxDh / kDGroups;   // d a lane
  constexpr int kChunks = kD / 4;         // its 4-wide chunks
  extern __shared__ __align__(16) float hbuf[];     // [kBufs][H][hsd]
  __shared__ __align__(8) unsigned long long bar[kBufs];

  const int U = units_per_block(D);
  const int Dh = D / H, E = 4 * Dh, hsd = head_stride(Dh);
  const int nbuf = H * hsd;                         // floats a buffer
  const uint32_t rank = cluster_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 3, dg = lane & 7;
  const int uw = (int)rank * U + warp * kCols;      // the warp's unit 0
  const int row = blockIdx.y;
  auto place = [&](int v) { return (v / Dh) * hsd + v % Dh; };
  auto unit_live = [&](int c) {
    return warp * kCols + c < U && uw + c < D;
  };

  // the lane's columns' r over its d, in registers for the whole
  // launch: rr[c kD + 4 k + i] = r[head, d, e] at d = 4 (dg + 8 k) + i;
  // hoff[c]: the column's head in a buffer.  Where the 4 columns are
  // neighbours in one head, 16 bytes aligned, one load takes all 4.
  float rr[kCols * kD];
  int hoff[kCols], eo[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool lc = unit_live(c);
    const int j = g * D + uw + c;
    hoff[c] = lc || c == 0 ? (lc ? j / E : 0) * hsd : hoff[0];
    eo[c] = lc ? (j / E) * Dh * E + j % E : -1;     // r[head, 0, e]
  }
  bool one_head = true;
#pragma unroll
  for (int c = 1; c < kCols; ++c) one_head = one_head && hoff[c] == hoff[0];
  const bool vec = one_head && eo[kCols - 1] == eo[0] + kCols - 1 &&
                   eo[0] % 4 == 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = 4 * (dg + kDGroups * k) + i;
      const bool in = !kProbe && d < Dh;
      if (vec) {
        const float4 q =
            in ? __ldg(reinterpret_cast<const float4*>(
                     r + eo[0] + (long long)d * E))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int c = 0; c < kCols; ++c) rr[c * kD + 4 * k + i] = component(q, c);
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          rr[c * kD + 4 * k + i] =
              in && eo[c] >= 0 ? __ldg(r + eo[c] + (long long)d * E) : 0.0f;
      }
    }

  // h_{-1} of the row into buffer 0, every unit; the padding of every
  // buffer to 0 (read, times r's zeros, by the last chunks)
  for (int k = threadIdx.x; k < kBufs * nbuf; k += blockDim.x)
    hbuf[k] = 0.0f;
  __syncthreads();
  for (int v = threadIdx.x; v < D; v += blockDim.x)
    hbuf[place(v)] = h0 != nullptr ? h0[(long long)row * D + v] : 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBufs; ++s) mbar_init(smem_u32(&bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive(smem_u32(&bar[0]));     // buffer 0 holds h_{-1} already
  }

  // the lane's unit after the reduction, and its state
  const int u = uw + (dg >> 1);
  const bool live = unit_live(dg >> 1);
  const int j = g * D + u;
  const long long idx = (long long)row * D + u;
  const bool st = live && c0 != nullptr;
  float cs = st ? c0[idx] : 0.0f;
  float ns = st ? n0[idx] : 0.0f;
  float ms = st ? m0[idx] : 0.0f;
  float hv = st ? h0[idx] : 0.0f;
  const In* pxc = px + (live ? row * psb + j : 0);
  // pre_x of column j at step t
  auto load = [&](int t) {
    return (live && t < T) ? to_float(pxc[(long long)t * pst]) : 0.0f;
  };

  // the warp's units are neighbours in one head at a 16-byte aligned
  // place: one store of 4 floats a destination block
  const bool packed = warp * kCols + kCols <= U && uw + kCols <= D &&
                      uw / Dh == (uw + kCols - 1) / Dh &&
                      place(uw) % 4 == 0;
  const bool sender = g == 0 && (dg & 1) == 0;
  const uint32_t hbuf_u32 = smem_u32(hbuf);

  // step t on pre_x xt; loads step t + 2's pre_x into xn
  auto step = [&](int t, float xt, float& xn) {
    const int s = t % kBufs;
    xn = load(t + 2);
    mbar_wait(smem_u32(&bar[s]), (t / kBufs) & 1);
    // the next buffer's phase waits for every unit's h_t: armed now,
    // off the step's path (its last phase, h_{t-3}'s, completed at
    // step t - 2)
    if (t + 1 < T && threadIdx.x == 0)
      mbar_expect_tx(smem_u32(&bar[(t + 1) % kBufs]), 4u * D);

    float pre;
    if constexpr (kProbe) {
      pre = xt;
    } else {
      const float* hp = hbuf + s * nbuf;
      float acc[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      // column c's chunk 4 (dg + 8 k) .. + 3 of its head
      auto madd = [&](int c, int k, const float4& hq) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[c] = fmaf(rr[c * kD + 4 * k + i], component(hq, i), acc[c]);
      };
      if (one_head) {
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int ch = dg + kDGroups * k;
          if (4 * ch < Dh) {
            const float4 hq =
                *reinterpret_cast<const float4*>(hp + hoff[0] + 4 * ch);
#pragma unroll
            for (int c = 0; c < kCols; ++c) madd(c, k, hq);
          }
        }
      } else {
#pragma unroll
        for (int k = 0; k < kChunks; ++k) {
          const int ch = dg + kDGroups * k;
          if (4 * ch < Dh) {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              madd(c, k,
                   *reinterpret_cast<const float4*>(hp + hoff[c] + 4 * ch));
          }
        }
      }
      // the 8 d-groups' sums, 4 columns transposed over the lanes: lane
      // dg ends with column dg >> 1
      const bool hi = dg & 4, mid = dg & 2;
      float k0 = hi ? acc[2] : acc[0];
      float k1 = hi ? acc[3] : acc[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 4);
      k1 += __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 4);
      float kv = (mid ? k1 : k0) +
                 __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 2);
      kv += __shfl_xor_sync(0xffffffffu, kv, 1);
      pre = kv + xt;
    }

    // the unit's four gates from the lanes of its d-group in each gate;
    // every lane of the unit keeps the same state
    const float i_ = __shfl_sync(0xffffffffu, pre, dg);
    const float f_ = __shfl_sync(0xffffffffu, pre, 8 + dg);
    const float z_ = __shfl_sync(0xffffffffu, pre, 16 + dg);
    const float o_ = __shfl_sync(0xffffffffu, pre, 24 + dg);
    if constexpr (kProbe)
      hv = i_ + f_ + z_ + o_;
    else
      gate_step(i_, f_, z_, o_, cs, ns, ms, hv);

    // h_t into every block's next buffer
    if (t + 1 < T) {
      const int sn = (t + 1) % kBufs;
      const uint32_t dst = hbuf_u32 + 4u * (uint32_t)(sn * nbuf);
      const uint32_t nbar = smem_u32(&bar[sn]);
      if (packed) {
        float seg[kCols];         // unit c's h at c
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          seg[c] = __shfl_sync(0xffffffffu, hv, c << 1);
        const uint32_t peer = lane & (kCluster - 1);
        if (lane < kCluster)
          st_async4(cluster_map(dst + 4u * (uint32_t)place(uw), peer), seg,
                    cluster_map(nbar, peer));
      } else if (live) {
        // the unit's 8 lanes share the kCluster blocks
        const uint32_t at = dst + 4u * (uint32_t)place(u);
        for (int peer = g << 1 | (dg & 1); peer < kCluster; peer += 8)
          st_async1(cluster_map(at, (uint32_t)peer), hv,
                    cluster_map(nbar, (uint32_t)peer));
      }
    }
    if (!kProbe && live) {
      const long long at = (long long)row * T + t;
      if (sender) hs[at * D + u] = hv;
      if (sv.pre != nullptr) {
        // what the backward reads: pre (each gate's lanes dg and dg ^ 1
        // hold it), and c, n and m
        if ((dg & 1) == 0) sv.pre[at * 4 * D + j] = pre;
        if (sender) {
          sv.c[at * D + u] = cs;
          sv.n[at * D + u] = ns;
          sv.m[at * D + u] = ms;
        }
      }
    }
  };

  float xa = load(0), xb = load(1), xc;
  // every block holds h_{-1} and its barriers are ready
  cluster_sync();
  // three steps an iteration, so that the pre_x loaded at step t is
  // first read, by its own name, at step t + 2: no register move at the
  // end of a step waits for a load from device memory
  for (int t = 0; t < T; t += 3) {
    step(t, xa, xc);
    if (t + 1 < T) step(t + 1, xb, xa);
    if (t + 2 < T) step(t + 2, xc, xb);
  }

  // no block leaves while a peer may still use its shared memory
  cluster_sync();
  if (sender && live) {
    c1[idx] = cs;
    n1[idx] = ns;
    h1[idx] = hv;
    m1[idx] = ms;
  }
}

template <typename In, bool kProbe>
cudaError_t cluster_config(int D, int H, cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute* attr) {
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err =
      prepare(slstm_cluster_kernel<In, kProbe>, ready,
              cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cfg.blockDim = dim3(cluster_threads(D));
  cfg.dynamicSmemBytes = cluster_smem(D, H);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename In, bool kProbe>
int launch_cluster(const void* px, const void* r, const void* c0,
                   const void* n0, const void* h0, const void* m0, void* hs,
                   void* c1, void* n1, void* h1, void* m1, Saved sv, int B,
                   int T, int D, int H, long long psb, long long pst,
                   cudaStream_t stream) {
  if (!cluster_fits(D, H) || B > 65535) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<In, kProbe>(D, H, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(kCluster, B);
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, slstm_cluster_kernel<In, kProbe>,
                           (const In*)px, (const float*)r, (const float*)c0,
                           (const float*)n0, (const float*)h0,
                           (const float*)m0, (float*)hs, (float*)c1,
                           (float*)n1, (float*)h1, (float*)m1, sv, B, T, D,
                           H, psb, pst);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// `step`
// ---------------------------------------------------------------------
constexpr int kStepUnits = 8;      // units a block, all four gates
constexpr int kStepRows = 4;       // batch rows a block (a float4 of h)
constexpr int kStepThreads = 256;  // 8 quads of columns x 32 d-groups
constexpr int kStepMaxT = 3;       // shorter T takes `step`
constexpr int kStepPre = 6;        // d of r a thread holds: Dh <= 192
constexpr int kStepMinBlocks = 2;  // blocks an SM (at most 128 registers)
constexpr int kStepMaxBlocks = 192;  // resident at once on any H100
constexpr int kBarSlots = 64;      // grid barriers, taken in turn
static_assert(kStepRows == 4, "a unit's rows are one float4 of h");

__host__ __device__ inline int step_blocks(int B, int D) {
  return (D + kStepUnits - 1) / kStepUnits *
         ((B + kStepRows - 1) / kStepRows);
}

__host__ __device__ inline bool step_fits(int B, int D) {
  return step_blocks(B, D) <= kStepMaxBlocks;
}

// dynamic shared memory of a `step` block: h_{t-1} of its rows, every
// unit (at most 24 KB: kStepMaxBlocks bounds D by 1536)
__host__ __device__ inline size_t step_smem(int D) {
  return sizeof(float4) * (size_t)D;
}

// A grid barrier in device memory: arrivals are counted, and the last
// one resets the count and moves the generation on.  Self-resetting, so
// consecutive launches reuse a slot without a memset.
struct GridBar {
  unsigned count, gen;
};
__device__ GridBar g_grid_bar[kBarSlots][2];

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// One thread of the block, after a __syncthreads that follows the
// block's reads and writes to order: arrives, and returns the
// generation to wait on.
__device__ __forceinline__ unsigned grid_arrive(GridBar* b, unsigned n) {
  const unsigned gen = ld_acquire(&b->gen);
  __threadfence();
  if (atomicAdd(&b->count, 1u) + 1 == n) {
    atomicExch(&b->count, 0u);
    st_release(&b->gen, gen + 1);
  }
  return gen;
}
// Waits until every block has arrived; traps after 2^32 cycles (over
// 2 s) instead of hanging on a fault.
__device__ __forceinline__ void grid_wait(GridBar* b, unsigned gen) {
  const long long start = clock64();
  while (ld_acquire(&b->gen) == gen)
    if (clock64() - start > (1ll << 32)) __trap();
}

// Grid (ceil(D / kStepUnits), ceil(B / kStepRows)): block (x, y) takes
// units x kStepUnits .. + 7 of rows y kStepRows .. + 3.  Thread: quad q
// = tid % 8 (gate q / 2, units ub .. ub + 3 with ub = x kStepUnits +
// (q % 2) 4), d-group dg = tid / 8 (d = dg, dg + 32, ...).  Threads
// tid < 32 are the gates' of unit x kStepUnits + tid % 8, row tid / 8.
template <typename In>
__global__ void __launch_bounds__(kStepThreads, kStepMinBlocks)
slstm_step_kernel(const In* __restrict__ px, const float* __restrict__ r,
                  const float* c0, const float* n0, const float* h0,
                  const float* m0, float* __restrict__ hs, float* c1,
                  float* n1, float* h1, float* m1, Saved sv, int B, int T,
                  int D, int H, long long psb, long long pst, int slot) {
  extern __shared__ __align__(16) float4 hsm[];     // [D]: 4 rows a unit
  __shared__ float red[kStepThreads / 32][8][16];   // warp, quad, c 4 + b
  __shared__ float pre_s[8][16];                    // quad, c 4 + b

  const int Dh = D / H, E = 4 * Dh;
  const int u0 = blockIdx.x * kStepUnits, row0 = blockIdx.y * kStepRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = tid & 7, dg = tid >> 3;
  const int ub = u0 + (q & 1) * 4;
  const int j0 = (q >> 1) * D + ub;                 // the quad's column 0
  // four columns in one head, 16-byte aligned in r
  const bool vec = ub + 3 < D && j0 % 4 == 0;
  const bool is_gate = tid < kStepUnits * kStepRows;
  const int gu = tid & 7, gr = tid >> 3;
  const int u = u0 + gu, row = row0 + gr;
  const bool gate_live = is_gate && u < D && row < B;
  const long long sidx = (long long)row * D + u;
  const unsigned nblocks = gridDim.x * gridDim.y;
  GridBar* bars = g_grid_bar[slot];

  float cs = 0.0f, ns = 0.0f, ms = 0.0f, hv = 0.0f;
  if (gate_live && c0 != nullptr) {
    cs = c0[sidx];
    ns = n0[sidx];
    ms = m0[sidx];
  }
  // the quad's r at its first kStepPre d (every d where Dh <= 192), in
  // registers before the first h is read: its loads overlap the fill
  const int hd = j0 / E;
  const float* rp = r + (long long)hd * Dh * E + j0 % E;   // r[hd, 0, e0]
  float4 rpre[kStepPre];
#pragma unroll
  for (int k = 0; k < kStepPre; ++k) {
    const int d = dg + 32 * k;
    rpre[k] = vec && d < Dh ? __ldg(reinterpret_cast<const float4*>(
                                  rp + (long long)d * E))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  unsigned gen_read = 0;
  for (int t = 0; t < T; ++t) {
    // the gate thread's pre_x, loaded before the product
    float xg[4];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
      xg[gg] = gate_live ? to_float(px[row * psb + t * pst + gg * D + u])
                         : 0.0f;
    // h_{t-1} of the rows, every unit: h0 (or 0), then hs, which other
    // blocks wrote in this launch (read from L2)
    for (int k = tid; k < D; k += kStepThreads) {
      float v[kStepRows];
#pragma unroll
      for (int b = 0; b < kStepRows; ++b) {
        const int rb = row0 + b;
        v[b] = rb >= B ? 0.0f
               : t == 0 ? (h0 != nullptr ? h0[(long long)rb * D + k] : 0.0f)
                        : __ldcg(hs + ((long long)rb * T + t - 1) * D + k);
      }
      hsm[k] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    if (t == 0 && tid == 0) gen_read = grid_arrive(&bars[0], nblocks);

    // the quad's four columns for the four rows, over this d-group's d
    float acc[4][kStepRows];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int b = 0; b < kStepRows; ++b) acc[c][b] = 0.0f;
    if (vec) {
      const float4* hp = hsm + hd * Dh;
      auto madd = [&](const float4& rv, const float4& h4) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int b = 0; b < kStepRows; ++b)
            acc[c][b] = fmaf(component(rv, c), component(h4, b), acc[c][b]);
      };
#pragma unroll
      for (int k = 0; k < kStepPre; ++k)
        if (dg + 32 * k < Dh) madd(rpre[k], hp[dg + 32 * k]);
      for (int d = dg + 32 * kStepPre; d < Dh; d += 32)
        madd(__ldg(reinterpret_cast<const float4*>(rp + (long long)d * E)),
             hp[d]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (ub + c >= D) continue;
        const int jc = j0 + c, hd = jc / E;
        const float* rp = r + (long long)hd * Dh * E + jc % E;
        for (int d = dg; d < Dh; d += 32) {
          const float rv = __ldg(rp + (long long)d * E);
          const float4 h4 = hsm[hd * Dh + d];
          acc[c][0] = fmaf(rv, h4.x, acc[c][0]);
          acc[c][1] = fmaf(rv, h4.y, acc[c][1]);
          acc[c][2] = fmaf(rv, h4.z, acc[c][2]);
          acc[c][3] = fmaf(rv, h4.w, acc[c][3]);
        }
      }
    }
    // the 32 d-groups: 4 in the warp (lanes q + 8 k), then the warps
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int b = 0; b < kStepRows; ++b) {
        float v = acc[c][b];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 8) red[warp][q][c * 4 + b] = v;
      }
    __syncthreads();
    if (tid < 128) {
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kStepThreads / 32; ++w)
        v += red[w][tid >> 4][tid & 15];
      pre_s[tid >> 4][tid & 15] = v;
    }
    __syncthreads();
    if (is_gate) {
      // gate gg of unit u0 + gu: quad gg 2 + gu / 4, column gu % 4
      const int qc = gu >> 2, k = (gu & 3) * 4 + gr;
      float pre[4];
#pragma unroll
      for (int gg = 0; gg < 4; ++gg) pre[gg] = pre_s[2 * gg + qc][k] + xg[gg];
      gate_step(pre[0], pre[1], pre[2], pre[3], cs, ns, ms, hv);
      if (gate_live) {
        const long long at = (long long)row * T + t;
        hs[at * D + u] = hv;
        if (sv.pre != nullptr) {
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) sv.pre[at * 4 * D + gg * D + u] = pre[gg];
          sv.c[at * D + u] = cs;
          sv.n[at * D + u] = ns;
          sv.m[at * D + u] = ms;
        }
      }
    }
    if (t + 1 < T) {
      // every block's h_t is in hs before any block reads it
      __syncthreads();
      if (tid == 0) grid_wait(&bars[1], grid_arrive(&bars[1], nblocks));
      __syncthreads();
    }
  }
  // every block has read h_{-1}: the state may be written over it
  if (tid == 0) grid_wait(&bars[0], gen_read);
  __syncthreads();
  if (gate_live) {
    c1[sidx] = cs;
    n1[sidx] = ns;
    h1[sidx] = hv;
    m1[sidx] = ms;
  }
}

template <typename In>
int launch_step(const void* px, const void* r, const void* c0,
                const void* n0, const void* h0, const void* m0, void* hs,
                void* c1, void* n1, void* h1, void* m1, Saved sv, int B,
                int T, int D, int H, long long psb, long long pst,
                cudaStream_t stream) {
  if (!step_fits(B, D)) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned> next_slot{0};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kStepUnits - 1) / kStepUnits,
                     (B + kStepRows - 1) / kStepRows);
  cfg.blockDim = dim3(kStepThreads);
  cfg.dynamicSmemBytes = step_smem(D);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int slot = (int)(next_slot.fetch_add(1) % kBarSlots);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, slstm_step_kernel<In>, (const In*)px, (const float*)r,
      (const float*)c0, (const float*)n0, (const float*)h0, (const float*)m0,
      (float*)hs, (float*)c1, (float*)n1, (float*)h1, (float*)m1, sv, B, T, D,
      H, psb, pst, slot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// the backward: `cluster` in reverse time
// ---------------------------------------------------------------------
// The gradient JAX takes through the `lax.scan` of slstm_block, step by
// step from t = T - 1 down to 0, with the state's gradients (dc, dn,
// dm) carried back a step: at step t, from dh_t = g_t (dL/dhs) + the
// recurrent product of dpre_{t+1},
//   h = sigmoid(o) c / max(n, 1e-6);  c, n, m from pre_t and step t - 1
//   dpre_t = (di, df, dz, do);   dh_{t-1} gets r[head, d, :] . dpre_t
// where jnp.maximum's gradient splits evenly at a tie (max(f + m, i)
// and max(n, 1e-6) alike) and m, a stabiliser, is differentiated as
// JAX does, not dropped.  dr = sum_t h_{t-1} (x) dpre_t per head is one
// product over B T, left to the wrapper (torch.matmul, as the
// reference leaves it to XLA), as is dh_{-1} of a state.
//
// Layout: the forward's cluster of 16 blocks a batch row, block `rank`
// owning U units, a warp 4 of them.  Here unit u's product is over its
// head's 4Dh columns of dpre: dh[u] = sum_e r[hd, d, e] dpre[hd 4Dh +
// e], so a warp holds r[hd, d, :] of its 4 units in registers (lane l
// the 16-byte chunks l, l + 32, ... of each, 96 floats), reads a chunk
// of the buffer once for all 4 units (one head), and reduces the 4 sums
// over its 32 lanes by a transposing shuffle: lane l ends with unit l
// >> 3's sum; the 8 lanes of a unit each take its whole gate step and
// lane k keeps gate k & 3's gradient.  Exchange: each block sends its
// units' dpre_t to the blocks whose units read those columns (with H
// <= 4 a head's 4Dh >= D columns hold a gate of every unit, so every
// block sends to every block, as the forward's h does, and the
// forward's three-buffer argument holds); a warp's 4 units of one gate
// are neighbours, one 16-byte st.async a destination.  Each block
// waits only on its own buffer's mbarrier, which expects the bytes of
// the heads its units span (4Dh floats each).  A step's raw inputs (g,
// pre, the state before it) are loaded two steps ahead, one a lane of
// the unit's 8, and the gate step's forward half (gate_fwd) runs for
// step n + 1 once step n has sent its dpre, while the peers' dpre is on
// its way: the chain of a step is the wait, the product, the shuffles,
// the terms in the carried gradients (gate_bwd) and the sends.
//
// Bound on an H100: the chain, as the forward: a step is 2 B D 4Dh
// operations (1.18 MFLOP a row at xlstm-125m's D 768, 4 heads: 0.0721
// ms at (1, 4096, 768) over 67 TFLOP/s), its bytes (g, pre, c, n, m
// read, dpre written: 48 B a unit and step) 0.0458 ms; a step costs
// one dot product, the gate step's gradient and one exchange.
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py): 6.93 ms
// at (1, 4096, 768), 1.69 us a step against the forward's 1.47-1.54.
constexpr int kBwdChunks = kMaxDh / 32;   // chunks of 4Dh a lane: <= 6

__host__ __device__ inline bool bwd_fits(int D, int H) {
  return cluster_fits(D, H) && H <= 4;
}

// dynamic shared memory of a backward block: kBufs buffers of the 4D
// columns of dpre
__host__ __device__ inline size_t bwd_smem(int D) {
  return sizeof(float) * kBufs * 4 * (size_t)D;
}

// The gradient of one unit's gate step (gate_step on pre = (i, f, z,
// o) from the state cp, np, mp) in two halves.  gate_fwd: what depends
// only on pre_t and the state before the step, the gate step's forward
// again (three expf, a tanhf, the sigmoid's reciprocal, c / nc) and the
// tie weights; it runs off the chain, for step n + 1 while the block
// waits on step n's exchange.  gate_bwd: the terms in the carried
// gradients, on the chain: dh = dL/dh of the step; dc, dn, dm the
// gradients of its c, n and m, which become those of cp, np and mp; out
// = dL/d(i, f, z, o).  float32, JAX's terms in JAX's order; the one
// rounding that differs from a plain step's is the chain's division by
// nc = max(n, 1e-6), taken as a product with 1 / nc from the forward
// half, so that no IEEE division is left on the chain (each gradient
// stays within its tolerance; the time it saves is in PERF.md).
struct GateFwd {
  float g;                  // dL/dh_t from above
  float cp, np;             // the state before the step
  float ig, fg, tz;         // exp(i - m), exp(f + mp - m), tanh(z)
  float so, rn, q;          // sigmoid(o), 1 / max(n, 1e-6), c / max(...)
  float wn, wf;             // ties: n against 1e-6, f + mp against i
};

// from the raw inputs: g, pre_t = (i, f, z, o), and cp, np, mp
__device__ __forceinline__ GateFwd gate_fwd(float g, float i_, float f_,
                                            float z_, float o_, float cp,
                                            float np, float mp) {
  GateFwd a;
  a.g = g;
  a.cp = cp;
  a.np = np;
  const float fm = f_ + mp;
  const float mn = fmaxf(fm, i_);
  a.ig = expf(i_ - mn);
  a.fg = expf(fm - mn);
  a.tz = tanhf(z_);
  const float c = a.fg * cp + a.ig * a.tz;
  const float n = a.fg * np + a.ig;
  const float nc = fmaxf(n, 1e-6f);
  a.so = 1.0f / (1.0f + expf(-o_));
  a.q = c / nc;
  a.rn = 1.0f / nc;
  a.wn = n > 1e-6f ? 1.0f : (n == 1e-6f ? 0.5f : 0.0f);
  a.wf = fm > i_ ? 1.0f : (fm == i_ ? 0.5f : 0.0f);
  return a;
}

__device__ __forceinline__ void gate_bwd(const GateFwd& a, float dh,
                                         float& dc, float& dn, float& dm,
                                         float (&out)[4]) {
  // h = so q, q = c / nc, nc = max(n, 1e-6)
  const float dq = dh * a.so;
  dc += dq * a.rn;
  dn += -dq * a.q * a.rn * a.wn;
  out[3] = dh * a.q * a.so * (1.0f - a.so);
  // c = fg cp + ig tanh(z), n = fg np + ig
  const float dfg = dc * a.cp + dn * a.np;
  const float dig = dc * a.tz + dn;
  out[2] = dc * a.ig * (1.0f - a.tz * a.tz);
  // fg = exp(fm - mn), ig = exp(i - mn), mn = max(fm, i) (and the next
  // step's m)
  const float af = dfg * a.fg, ai = dig * a.ig;
  const float dmn = dm - af - ai;
  const float dfm = af + dmn * a.wf;
  out[0] = ai + dmn * (1.0f - a.wf);
  out[1] = dfm;
  dc *= a.fg;
  dn *= a.fg;
  dm = dfm;                                 // fm = f + mp
}

// probes of the backward, not the function (dpre is not the gradient,
// the state's gradients are not written): kBwdExchange the step loop
// with the exchange alone (no product, no gate math), kBwdCompute the
// product and the gate math alone on the block's own buffer (no
// exchange), each step's product made to wait for the step before's
// gate math as the exchange makes it wait in the function
enum { kBwdFunction = 0, kBwdExchange = 1, kBwdCompute = 2 };

// a zero that the compiler cannot know before v is computed
__device__ __forceinline__ float zero_after(float v) {
  float z;
  asm volatile("and.b32 %0, %1, 0;\n" : "=f"(z) : "f"(v));
  return z;
}

// Grid (kCluster, B), clusters of kCluster along x, as the forward.
// dhs (B, T, D), pre (B, T, 4D), c, n, m (B, T, D): the forward's saved
// tensors; c0, n0, m0 the state it started from (null: zero); dc1, dn1,
// dm1 the gradients of its final c, n and m (null: zero).  Writes dpre
// (B, T, 4D) and, where not null, dc0, dn0, dm0.
template <int kProbe>
__global__ void __launch_bounds__(kUnits / kCols * 32, 1)
slstm_bwd_kernel(const float* __restrict__ dhs, const float* __restrict__ r,
                 const float* __restrict__ pre, const float* __restrict__ cs,
                 const float* __restrict__ ns, const float* __restrict__ ms,
                 const float* c0, const float* n0, const float* m0,
                 const float* dc1, const float* dn1, const float* dm1,
                 float* __restrict__ dpre, float* dc0, float* dn0,
                 float* dm0, int T, int D, int H) {
  extern __shared__ __align__(16) float dbuf[];     // [kBufs][4D]
  __shared__ __align__(8) unsigned long long bar[kBufs];
  constexpr bool kExchange = kProbe != kBwdCompute;
  constexpr bool kCompute = kProbe != kBwdExchange;

  const int U = units_per_block(D);
  const int Dh = D / H, E = 4 * Dh, D4 = 4 * D;
  const uint32_t rank = cluster_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int uw = (int)rank * U + warp * kCols;      // the warp's unit 0
  const int row = blockIdx.y;
  auto unit_live = [&](int c) {
    return warp * kCols + c < U && uw + c < D;
  };
  // the block's units [u_lo, u_hi) and the bytes of the heads they span
  const int u_lo = (int)rank * U, u_hi = min(u_lo + U, D);
  const bool has_units = u_lo < u_hi;
  const uint32_t expect =
      has_units ? 4u * E * ((u_hi - 1) / Dh - u_lo / Dh + 1) : 0u;

  // r[hd, d, :] of the warp's units: rr[c 4 kBwdChunks + 4 kk + i] at e
  // = 4 (lane + 32 kk) + i (zeros for a unit past the block's);
  // roff[c]: the unit's head's first column (unit 0's for a unit past
  // the block's, so that a warp's units stay in one head)
  float rr[kCols * 4 * kBwdChunks];
  int roff[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool lc = unit_live(c) && kCompute;
    const int uc = lc ? uw + c : (unit_live(0) ? uw : 0);
    roff[c] = (uc / Dh) * E;
    const float* rp = r + (long long)uc * E;        // r[hd, d, 0]
#pragma unroll
    for (int kk = 0; kk < kBwdChunks; ++kk) {
      const int ch = lane + 32 * kk;
      const float4 q = lc && ch < Dh
                           ? __ldg(reinterpret_cast<const float4*>(rp) + ch)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rr[c * 4 * kBwdChunks + 4 * kk + i] = component(q, i);
    }
  }
  bool one_head = true;
#pragma unroll
  for (int c = 1; c < kCols; ++c) one_head = one_head && roff[c] == roff[0];

  // dpre_T = 0 in buffer 0
  for (int k = threadIdx.x; k < kBufs * D4; k += blockDim.x) dbuf[k] = 0.0f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kBufs; ++s) mbar_init(smem_u32(&bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arrive(smem_u32(&bar[0]));
  }

  // the lane's unit after the reduction, its lane among the unit's 8
  const int cu = lane >> 3, k8 = lane & 7;
  const int u = uw + cu;
  const bool live = unit_live(cu);
  const long long idx = (long long)row * D + u;
  float dc = live && dc1 != nullptr ? dc1[idx] : 0.0f;
  float dn = live && dn1 != nullptr ? dn1[idx] : 0.0f;
  float dm = live && dm1 != nullptr ? dm1[idx] : 0.0f;
  // A step's raw inputs, spread over the unit's 8 lanes: lane k8 loads
  // g (0), pre's i, f, z, o (1-4) or the state before the step, cp, np,
  // mp (5-7), two steps ahead; gate_fwd gathers them by shuffles.
  const float* lsrc = k8 == 0 ? dhs : k8 < 5 ? pre : k8 == 5 ? cs
                                                 : k8 == 6 ? ns : ms;
  const float* lst = k8 == 5 ? c0 : k8 == 6 ? n0 : m0;
  const long long lw = k8 >= 1 && k8 <= 4 ? D4 : D;   // the row's width
  const int loff = k8 >= 1 && k8 <= 4 ? (k8 - 1) * D + u : u;
  const int lback = k8 >= 5 ? 1 : 0;    // the state before step t: t - 1
  auto load = [&](int n) {
    if (!live || n >= T) return 0.0f;
    const int t = T - 1 - n - lback;
    if (t >= 0) return lsrc[((long long)row * T + t) * lw + loff];
    return lst != nullptr ? lst[idx] : 0.0f;
  };
  auto prepare = [&](float raw) {
    const int l0 = lane & ~7;
    float x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __shfl_sync(0xffffffffu, raw, l0 + k);
    return gate_fwd(x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7]);
  };
  // the warp's units are in whole, 16-byte aligned groups of each gate
  const bool packed = warp * kCols + kCols <= U && uw + kCols <= D &&
                      D % 4 == 0 && uw % 4 == 0;
  const uint32_t dbuf_u32 = smem_u32(dbuf);

  float link = 0.0f;          // the compute probe's step-to-step chain
  // Step n (t = T - 1 - n) on the forward half a; loads step n + 2's raw
  // input into rn and, once dpre_t is sent, turns step n + 1's (r1)
  // into a.
  auto step = [&](int n, GateFwd& a, float r1, float& rn) {
    const int s = n % kBufs;
    rn = load(n + 2);
    if (kExchange) {
      mbar_wait(smem_u32(&bar[s]), (n / kBufs) & 1);
      if (n + 1 < T && threadIdx.x == 0)
        mbar_expect_tx(smem_u32(&bar[(n + 1) % kBufs]), expect);
    }

    float mine;
    if constexpr (kCompute) {
      // r . dpre_{t+1} of the warp's 4 units over the lane's chunks
      const float* bp = dbuf + (kExchange ? s : 0) * D4;
      float acc[kCols] = {link, 0.0f, 0.0f, 0.0f};
      auto madd = [&](int c, int kk, const float4& v) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[c] = fmaf(rr[c * 4 * kBwdChunks + 4 * kk + i], component(v, i),
                        acc[c]);
      };
#pragma unroll
      for (int kk = 0; kk < kBwdChunks; ++kk) {
        const int ch = lane + 32 * kk;
        if (ch < Dh) {
          if (one_head) {
            const float4 v =
                *reinterpret_cast<const float4*>(bp + roff[0] + 4 * ch);
#pragma unroll
            for (int c = 0; c < kCols; ++c) madd(c, kk, v);
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              madd(c, kk,
                   *reinterpret_cast<const float4*>(bp + roff[c] + 4 * ch));
          }
        }
      }
      // 32 lanes' sums of 4 units, transposed: lane l ends with unit l >> 3
      const bool hi = lane & 16, mid = lane & 8;
      float k0 = hi ? acc[2] : acc[0];
      float k1 = hi ? acc[3] : acc[1];
      k0 += __shfl_xor_sync(0xffffffffu, hi ? acc[0] : acc[2], 16);
      k1 += __shfl_xor_sync(0xffffffffu, hi ? acc[1] : acc[3], 16);
      float kv =
          (mid ? k1 : k0) + __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
      kv += __shfl_xor_sync(0xffffffffu, kv, 4);
      kv += __shfl_xor_sync(0xffffffffu, kv, 2);
      kv += __shfl_xor_sync(0xffffffffu, kv, 1);

      float out[4];
      gate_bwd(a, kv + a.g, dc, dn, dm, out);
      const int gk = k8 & 3;
      mine = gk == 0 ? out[0] : gk == 1 ? out[1] : gk == 2 ? out[2] : out[3];
      if (!kExchange) link = zero_after(mine);
    } else {
      mine = a.g + a.q;
    }

    // dpre_t into the next buffer of every block that reads it
    if (kExchange && n + 1 < T) {
      const int sn = (n + 1) % kBufs;
      const uint32_t dst = dbuf_u32 + 4u * (uint32_t)(sn * D4);
      const uint32_t nbar = smem_u32(&bar[sn]);
      if (packed) {
        // lane l: gate l & 3 of the warp's 4 units, to destinations
        // l >> 2, + 8
        const int g = lane & 3;
        float seg[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          seg[c] = __shfl_sync(0xffffffffu, mine, c * 8 + g);
        const int j0 = g * D + uw, hd = j0 / E;
        const int lo = hd * Dh / U, last = (hd * Dh + Dh - 1) / U;
        for (int peer = lo + (lane >> 2); peer <= last; peer += 8)
          st_async4(cluster_map(dst + 4u * (uint32_t)j0, (uint32_t)peer), seg,
                    cluster_map(nbar, (uint32_t)peer));
      } else if (live) {
        const int j = (k8 & 3) * D + u, hd = j / E;
        const int lo = hd * Dh / U, last = (hd * Dh + Dh - 1) / U;
        for (int peer = lo + (k8 >> 2); peer <= last; peer += 2)
          st_async1(cluster_map(dst + 4u * (uint32_t)j, (uint32_t)peer), mine,
                    cluster_map(nbar, (uint32_t)peer));
      }
    }
    if (live && k8 < 4)
      dpre[((long long)row * T + (T - 1 - n)) * D4 + (k8 & 3) * D + u] = mine;
    // off the chain: the next step's forward half, while the peers'
    // dpre_t is on its way
    a = prepare(r1);
  };

  GateFwd a = prepare(load(0));
  float ra = load(1), rb;
  // every block's buffers and barriers are ready
  cluster_sync();
  if (has_units) {
    // two steps an iteration: the raw input loaded at step n is first
    // read, by its own name, at step n + 1
    for (int n = 0; n < T; n += 2) {
      step(n, a, ra, rb);
      if (n + 1 < T) step(n + 1, a, rb, ra);
    }
  }
  // no block leaves while a peer may still write its shared memory
  cluster_sync();
  if (kProbe == kBwdFunction && live && k8 == 0) {
    if (dc0 != nullptr) dc0[idx] = dc;
    if (dn0 != nullptr) dn0[idx] = dn;
    if (dm0 != nullptr) dm0[idx] = dm;
  }
}

template <int kProbe>
int launch_bwd(const void* dhs, const void* r, const void* pre,
               const void* c, const void* n, const void* m, const void* c0,
               const void* n0, const void* m0, const void* dc1,
               const void* dn1, const void* dm1, void* dpre, void* dc0,
               void* dn0, void* dm0, int B, int T, int D, int H,
               cudaStream_t stream) {
  if (!bwd_fits(D, H) || B > 65535) return (int)cudaErrorInvalidValue;
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = prepare(slstm_bwd_kernel<kProbe>, ready,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(cluster_threads(D));
  cfg.dynamicSmemBytes = bwd_smem(D);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, slstm_bwd_kernel<kProbe>, (const float*)dhs, (const float*)r,
      (const float*)pre, (const float*)c, (const float*)n, (const float*)m,
      (const float*)c0, (const float*)n0, (const float*)m0,
      (const float*)dc1, (const float*)dn1, (const float*)dm1, (float*)dpre,
      (float*)dc0, (float*)dn0, (float*)dm0, T, D, H);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------
// the entry points
// ---------------------------------------------------------------------
// kernel codes of slstm_scan_kernel_hd
enum { kStepCode = 0, kClusterCode = 1, kProbeCode = 2 };

// the variant slstm_scan_hd takes: `step` below kStepMaxT steps (and
// where `cluster` does not fit), `cluster` from there on; -1: neither
// takes the shape.  The wrapper's slstm_variant is the same rule and
// names its choice to slstm_scan_kernel_hd.
int variant_for(int B, int T, int D, int H) {
  const bool cl = cluster_fits(D, H);
  if (step_fits(B, D) && (T < kStepMaxT || !cl)) return kStepCode;
  return cl ? kClusterCode : -1;
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, void*, void*,
                      void*, Saved, int, int, int, int, long long, long long,
                      cudaStream_t);

template <typename In>
Launch launcher(int kernel) {
  switch (kernel) {
    case kStepCode: return launch_step<In>;
    case kClusterCode: return launch_cluster<In, false>;
    case kProbeCode: return launch_cluster<In, true>;
    default: return nullptr;
  }
}

}  // namespace

// The number of clusters of the `cluster` kernel (bfloat16 pre_x) at
// width D with H heads that the card holds at once, into *clusters;
// returns the CUDA error.
extern "C" int slstm_scan_max_clusters(int D, int H, int* clusters) {
  if (!cluster_fits(D, H)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cudaError_t err = cluster_config<__nv_bfloat16, false>(D, H, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(kCluster, 1);
  return (int)cudaOccupancyMaxActiveClusters(
      clusters, (void*)slstm_cluster_kernel<__nv_bfloat16, false>, &cfg);
}

// The function of slstm_scan_hd on the kernel `kernel`: 0 `step`, 1
// `cluster`, 2 the exchange probe (the `cluster` step loop without the
// product and the gates; not the function: hs is not written, the final
// state is not the recurrence's).  pre (B, T, 4D), c, n and m (B, T, D),
// float32 and contiguous, all null or all given: with them the kernel
// also writes what slstm_scan_bwd_hd reads (a forward with grad).
// Returns cudaErrorInvalidValue for a kernel that does not take the
// shape.
extern "C" int slstm_scan_kernel_hd(const void* px, const void* r,
                                    const void* c0, const void* n0,
                                    const void* h0, const void* m0,
                                    void* hs, void* c1, void* n1, void* h1,
                                    void* m1, void* pre, void* c, void* n,
                                    void* m, int dtype, int kernel, int B,
                                    int T, int D, int H, long long psb,
                                    long long pst, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  const Launch fn = dtype == 0   ? launcher<float>(kernel)
                    : dtype == 1 ? launcher<__nv_bfloat16>(kernel)
                                 : nullptr;
  const bool save = pre != nullptr;
  if (fn == nullptr || save != (c != nullptr) || save != (n != nullptr) ||
      save != (m != nullptr) || (save && kernel == kProbeCode))
    return (int)cudaErrorInvalidValue;
  const Saved sv{(float*)pre, (float*)c, (float*)n, (float*)m};
  return fn(px, r, c0, n0, h0, m0, hs, c1, n1, h1, m1, sv, B, T, D, H, psb,
            pst, (cudaStream_t)stream);
}

// px: (B, T, 4D) of the type `dtype` (0 float32, 1 bfloat16), unit
// stride along 4D, batch and time strides psb, pst in elements.  r: (H,
// D / H, 4 D / H) float32, contiguous.  c0, n0, h0, m0: (B, D) float32,
// contiguous, all null for a zero state.  hs: (B, T, D) float32,
// contiguous.  c1, n1, h1, m1: (B, D) float32, contiguous, the final
// state; each may be its *0 tensor.  Takes the kernel of variant_for.
// Returns the CUDA error of the launch (cudaErrorInvalidValue for an
// unknown dtype, D not a multiple of H, or a shape neither variant
// takes).
extern "C" int slstm_scan_hd(const void* px, const void* r, const void* c0,
                             const void* n0, const void* h0, const void* m0,
                             void* hs, void* c1, void* n1, void* h1,
                             void* m1, int dtype, int B, int T, int D,
                             int H, long long psb, long long pst,
                             void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  const int kernel = variant_for(B, T, D, H);
  if (kernel < 0) return (int)cudaErrorInvalidValue;
  return slstm_scan_kernel_hd(px, r, c0, n0, h0, m0, hs, c1, n1, h1, m1,
                              nullptr, nullptr, nullptr, nullptr, dtype,
                              kernel, B, T, D, H, psb, pst, stream);
}

// The backward of a forward with grad (slstm_scan_kernel_hd with pre, c,
// n, m): dhs (B, T, D) = dL/dhs, r (H, D / H, 4 D / H), pre (B, T, 4D),
// c, n, m (B, T, D), the state c0, n0, m0 (B, D) or all null (zero),
// dc1, dn1, dm1 (B, D) the gradients of the final c, n, m or all null
// (zero); all float32 and contiguous.  Writes dpre (B, T, 4D) float32
// and, where given, dc0, dn0, dm0 (B, D).  The `cluster` layout in
// reverse time; takes the shapes `cluster` takes with H <= 4, else
// returns cudaErrorInvalidValue.  Returns the CUDA error of the launch.
extern "C" int slstm_scan_bwd_hd(const void* dhs, const void* r,
                                 const void* pre, const void* c,
                                 const void* n, const void* m,
                                 const void* c0, const void* n0,
                                 const void* m0, const void* dc1,
                                 const void* dn1, const void* dm1,
                                 void* dpre, void* dc0, void* dn0, void* dm0,
                                 int B, int T, int D, int H, void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  return launch_bwd<kBwdFunction>(dhs, r, pre, c, n, m, c0, n0, m0, dc1,
                                  dn1, dm1, dpre, dc0, dn0, dm0, B, T, D, H,
                                  (cudaStream_t)stream);
}

// The backward's probes on slstm_scan_bwd_hd's arguments, for
// measurements, not the function: probe 1 the step loop with the
// exchange alone (no product, no gate math), 2 the product and the gate
// math alone on the block's own buffer (no exchange).  dpre is written
// but is not the gradient; dc0, dn0, dm0 are not written.  Returns
// cudaErrorInvalidValue for another probe code or a shape the backward
// does not take.
extern "C" int slstm_scan_bwd_probe_hd(
    const void* dhs, const void* r, const void* pre, const void* c,
    const void* n, const void* m, const void* c0, const void* n0,
    const void* m0, const void* dc1, const void* dn1, const void* dm1,
    void* dpre, void* dc0, void* dn0, void* dm0, int B, int T, int D, int H,
    void* stream, int probe) {
  if (B == 0 || T == 0 || D == 0) return 0;
  if (H <= 0 || D % H != 0) return (int)cudaErrorInvalidValue;
  if (probe == kBwdExchange)
    return launch_bwd<kBwdExchange>(dhs, r, pre, c, n, m, c0, n0, m0, dc1,
                                    dn1, dm1, dpre, dc0, dn0, dm0, B, T, D,
                                    H, (cudaStream_t)stream);
  if (probe == kBwdCompute)
    return launch_bwd<kBwdCompute>(dhs, r, pre, c, n, m, c0, n0, m0, dc1,
                                   dn1, dm1, dpre, dc0, dn0, dm0, B, T, D, H,
                                   (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
