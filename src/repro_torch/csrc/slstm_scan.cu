// The sLSTM recurrence of xLSTM (arXiv:2405.04517), one layer's whole
// scan over T in one launch:
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
// (:187, the scan at :217; a float32 scan, not a Pallas kernel: on the
// card a loop of PyTorch ops over T launches about 18 kernels a step).
//
// Bound on an H100: the sequential chain.  A step is 2 B H Dh 4Dh
// operations (4.72 MFLOP at B 4 and xlstm-125m's D 768, H 4), which the
// card's 67 TFLOP/s of float32 would do in 0.07 us, and reads Bx4D
// values of pre_x; step t + 1 cannot start before every unit of step t
// is known.  At B 4, T 2048 the operations bound is 0.144 ms and the
// byte bound (pre_x once, hs once, r once) 0.023 ms; what a step costs
// is the latency of the product, the gates and the exchange of h.
//
// Design (the first, simple one): one cluster of kCluster = 16 blocks
// (a non-portable cluster size) takes kRows = 4 batch rows.  Block k of
// the cluster owns U = ceil(D / 16) units (48 at D 768), i.e. 4U gate
// columns, and keeps their slice of r, Dh x 4U floats (147 KB at D 768),
// in shared memory for the whole launch, so r is read from device
// memory once a launch and once a step from shared memory for all kRows
// rows.  Each block also holds all of h_{t-1} for its rows, double
// buffered.  A step: thread c of the block computes column c's dot
// product for the kRows rows (float4 h values, a broadcast within a
// warp) and adds pre_x (loaded two steps ahead into registers); thread
// (b, u) computes unit u's gates and state for row b in registers and
// writes h to hs; the block then stores its U new h values into every
// block's next buffer through distributed shared memory (16-byte
// st.shared::cluster, one per unit and block) and the cluster meets at
// one barrier (arrive.release / wait.acquire) before the next step.
// Only 16 of the 132 SMs work, one barrier a step: the kernel is far
// from its bound, which a later design is to close.
//
// Numbers: accurate expf and tanhf and IEEE division (no fast math);
// the dot products are summed in order of d with FMAs, where PyTorch's
// einsum sums in its own order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCluster = 16;     // blocks a cluster, all units of a row
constexpr int kRows = 4;         // batch rows a cluster (one float4 of h)
constexpr int kMaxThreads = 512; // 4U threads: U <= 128, D <= 2048
static_assert(kRows == 4, "a row group is one float4 of h");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders the shared-memory
// stores before it (remote ones included) before the reads after it
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

__device__ __forceinline__ void st_cluster_v4(uint32_t addr, float4 v) {
  asm volatile(
      "st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
      : "memory");
}

__host__ __device__ inline int units_per_block(int D) {
  return (D + kCluster - 1) / kCluster;
}

__host__ __device__ inline int block_threads(int D) {
  return (4 * units_per_block(D) + 31) / 32 * 32;
}

// dynamic shared memory: h double-buffered (2 D float4), the block's
// new h (U float4), the step's pre-activations (kRows x 4U) and the
// slice of r (Dh x 4U)
__host__ __device__ inline size_t smem_bytes(int D, int H) {
  const size_t U = units_per_block(D), Dh = D / H;
  return sizeof(float4) * (2 * (size_t)D + U) +
         sizeof(float) * 4 * U * (kRows + Dh);
}

// Grid (kCluster, ceil(B / kRows)), one cluster along x per group of
// kRows batch rows.  c0 == nullptr: a zero state.
template <typename In>
__global__ void __launch_bounds__(kMaxThreads)
slstm_scan_kernel(const In* __restrict__ px, const float* __restrict__ r,
                  const float* c0, const float* n0, const float* h0,
                  const float* m0, float* __restrict__ hs, float* c1,
                  float* n1, float* h1, float* m1, int B, int T, int D,
                  int H, long long psb, long long pst) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int U = units_per_block(D);
  const int cols = 4 * U;
  const int Dh = D / H;
  const int E = 4 * Dh;
  float4* hbuf = reinterpret_cast<float4*>(smem);           // [2][D]
  float4* hloc = hbuf + 2 * D;                              // [U]
  float* pre_s = reinterpret_cast<float*>(hloc + U);        // [kRows][cols]
  float* r_s = pre_s + kRows * cols;                        // [Dh][cols]

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const uint32_t rank = cluster_rank();
  const int u0 = (int)rank * U;
  const int row0 = blockIdx.y * kRows;

  // this thread's gate column: gate g of unit u0 + ul, flat output j
  const bool is_col = tid < cols;
  const int cg = tid / U, cul = tid % U;
  const bool col_live = is_col && u0 + cul < D;
  const int j = cg * D + u0 + cul;
  const int hoff = col_live ? (j / E) * Dh : 0;             // its head's h
  const int e = j % E;
  for (int d = 0; d < Dh && is_col; ++d)
    r_s[d * cols + tid] =
        col_live ? __ldg(r + ((long long)(j / E) * Dh + d) * E + e) : 0.0f;

  // h_{-1} of the kRows rows, every unit
  float* hb0 = reinterpret_cast<float*>(hbuf);
  for (int k = tid; k < D * kRows; k += nthreads) {
    const int u = k / kRows, row = row0 + k % kRows;
    hb0[k] = (h0 != nullptr && row < B) ? h0[(long long)row * D + u] : 0.0f;
  }

  // this thread's unit for the gates: row b, unit u0 + gul
  const bool is_gate = tid < kRows * U;
  const int gb = tid / U, gul = tid % U;
  const int grow = row0 + gb, gu = u0 + gul;
  const bool gate_live = is_gate && grow < B && gu < D;
  const long long sidx = (long long)grow * D + gu;
  float cs = 0.0f, ns = 0.0f, ms = 0.0f, hv = 0.0f;
  if (gate_live && c0 != nullptr) {
    cs = c0[sidx];
    ns = n0[sidx];
    ms = m0[sidx];
    hv = h0[sidx];
  }

  // pre_x of column j for the kRows rows, two steps ahead
  const In* pxc[kRows];
  bool row_in[kRows];
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    row_in[b] = col_live && row0 + b < B;
    pxc[b] = px + (row_in[b] ? (long long)(row0 + b) * psb + j : 0);
  }
  auto load = [&](float (&v)[kRows], int t) {
#pragma unroll
    for (int b = 0; b < kRows; ++b)
      v[b] = (row_in[b] && t < T) ? to_float(pxc[b][(long long)t * pst])
                                  : 0.0f;
  };
  float x0[kRows], x1[kRows];
  load(x0, 0);
  load(x1, 1);

  // every block has started and holds r and h_{-1}
  cluster_sync();

  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    float x2[kRows];
    load(x2, t + 2);
    if (is_col) {
      float acc[kRows];
#pragma unroll
      for (int b = 0; b < kRows; ++b) acc[b] = 0.0f;
      const float4* hp = hbuf + p * D + hoff;
      const float* rp = r_s + tid;
#pragma unroll 8
      for (int d = 0; d < Dh; ++d) {
        const float rv = rp[d * cols];
        const float4 h4 = hp[d];
        acc[0] = fmaf(rv, h4.x, acc[0]);
        acc[1] = fmaf(rv, h4.y, acc[1]);
        acc[2] = fmaf(rv, h4.z, acc[2]);
        acc[3] = fmaf(rv, h4.w, acc[3]);
      }
#pragma unroll
      for (int b = 0; b < kRows; ++b) pre_s[b * cols + tid] = x0[b] + acc[b];
    }
    __syncthreads();

    if (is_gate) {
      const float* pr = pre_s + gb * cols + gul;
      const float i_ = pr[0], f_ = pr[U], z_ = pr[2 * U], o_ = pr[3 * U];
      const float fm = f_ + ms;
      const float m_new = fmaxf(fm, i_);
      const float ig = expf(i_ - m_new);
      const float fg = expf(fm - m_new);
      cs = fg * cs + ig * tanhf(z_);
      ns = fg * ns + ig;
      ms = m_new;
      hv = (1.0f / (1.0f + expf(-o_))) * (cs / fmaxf(ns, 1e-6f));
      if (gate_live) hs[((long long)grow * T + t) * D + gu] = hv;
      reinterpret_cast<float*>(hloc)[gul * kRows + gb] = hv;
    }
    __syncthreads();

    // h_t of this block's units into every block's next buffer
    const uint32_t next = smem_u32(hbuf + (p ^ 1) * D + u0);
    for (int k = tid; k < kCluster * U; k += nthreads) {
      const int dst = k / U, ul = k % U;
      if (u0 + ul < D)
        st_cluster_v4(cluster_map(next + 16 * ul, (uint32_t)dst), hloc[ul]);
    }
    cluster_sync();

#pragma unroll
    for (int b = 0; b < kRows; ++b) {
      x0[b] = x1[b];
      x1[b] = x2[b];
    }
  }

  if (gate_live) {
    c1[sidx] = cs;
    n1[sidx] = ns;
    h1[sidx] = hv;
    m1[sidx] = ms;
  }
}

template <typename In>
int launch(const void* px, const void* r, const void* c0, const void* n0,
           const void* h0, const void* m0, void* hs, void* c1, void* n1,
           void* h1, void* m1, int B, int T, int D, int H, long long psb,
           long long pst, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, H);
  auto* kernel = slstm_scan_kernel<In>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, (B + kRows - 1) / kRows);
  cfg.blockDim = dim3(block_threads(D));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const In*)px, (const float*)r,
                           (const float*)c0, (const float*)n0,
                           (const float*)h0, (const float*)m0, (float*)hs,
                           (float*)c1, (float*)n1, (float*)h1, (float*)m1, B,
                           T, D, H, psb, pst);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The number of the kernel's clusters (bfloat16 pre_x) at width D with H
// heads that the card holds at once, into *clusters; returns the CUDA
// error.
extern "C" int slstm_scan_max_clusters(int D, int H, int* clusters) {
  auto* kernel = slstm_scan_kernel<__nv_bfloat16>;
  const size_t smem = smem_bytes(D, H);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1);
  cfg.blockDim = dim3(block_threads(D));
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (void*)kernel, &cfg);
}

// px: (B, T, 4D) of the type `dtype` (0 float32, 1 bfloat16), unit
// stride along 4D, batch and time strides psb, pst in elements.  r: (H,
// D / H, 4 D / H) float32, contiguous.  c0, n0, h0, m0: (B, D) float32,
// contiguous, all null for a zero state.  hs: (B, T, D) float32,
// contiguous.  c1, n1, h1, m1: (B, D) float32, contiguous, the final
// state; each may be its *0 tensor.  Returns the CUDA error of the launch
// (cudaErrorInvalidValue for an unknown dtype, D not a multiple of H, a
// block over kMaxThreads threads or over 227 KB of shared memory).
extern "C" int slstm_scan_hd(const void* px, const void* r, const void* c0,
                             const void* n0, const void* h0, const void* m0,
                             void* hs, void* c1, void* n1, void* h1,
                             void* m1, int dtype, int B, int T, int D,
                             int H, long long psb, long long pst,
                             void* stream) {
  if (B == 0 || T == 0 || D == 0) return 0;
  if (H <= 0 || D % H != 0 || block_threads(D) > kMaxThreads ||
      smem_bytes(D, H) > 232448 || (B + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(px, r, c0, n0, h0, m0, hs, c1, n1, h1, m1, B, T, D,
                         H, psb, pst, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(px, r, c0, n0, h0, m0, hs, c1, n1, h1, m1,
                                 B, T, D, H, psb, pst, st);
  return (int)cudaErrorInvalidValue;
}
