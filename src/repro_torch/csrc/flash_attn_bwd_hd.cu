// The backward of causal / windowed GQA flash attention: dq (B, T, Hq, D),
// dk and dv (B, S, Hkv, D) from q, k, v, the forward's output o and
// dO = dL/do, all (B, T|S, H, D), the per-row log-sum-exp lse (B, Hq, T)
// that the forward wrote, and qpos (B, T).
//
// Replaces the reference's flash backward, `_bw_blocks` under the
// `custom_vjp` of `blockwise_attention`
// (src/repro/kernels/flash_attention/jnp_impl.py:130 and :202-241; the
// TPU runs it as jnp, not as a Pallas kernel), and computes what it
// computes, recomputing each probability from lse instead of storing it:
//   s = q.k (float32), z = s * scale, with a softcap z = cap * tanh(z / cap);
//   p = exp(z - lse) where the key is visible, else 0;
//   delta = sum_d dO * o per row; dp = dO.v;
//   dz = p * (dp - delta), with a softcap * (1 - (z / cap)^2), then * scale;
//   dv = sum p dO, dk = sum dz q (over the G query heads of the kv head),
//   dq = sum dz k.
// The mask is the forward's: key < S, key <= qpos, qpos >= 0 and, with a
// window, key > qpos - window (64-bit, so a window of 2^30 cannot wrap).
// A fully masked row has lse = -1e30 and p = 0, never exp of it.
//
// Bound on an H100: operations.  Per visible (query, key) pair and query
// head the backward does 2 D flops for each of q.k, dO.v, p dO, dz q and
// dz k (10 D; 6 Dh + 4 Dv in general), at the 989 TFLOP/s dense bf16
// tensor-core peak.  Its bytes (q, k, v, o, dO read, dq, dk, dv written)
// need far less at training lengths.
//
// The design is FlashAttention-2's split into three launches, none with
// atomics, so every sum has one fixed order and the result is
// deterministic:
//   (a) delta: one warp per (b, t, h) row, float32;
//   (b) dK, dV: a block per (64-key block, kv head, batch) owns those
//       rows of dk and dv in float32 registers and loops over the G query
//       heads of its group and over the query tiles whose qpos range can
//       see the block (tiles that cannot are skipped after reading qpos),
//       recomputing p and dz tile by tile;
//   (c) dQ: a block per (64 query rows, query head, batch) loops over the
//       key tiles its rows' qpos range can see (as the forward does) and
//       owns its dq rows; longest blocks first.
// 16-bit operands (bf16, fp16) go through mma.sync m16n8k16 with float32
// accumulators, fragments by ldmatrix from shared memory filled with
// cp.async; p and dz are rounded to the operand type for their products,
// as FlashAttention-2 does (the reference keeps them float32; the tests
// state the tolerance).  float32 goes through plain FFMA loops, not
// TF32.  Head dims: D = Dh = Dv in {64, 128}.  This is the first, simple
// design: single-buffered tiles, no wgmma or TMA (PERF.md has its time
// against the bound).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;      // 4 warps

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const int* qpos;
  const float* lse;      // (B, Hq, T)
  float* delta;          // (B, Hq, T), written by (a)
  void* dq;              // (B, T, Hq, D), contiguous
  void* dk;              // (B, S, Hkv, D), contiguous
  void* dv;              // (B, S, Hkv, D), contiguous
  int B, T, S, Hq, Hkv, D;
  // element strides: batch, position, head of q, k, v, o and dout (the
  // last dim is unit-stride); batch and position of qpos
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh, d_sb, d_st, d_sh, p_sb, p_st;
  float scale, softcap;
  int has_window;
  long long window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> struct Ops;

template <> struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <> struct Ops<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

__device__ __forceinline__ bool visible(long long key, int qp,
                                        const Params& p) {
  return key < p.S && key <= qp && qp >= 0 &&
         (!p.has_window || key > (long long)qp - p.window);
}

// z = s * scale, softcapped; `fac` gets dz/dz_pre-cap = 1 - (z / cap)^2
__device__ __forceinline__ float logit(float s, const Params& p, float& fac) {
  float z = s * p.scale;
  fac = 1.f;
  if (p.softcap != 0.f) {
    z = tanhf(z / p.softcap) * p.softcap;
    const float r = z / p.softcap;
    fac = 1.f - r * r;
  }
  return z;
}

__device__ __forceinline__ long long lse_index(const Params& p, int b, int h,
                                               int t) {
  return ((long long)b * p.Hq + h) * p.T + t;
}

// ---- (a) delta -----------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const Params p) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= (long long)p.B * p.T * p.Hq) return;   // whole warps
  const int h = (int)(row % p.Hq);
  const int t = (int)((row / p.Hq) % p.T);
  const int b = (int)(row / ((long long)p.Hq * p.T));
  const T* o = (const T*)p.o + b * p.o_sb + t * p.o_st + h * p.o_sh;
  const T* d = (const T*)p.dout + b * p.d_sb + t * p.d_st + h * p.d_sh;
  float s = 0.f;
  for (int c = lane; c < p.D; c += 32) s = fmaf(to_f(d[c]), to_f(o[c]), s);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) p.delta[lse_index(p, b, h, t)] = s;
}

// the smallest and largest valid (>= 0) query position of rows
// [t0, t0 + rows), rows <= 64, reduced over the warp: lo > hi when none
__device__ __forceinline__ void warp_qpos_range(const Params& p, int b, int t0,
                                                int rows, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  lo = INT_MAX;
  hi = -1;
  for (int r = lane; r < rows; r += 32) {
    const int t = t0 + r;
    const int qp = t < p.T ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
    if (qp >= 0) {
      lo = min(lo, qp);
      hi = max(hi, qp);
    }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

// whether a query tile with valid positions in [lo, hi] can see a key of
// [kv0, kv_last]
__device__ __forceinline__ bool tile_sees(const Params& p, int lo, int hi,
                                          long long kv0, long long kv_last) {
  if (hi < 0 || hi < kv0) return false;
  return !p.has_window || (long long)lo - p.window + 1 <= kv_last;
}

// [*key_begin, *key_end): the keys a query of rows [t0, t0 + rows) can see
__device__ __forceinline__ void key_range(const Params& p, int lo, int hi,
                                          long long* key_begin,
                                          long long* key_end) {
  *key_end = hi < 0 ? 0 : (hi + 1LL < p.S ? hi + 1LL : (long long)p.S);
  long long first = 0;
  if (p.has_window && hi >= 0) first = (long long)lo - p.window + 1;
  *key_begin = first > 0 ? first : 0;
}

// ---- mma.sync building blocks (16-bit operands) --------------------------
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(ptr)));
}

// rows [row0, row0 + ROWS) x D of an operand whose rows are `stride`
// elements apart, into shared rows of LD elements; zeros past `nrows`
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long stride, long long row0,
                                          long long nrows) {
  constexpr int kChunks = D / 8;            // 16 bytes each
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LD + cc * 8, in ? src + (row0 + r) * stride + cc * 8
                                         : src, in);
  }
}

// c (16 rows x 8 NT columns, the m16n8 accumulator layout: c[n][0..1]
// row g, c[n][2..3] row g + 8, columns 8 n + 2 tig + {0, 1}) = A B^T over
// D, with A the 16 shared rows at `a` and B the 8 NT shared rows at `bm`,
// both row-major over D with pitch LD
template <typename T, int NT, int D, int LD>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const T* a,
                                        const T* bm) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lrow + (lmat & 1) * 8) * LD + kk * 16 +
                        (lmat >> 1) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4(bf, bm + (np * 16 + lrow + (lmat >> 1) * 8) * LD +
                          kk * 16 + (lmat & 1) * 8);
      Ops<T>::mma(c[2 * np], af, bf[0], bf[1]);
      Ops<T>::mma(c[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows x D) += P Z, with P (16 rows x 16 KC) in registers in the
// accumulator layout of mma_abt<.., 2 KC, ..>, rounded to T, and Z the
// 16 KC shared rows at `z`, row-major over D with pitch LD
template <typename T, int KC, int D, int LD>
__device__ __forceinline__ void mma_pz(float (&acc)[D / 8][4],
                                       const float (&pm)[2 * KC][4],
                                       const T* z) {
  const int lane = threadIdx.x & 31, lrow = lane & 7, lmat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const uint32_t af[4] = {Ops<T>::pack(pm[2 * kk][0], pm[2 * kk][1]),
                            Ops<T>::pack(pm[2 * kk][2], pm[2 * kk][3]),
                            Ops<T>::pack(pm[2 * kk + 1][0], pm[2 * kk + 1][1]),
                            Ops<T>::pack(pm[2 * kk + 1][2], pm[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, z + (kk * 16 + lrow + (lmat & 1) * 8) * LD +
                                np * 16 + (lmat >> 1) * 8);
      Ops<T>::mma(acc[2 * np], af, bf[0], bf[1]);
      Ops<T>::mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// 16 rows x D of float32 accumulators in the m16n8 layout, rounded to T,
// into rows `row` and `row + 8` (when below `nrows`) of a contiguous
// output whose rows are `stride` elements apart
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long stride,
                                           long long row, long long nrows,
                                           const float (&acc)[D / 8][4]) {
  const int tig = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row < nrows)
      *reinterpret_cast<uint32_t*>(out + row * stride + col) =
          Ops<T>::pack(acc[n][0], acc[n][1]);
    if (row + 8 < nrows)
      *reinterpret_cast<uint32_t*>(out + (row + 8) * stride + col) =
          Ops<T>::pack(acc[n][2], acc[n][3]);
  }
}

// ---- (b) dK, dV, 16-bit --------------------------------------------------
// 64 keys a block, 16 per warp; query tiles of BQ rows.  Per warp and
// tile: s^T = K_w Q^T, p^T, dv += p^T dO, dp^T = V_w dO^T, dz^T,
// dk += dz^T Q.
template <typename T, int D, int BQ, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1) dkdv_mma_kernel(const Params p) {
  constexpr int BK = 64, LD = D + 8, NT = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);       // [BK][LD]
  T* Vs = Ks + BK * LD;                     // [BK][LD]
  T* Qs = Vs + BK * LD;                     // [BQ][LD]
  T* dOs = Qs + BQ * LD;                    // [BQ][LD]
  __shared__ int qpos_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const long long kv0 = (long long)blockIdx.x * BK;
  const long long kv_last = (kv0 + BK < p.S ? kv0 + BK : (long long)p.S) - 1;
  load_tile<T, BK, D, LD>(Ks, (const T*)p.k + b * p.k_sb + hk * p.k_sh,
                          p.k_ss, kv0, p.S);
  load_tile<T, BK, D, LD>(Vs, (const T*)p.v + b * p.v_sb + hk * p.v_sh,
                          p.v_ss, kv0, p.S);
  cp_async_commit();
  const T* Kw = Ks + warp * 16 * LD;
  const T* Vw = Vs + warp * 16 * LD;
  const long long key0 = kv0 + warp * 16 + g, key1 = key0 + 8;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += BQ) {
    int lo, hi;                              // the same in every warp
    warp_qpos_range(p, b, t0, BQ, lo, hi);
    if (!tile_sees(p, lo, hi, kv0, kv_last)) continue;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      __syncthreads();                       // the last tile's reads are done
      load_tile<T, BQ, D, LD>(Qs, (const T*)p.q + b * p.q_sb + h * p.q_sh,
                              p.q_st, t0, p.T);
      load_tile<T, BQ, D, LD>(dOs, (const T*)p.dout + b * p.d_sb + h * p.d_sh,
                              p.d_st, t0, p.T);
      cp_async_commit();
      if (threadIdx.x < BQ) {
        const int t = t0 + threadIdx.x;
        const bool in = t < p.T;
        qpos_s[threadIdx.x] = in ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
        lse_s[threadIdx.x] = in ? p.lse[lse_index(p, b, h, t)] : 0.f;
        delta_s[threadIdx.x] = in ? p.delta[lse_index(p, b, h, t)] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      float st[NT][4];                       // s^T, then p^T
      mma_abt<T, NT, D, LD>(st, Kw, Qs);
      float fac[kSoftcap ? NT : 1][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + tig * 2 + (e & 1);
          float f;
          const float z = logit(st[n][e], p, f);
          if (kSoftcap) fac[n][e] = f;
          st[n][e] = visible(e < 2 ? key0 : key1, qpos_s[col], p)
                         ? expf(z - lse_s[col]) : 0.f;
        }
      mma_pz<T, BQ / 16, D, LD>(dv, st, dOs);
      float dpt[NT][4];                      // dp^T, then dz^T
      mma_abt<T, NT, D, LD>(dpt, Vw, dOs);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n * 8 + tig * 2 + (e & 1);
          float dz = st[n][e] * (dpt[n][e] - delta_s[col]);
          if (kSoftcap) dz *= fac[n][e];
          dpt[n][e] = dz * p.scale;
        }
      mma_pz<T, BQ / 16, D, LD>(dk, dpt, Qs);
    }
  }
  cp_async_wait_all();   // a block that saw no query still owns its load
  const long long pitch = (long long)p.Hkv * D;
  const long long base = ((long long)b * p.S * p.Hkv + hk) * D;
  store_rows<T, D>((T*)p.dk + base, pitch, key0, p.S, dk);
  store_rows<T, D>((T*)p.dv + base, pitch, key0, p.S, dv);
}

// ---- (c) dQ, 16-bit ------------------------------------------------------
// 64 query rows a block, 16 per warp; key tiles of 64.  Per warp and
// tile: s = Q_w K^T, p, dp = dO_w V^T, dz, dq += dz K.
template <typename T, int D, bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1) dq_mma_kernel(const Params p) {
  constexpr int BQ = 64, BK = 64, LD = D + 8, NT = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);       // [BQ][LD]
  T* dOs = Qs + BQ * LD;                    // [BQ][LD]
  T* Ks = dOs + BQ * LD;                    // [BK][LD]
  T* Vs = Ks + BK * LD;                     // [BK][LD]
  __shared__ int qpos_s[BQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int hk = h / (p.Hq / p.Hkv);
  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  load_tile<T, BQ, D, LD>(Qs, (const T*)p.q + b * p.q_sb + h * p.q_sh,
                          p.q_st, t0, p.T);
  load_tile<T, BQ, D, LD>(dOs, (const T*)p.dout + b * p.d_sb + h * p.d_sh,
                          p.d_st, t0, p.T);
  cp_async_commit();
  if (threadIdx.x < BQ) {
    const int t = t0 + threadIdx.x;
    qpos_s[threadIdx.x] = t < p.T ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
  }
  int lo, hi;
  warp_qpos_range(p, b, t0, BQ, lo, hi);
  long long key_begin, key_end;
  key_range(p, lo, hi, &key_begin, &key_end);
  __syncthreads();
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int q0 = qpos_s[r0], q1 = qpos_s[r1];
  const bool in0 = t0 + r0 < p.T, in1 = t0 + r1 < p.T;
  const float lse0 = in0 ? p.lse[lse_index(p, b, h, t0 + r0)] : 0.f;
  const float lse1 = in1 ? p.lse[lse_index(p, b, h, t0 + r1)] : 0.f;
  const float dl0 = in0 ? p.delta[lse_index(p, b, h, t0 + r0)] : 0.f;
  const float dl1 = in1 ? p.delta[lse_index(p, b, h, t0 + r1)] : 0.f;

  float dq[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const long long tile_end = (key_end + BK - 1) / BK;
  for (long long tile = key_begin / BK; tile < tile_end; ++tile) {
    const long long kv0 = tile * BK;
    __syncthreads();                         // the last tile's reads are done
    load_tile<T, BK, D, LD>(Ks, kb, p.k_ss, kv0, p.S);
    load_tile<T, BK, D, LD>(Vs, vb, p.v_ss, kv0, p.S);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();

    float sc[NT][4];                         // s, then p
    mma_abt<T, NT, D, LD>(sc, Qs + warp * 16 * LD, Ks);
    float fac[kSoftcap ? NT : 1][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long key = kv0 + n * 8 + tig * 2 + (e & 1);
        float f;
        const float z = logit(sc[n][e], p, f);
        if (kSoftcap) fac[n][e] = f;
        sc[n][e] = visible(key, e < 2 ? q0 : q1, p)
                       ? expf(z - (e < 2 ? lse0 : lse1)) : 0.f;
      }
    float dp[NT][4];                         // dp, then dz
    mma_abt<T, NT, D, LD>(dp, dOs + warp * 16 * LD, Vs);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float dz = sc[n][e] * (dp[n][e] - (e < 2 ? dl0 : dl1));
        if (kSoftcap) dz *= fac[n][e];
        dp[n][e] = dz * p.scale;
      }
    mma_pz<T, BK / 16, D, LD>(dq, dp, Ks);
  }
  cp_async_wait_all();   // a block that saw no key still owns its Q load
  store_rows<T, D>((T*)p.dq + ((long long)b * p.T * p.Hq + h) * D,
                   (long long)p.Hq * D, t0 + r0, p.T, dq);
}

// ---- float32: FFMA ---------------------------------------------------------
// (b): 64 keys a block, query tiles of 16.  Thread t owns key row t % 64
// and the column half t / 64 of its dk and dv rows.
template <int D>
__global__ void __launch_bounds__(kThreads) dkdv_f32_kernel(const Params p) {
  constexpr int BK = 64, BQ = 16, LDK = D + 1, LDP = BQ + 1, HALF = D / 2;
  extern __shared__ float smf[];
  float* Ks = smf;                         // [BK][LDK]
  float* Vs = Ks + BK * LDK;               // [BK][LDK]
  float* Qs = Vs + BK * LDK;               // [BQ][LDK]
  float* dOs = Qs + BQ * LDK;              // [BQ][LDK]
  float* Ps = dOs + BQ * LDK;              // [BK][LDP]
  float* dZs = Ps + BK * LDP;              // [BK][LDP]
  __shared__ int qpos_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, hk = blockIdx.y;
  const int G = p.Hq / p.Hkv;
  const long long kv0 = (long long)blockIdx.x * BK;
  const long long kv_last = (kv0 + BK < p.S ? kv0 + BK : (long long)p.S) - 1;
  const float* kb = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = (const float*)p.v + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const bool in = kv0 + r < p.S;
    Ks[r * LDK + c] = in ? kb[(kv0 + r) * p.k_ss + c] : 0.f;
    Vs[r * LDK + c] = in ? vb[(kv0 + r) * p.v_ss + c] : 0.f;
  }
  const int r = tid % BK, c0 = (tid / BK) * HALF;
  const long long key = kv0 + r;
  float dk[HALF], dv[HALF];
#pragma unroll
  for (int j = 0; j < HALF; ++j) dk[j] = dv[j] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += BQ) {
    int lo, hi;
    warp_qpos_range(p, b, t0, BQ, lo, hi);
    if (!tile_sees(p, lo, hi, kv0, kv_last)) continue;
    for (int gi = 0; gi < G; ++gi) {
      const int h = hk * G + gi;
      __syncthreads();
      const float* qb = (const float*)p.q + b * p.q_sb + h * p.q_sh;
      const float* db = (const float*)p.dout + b * p.d_sb + h * p.d_sh;
      for (int i = tid; i < BQ * D; i += kThreads) {
        const int qr = i / D, c = i % D;
        const bool in = t0 + qr < p.T;
        Qs[qr * LDK + c] = in ? qb[(long long)(t0 + qr) * p.q_st + c] : 0.f;
        dOs[qr * LDK + c] = in ? db[(long long)(t0 + qr) * p.d_st + c] : 0.f;
      }
      if (tid < BQ) {
        const int t = t0 + tid;
        const bool in = t < p.T;
        qpos_s[tid] = in ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
        lse_s[tid] = in ? p.lse[lse_index(p, b, h, t)] : 0.f;
        delta_s[tid] = in ? p.delta[lse_index(p, b, h, t)] : 0.f;
      }
      __syncthreads();
      // p^T and dz^T at (r, q) for q = tid / 64 + 2 i
      for (int qc = tid / BK; qc < BQ; qc += kThreads / BK) {
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < D; ++c) {
          s = fmaf(Ks[r * LDK + c], Qs[qc * LDK + c], s);
          dp = fmaf(Vs[r * LDK + c], dOs[qc * LDK + c], dp);
        }
        float f;
        const float z = logit(s, p, f);
        const float pe = visible(key, qpos_s[qc], p)
                             ? expf(z - lse_s[qc]) : 0.f;
        Ps[r * LDP + qc] = pe;
        dZs[r * LDP + qc] = pe * (dp - delta_s[qc]) * f * p.scale;
      }
      __syncthreads();
      for (int qc = 0; qc < BQ; ++qc) {
        const float pe = Ps[r * LDP + qc], dz = dZs[r * LDP + qc];
#pragma unroll
        for (int j = 0; j < HALF; ++j) {
          dv[j] = fmaf(pe, dOs[qc * LDK + c0 + j], dv[j]);
          dk[j] = fmaf(dz, Qs[qc * LDK + c0 + j], dk[j]);
        }
      }
    }
  }
  if (key < p.S) {
    const long long off = (((long long)b * p.S + key) * p.Hkv + hk) * D + c0;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      ((float*)p.dk)[off + j] = dk[j];
      ((float*)p.dv)[off + j] = dv[j];
    }
  }
}

// (c): 16 query rows a block, key tiles of 32.  Thread t owns query row
// t % 16 and the columns t / 16 + 8 j of its dq row.
template <int D>
__global__ void __launch_bounds__(kThreads) dq_f32_kernel(const Params p) {
  constexpr int BQ = 16, BK = 32, LDK = D + 1, LDZ = BK + 1, NC = D / 8;
  extern __shared__ float smf[];
  float* Qs = smf;                         // [BQ][LDK]
  float* dOs = Qs + BQ * LDK;              // [BQ][LDK]
  float* Ks = dOs + BQ * LDK;              // [BK][LDK]
  float* Vs = Ks + BK * LDK;               // [BK][LDK]
  float* dZs = Vs + BK * LDK;              // [BQ][LDZ]
  __shared__ int qpos_s[BQ];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest first
  const int hk = h / (p.Hq / p.Hkv);
  const float* qb = (const float*)p.q + b * p.q_sb + h * p.q_sh;
  const float* db = (const float*)p.dout + b * p.d_sb + h * p.d_sh;
  const float* kb = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = (const float*)p.v + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int qr = i / D, c = i % D;
    const bool in = t0 + qr < p.T;
    Qs[qr * LDK + c] = in ? qb[(long long)(t0 + qr) * p.q_st + c] : 0.f;
    dOs[qr * LDK + c] = in ? db[(long long)(t0 + qr) * p.d_st + c] : 0.f;
  }
  if (tid < BQ) {
    const int t = t0 + tid;
    const bool in = t < p.T;
    qpos_s[tid] = in ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
    lse_s[tid] = in ? p.lse[lse_index(p, b, h, t)] : 0.f;
    delta_s[tid] = in ? p.delta[lse_index(p, b, h, t)] : 0.f;
  }
  int lo, hi;
  warp_qpos_range(p, b, t0, BQ, lo, hi);
  long long key_begin, key_end;
  key_range(p, lo, hi, &key_begin, &key_end);
  const int r = tid % BQ, cg = tid / BQ;
  float dq[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) dq[j] = 0.f;

  const long long tile_end = (key_end + BK - 1) / BK;
  for (long long tile = key_begin / BK; tile < tile_end; ++tile) {
    const long long kv0 = tile * BK;
    __syncthreads();
    for (int i = tid; i < BK * D; i += kThreads) {
      const int kr = i / D, c = i % D;
      const bool in = kv0 + kr < p.S;
      Ks[kr * LDK + c] = in ? kb[(kv0 + kr) * p.k_ss + c] : 0.f;
      Vs[kr * LDK + c] = in ? vb[(kv0 + kr) * p.v_ss + c] : 0.f;
    }
    __syncthreads();
    // dz at (r, kc) for kc = tid / 16 + 8 i
    for (int kc = cg; kc < BK; kc += kThreads / BQ) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s = fmaf(Qs[r * LDK + c], Ks[kc * LDK + c], s);
        dp = fmaf(dOs[r * LDK + c], Vs[kc * LDK + c], dp);
      }
      float f;
      const float z = logit(s, p, f);
      const float pe = visible(kv0 + kc, qpos_s[r], p)
                           ? expf(z - lse_s[r]) : 0.f;
      dZs[r * LDZ + kc] = pe * (dp - delta_s[r]) * f * p.scale;
    }
    __syncthreads();
    for (int kc = 0; kc < BK; ++kc) {
      const float dz = dZs[r * LDZ + kc];
#pragma unroll
      for (int j = 0; j < NC; ++j)
        dq[j] = fmaf(dz, Ks[kc * LDK + cg + 8 * j], dq[j]);
    }
  }
  const int t = t0 + r;
  if (t < p.T) {
    float* out = (float*)p.dq + (((long long)b * p.T + t) * p.Hq + h) * D;
#pragma unroll
    for (int j = 0; j < NC; ++j) out[cg + 8 * j] = dq[j];
  }
}

// ---- launches --------------------------------------------------------------
template <typename K>
int launch(K kern, dim3 grid, int smem, const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kSoftcap>
int launch_mma(const Params& p, cudaStream_t s) {
  constexpr int BQ = D > 64 ? 32 : 64;      // registers: dk, dv and 2 tiles
  int e = launch(dkdv_mma_kernel<T, D, BQ, kSoftcap>,
                 dim3((p.S + 63) / 64, p.Hkv, p.B),
                 (2 * 64 + 2 * BQ) * (D + 8) * (int)sizeof(T), p, s);
  if (e != 0) return e;
  return launch(dq_mma_kernel<T, D, kSoftcap>,
                dim3((p.T + 63) / 64, p.Hq, p.B),
                4 * 64 * (D + 8) * (int)sizeof(T), p, s);
}

template <int D>
int launch_f32(const Params& p, cudaStream_t s) {
  int e = launch(dkdv_f32_kernel<D>, dim3((p.S + 63) / 64, p.Hkv, p.B),
                 ((2 * 64 + 2 * 16) * (D + 1) + 2 * 64 * 17) * 4, p, s);
  if (e != 0) return e;
  return launch(dq_f32_kernel<D>, dim3((p.T + 15) / 16, p.Hq, p.B),
                ((2 * 16 + 2 * 32) * (D + 1) + 16 * 33) * 4, p, s);
}

template <typename T>
int launch_delta(const Params& p, cudaStream_t s) {
  const long long rows = (long long)p.B * p.T * p.Hq;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_16(const Params& p, cudaStream_t s) {
  int e = launch_delta<T>(p, s);
  if (e != 0) return e;
  return p.softcap != 0.f ? launch_mma<T, D, true>(p, s)
                          : launch_mma<T, D, false>(p, s);
}

}  // namespace

// dtype: 0 float32 (FFMA), 1 bfloat16, 2 float16 (mma.sync), for q, k, v,
// o, dout, dq, dk and dv alike.  D = Dh = Dv must be 64 or 128; any other
// D or dtype returns cudaErrorInvalidValue and launches nothing.
// strides: 17 element strides, (batch, position, head) of q, k, v, o and
// dout, then (batch, position) of qpos (int32); every last dim is
// unit-stride.  lse (B, Hq, T) float32 from the forward; delta (B, Hq, T)
// float32 scratch; dq (B, T, Hq, D), dk and dv (B, S, Hkv, D) contiguous
// outputs, all allocated by the caller.  has_window = 0 means causal only.
// The caller checks Hq % Hkv == 0, 16-byte aligned rows for 16-bit types
// and grid limits; with B, T, S or Hq zero nothing is launched (the
// caller's outputs are zeros).  Launches (a) delta, (b) dK/dV and (c) dQ on `stream`
// and returns cudaGetLastError() after the first that fails, else 0.
extern "C" int flash_attn_bwd_hd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const int* qpos, const void* lse,
                                 void* delta, void* dq, void* dk, void* dv,
                                 int dtype, int B, int T, int S, int Hq,
                                 int Hkv, int D, const long long* strides,
                                 float scale, float softcap, int has_window,
                                 long long window, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0) return 0;
  if ((D != 64 && D != 128) || dtype < 0 || dtype > 2 || Hkv <= 0 ||
      Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, qpos, (const float*)lse, (float*)delta,
           dq, dk, dv, B, T, S, Hq, Hkv, D,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13], strides[14],
           strides[15], strides[16], scale, softcap, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const int e = launch_delta<float>(p, s);
    if (e != 0) return e;
    return D == 64 ? launch_f32<64>(p, s) : launch_f32<128>(p, s);
  }
  if (dtype == 1)
    return D == 64 ? launch_16<__nv_bfloat16, 64>(p, s)
                   : launch_16<__nv_bfloat16, 128>(p, s);
  return D == 64 ? launch_16<__half, 64>(p, s) : launch_16<__half, 128>(p, s);
}
