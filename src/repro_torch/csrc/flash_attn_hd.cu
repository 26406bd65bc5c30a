// Causal / windowed GQA attention with a per-row query position, the
// forward of flash attention: o (B, T, Hq, Dv) from q (B, T, Hq, Dh),
// k (B, S, Hkv, Dh), v (B, S, Hkv, Dv) and qpos (B, T).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_fa_kernel`
// (src/repro/kernels/flash_attention/kernel.py:80), and computes what
// it computes: a blockwise online softmax with float32 m, l and acc;
// q.k in float32, times `scale`, then an optional tanh softcap; the
// mask kpos <= qpos, kpos >= 0, qpos >= 0 and, with a window,
// kpos > qpos - window; masked logits -1e30; p cast to v's dtype
// before p.v, which accumulates in float32; rows with no unmasked key
// write exactly 0; query head h reads kv head h / (Hq / Hkv); a qpos
// of -1 marks a padding row.  Given a non-null `lse`, each variant also
// writes the row's log-sum-exp m + log(l) (B, Hq, T), float32, natural
// log, -1e30 for a row with no visible key, which the backward
// (flash_attn_bwd_hd.cu) rebuilds p from; serving passes null.
//
// Bound on an H100: operations.  The serving path's prefill, q (4,
// 2048, 32, 128) against the (4, 4096, 4, 128) cache of a layer, does
// 4 * Dh flops for each of 8,392,704 visible (query, key) pairs per
// head: 1.3751e11 flops, 0.139 ms at the 989 TFLOP/s dense bf16
// tensor-core peak, against 0.045 ms for its bytes.  gemma2's prefill,
// q (4, 2048, 16, 256) against (4, 4096, 8, 256), does the same
// operations (0.060 ms of bytes).  deepseek-v3's MLA prefill, q (4,
// 2048, 128, 192) against k (4, 4096, 128, 192) and v (4, 4096, 128,
// 128), does 2 (192 + 128) flops a pair and head: 6.8753e11, 0.695 ms
// (0.361 ms of bytes, its shared RoPE key read once a row).  Only wgmma
// reaches that peak on Hopper.
//
// Three variants, chosen by the caller (kernels/flash_attention/
// kernel.py: flash_variant) and launched as asked or not at all:
//
// * wgmma (bf16 and fp16 with Dh = Dv in {64, 128, 256}, or Dh 192 /
//   Dv 128, MLA's naive form; every serving prefill).  A block takes
//   128 query rows of one (b, query head) and has three warpgroups.
//   Warpgroup 2 is the producer: after
//   setmaxnreg gives its registers to the others (24 / 240), one of its
//   threads loads Q once and keeps two K/V stages of 64 keys in flight
//   with TMA (4-d tensor maps over (Dh, heads, positions, batch) built
//   per launch from the operands' strides, so a cache view goes in as
//   it is; 128-byte swizzle; rows past S arrive as zeros), each
//   completing on an mbarrier.  Warpgroups 0 and 1 own 64 query rows
//   each.  S = Q K^T is wgmma m64n64k16 with both operands K-major in
//   shared memory; O += P V is wgmma m64nDk16 with P in registers,
//   packed from the score accumulators, and V read MN-major
//   (transposed) from shared memory.  q k_i^T and p_{i-1} v_{i-1} are
//   issued together; K's stage is freed as soon as its product is done,
//   V's after the next.  The online softmax runs on the accumulator
//   registers: rows reduced over the 4 threads that share one, log2
//   domain, one ex2.approx per score, the mask applied only on tiles
//   where a row of the warp can miss a key, as two 32-bit compares
//   against per-row key bounds.  The softcap is a template argument,
//   its tanh one ex2.approx and one rcp.approx a score.  At Dh 256 the
//   same tiles fit: Q takes 64 KB and two K/V stages 128 KB of shared
//   memory (193 KB of the 227 a block may have), a consumer thread
//   holds O's 128 accumulators, 32 scores and 16 packed p registers
//   (252 registers), and O += P V is one m64n256k16 a k-step.  There
//   the block has no producer warpgroup: ptxas spills the consumers
//   under setmaxnreg (see kProducerWarpgroup), so the block is the two
//   consumer warpgroups alone and their thread 0 issues the copies.
//   Waits sleep on their mbarrier instead of spinning.  The kv loop
//   spans only the tiles that hold a visible key, from the block's own
//   qpos range (never assumed to be arange).  Blocks run longest first
//   (the query tile is the slow grid index, counted from the last), and
//   the 8 heads of a GQA group are neighbours in the grid, so their K/V
//   tiles come from L2.  The mbarrier, TMA and wgmma helpers are in
//   hopper.cuh, shared with the backward.  At Dh 192 / Dv 128 (MLA)
//   q k^T runs 12 k16 steps over three 64-column panels and p v is
//   m64n128k16 as at Dh 128, so a consumer holds Dh 128's registers;
//   Q takes 48 KB and a K / V stage 24 / 16 KB.  MLA has Hq = Hkv
//   (no group shares a K/V tile), so there a (b, head)'s query tiles
//   are neighbours in the grid instead: about 8 heads' K/V (21 MB) are
//   in flight and stay in L2.  Its third panel of Q and K, the RoPE
//   columns, comes from tensor maps of its own, over the caller's
//   q_rope and k_rope (one RoPE key a position, read as kv head 0 by
//   every query head) or over q's and k's last 64 columns: the caller
//   passes MLA's parts without concatenating them, and the bits are
//   those of the concatenated launch.  Its time against the
//   tensor-core bound, what still holds it back and what was tried
//   against it are in PERF.md.
// * mma_sync (the other bf16/fp16 head dims, Dh != Dv but 192 / 128
//   among them): one block of 4 warps per 64 query rows, mma.sync
//   m16n8k16 fed by ldmatrix from a two-stage cp.async pipeline, head
//   dims padded to 64, 128 or 256.
// * ffma (float32): a plain FFMA loop (16 query rows, 32 keys per
//   tile), not TF32, which would miss the reference's 2e-5 bound.
#include <cuda.h>          // CUtensorMap; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 128;
constexpr int kRows = 64;          // query rows per block, 16 per warp

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  void* o;
  float* lse;            // (B, Hq, T) or null
  int B, T, S, Hq, Hkv, Dh, Dv;
  // element strides: batch, position, head (the last dim is unit-stride)
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh, p_sb, p_st;
  float scale, softcap;
  int has_window;
  long long window;
  // the RoPE parts of q and k as operands of their own (wgmma at 192 /
  // 128 only): q_rope (B, T, Hq, 64), k_rope (B, S, 1, 64), one head
  // shared by every query head; null when q and k hold every column
  const void* q_rope;
  const void* k_rope;
  long long qr_sb, qr_st, qr_sh, kr_sb, kr_ss, kr_sh;
};

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

__device__ __forceinline__ bool visible(long long key, int qp, int S,
                                        const Params& p) {
  return key < S && key <= qp && qp >= 0 &&
         (!p.has_window || key > (long long)qp - p.window);
}

// The log-sum-exp of row t from the online softmax's m and l, m in log2
// units (the 16-bit variants) or natural ones (float32)
__device__ __forceinline__ void write_lse(const Params& p, int b, int h,
                                          int t, float m, float l,
                                          bool log2_units) {
  if (p.lse == nullptr || t >= p.T) return;
  float v = kNegInf;
  if (l > 0.f) v = log2_units ? (m + log2f(l)) * kLn2 : m + logf(l);
  p.lse[((long long)b * p.Hq + h) * p.T + t] = v;
}

// Reads the block's query positions into `qpos_s` (-1 past T) and sets
// [*key_begin, *key_end), the keys any of its rows can see.
template <int ROWS>
__device__ void key_range(const Params& p, int b, int t0, int* qpos_s,
                          int* lo_s, int* hi_s, long long* key_begin,
                          long long* key_end) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    *hi_s = -1;
    *lo_s = INT_MAX;
  }
  __syncthreads();
  if (tid < ROWS) {
    const int t = t0 + tid;
    const int qp = t < p.T ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
    qpos_s[tid] = qp;
    if (qp >= 0) {
      atomicMax(hi_s, qp);
      atomicMin(lo_s, qp);
    }
  }
  __syncthreads();
  const int hi = *hi_s;
  *key_end = hi < 0 ? 0 : (hi + 1LL < p.S ? hi + 1LL : (long long)p.S);
  long long lo = 0;
  if (p.has_window && hi >= 0) lo = (long long)*lo_s - p.window + 1;
  *key_begin = lo > 0 ? lo : 0;
}

// 16 bytes global -> shared without passing through registers; with
// `in` false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices from shared memory, one row address per lane
// (lanes 8i..8i+7 address matrix i); thread t gets row t/4, columns
// 2(t%4) and 2(t%4)+1 of each, or of each transposed with .trans
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// rows [row0, row0 + ROWS) x D columns of a (rows, width) operand whose
// rows are `stride` elements apart, into shared memory rows of LD
// elements, with cp.async; zeros past `nrows` and past `width` (a
// multiple of 8).
template <typename T, int ROWS, int D, int LD>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                long long stride,
                                                long long row0, int nrows,
                                                int width) {
  constexpr int kChunks = D / 8;            // 16 bytes each
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    const bool in = row0 + r < nrows && cc * 8 < width;
    cp_async16(dst + r * LD + cc * 8,
               in ? src + (row0 + r) * stride + cc * 8 : src, in);
  }
}

template <typename T, int D, int BN>
__global__ void __launch_bounds__(kThreads)
fa_mma_kernel(const Params p) {
  constexpr int LD = D + 8;                 // padded shared-memory row
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);       // [kRows][LD]
  T* KVs = Qs + kRows * LD;                 // 2 stages x (K, V) [BN][LD]
  __shared__ int qpos_s[kRows];
  __shared__ int lo_s, hi_s;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma fragment coordinates
  const int lrow = lane & 7, lmat = lane >> 3;   // ldmatrix addressing
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRows;
  const int hk = h / (p.Hq / p.Hkv);
  const T* qb = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;

  long long key_begin, key_end;
  key_range<kRows>(p, b, t0, qpos_s, &lo_s, &hi_s, &key_begin, &key_end);
  const long long tile_first = key_begin / BN;
  const long long tile_end = (key_end + BN - 1) / BN;
  // group 0: the Q tile and the first K/V tile
  load_tile_async<T, kRows, D, LD>(Qs, qb + t0 * p.q_st, p.q_st, 0,
                                   p.T - t0, p.Dh);
  if (tile_first < tile_end) {
    load_tile_async<T, BN, D, LD>(KVs, kb, p.k_ss, tile_first * BN, p.S,
                                  p.Dh);
    load_tile_async<T, BN, D, LD>(KVs + BN * LD, vb, p.v_ss,
                                  tile_first * BN, p.S, p.Dv);
  }
  cp_async_commit();
  const int qr0 = qpos_s[warp * 16 + g], qr1 = qpos_s[warp * 16 + g + 8];
  // the smallest and largest query position of this warp's 16 rows
  int wq_lo = qpos_s[warp * 16 + (lane & 15)], wq_hi = wq_lo;
#pragma unroll
  for (int off = 1; off <= 8; off <<= 1) {
    wq_lo = min(wq_lo, __shfl_xor_sync(0xffffffffu, wq_lo, off));
    wq_hi = max(wq_hi, __shfl_xor_sync(0xffffffffu, wq_hi, off));
  }
  const float scale_log2 = p.scale * kLog2e;
  const int dh_steps = (p.Dh + 15) / 16, dv_tiles = p.Dv / 8;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (long long tile = tile_first; tile < tile_end; ++tile) {
    const long long kv0 = tile * BN;
    const int stage = (int)((tile - tile_first) & 1);
    if (tile + 1 < tile_end) {              // prefetch the next tile
      T* nxt = KVs + (stage ^ 1) * 2 * BN * LD;
      load_tile_async<T, BN, D, LD>(nxt, kb, p.k_ss, kv0 + BN, p.S, p.Dh);
      load_tile_async<T, BN, D, LD>(nxt + BN * LD, vb, p.v_ss, kv0 + BN,
                                    p.S, p.Dv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* Ks = KVs + stage * 2 * BN * LD;
    const T* Vs = Ks + BN * LD;

    // s = q k^T for this warp's 16 rows x BN keys
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      if (kk < dh_steps) {
        uint32_t a[4];
        ldmatrix_x4(a, Qs + (warp * 16 + lrow + (lmat & 1) * 8) * LD +
                           kk * 16 + (lmat >> 1) * 8);
#pragma unroll
        for (int np = 0; np < BN / 16; ++np) {
          uint32_t kf[4];
          ldmatrix_x4(kf, Ks + (np * 16 + lrow + (lmat >> 1) * 8) * LD +
                              kk * 16 + (lmat & 1) * 8);
          Ops<T>::mma(s[2 * np], a, kf[0], kf[1]);
          Ops<T>::mma(s[2 * np + 1], a, kf[2], kf[3]);
        }
      }
    }

    // scores in the log2 domain (x * log2(e)), softcapped, then masked
    // where this warp's rows can miss a key of the tile: a tile of keys
    // every row sees (most of a causal prefill) skips the mask
    if (p.softcap != 0.f) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = tanhf(s[n][e] * p.scale / p.softcap) * p.softcap * kLog2e;
    } else {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale_log2;
    }
    int any0 = 1, any1 = 1;
    const bool full = wq_lo >= 0 && kv0 + BN - 1 <= wq_lo && kv0 + BN <= p.S &&
                      (!p.has_window || kv0 > (long long)wq_hi - p.window);
    if (!full) {
      any0 = any1 = 0;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = visible(kv0 + n * 8 + tig * 2 + (e & 1),
                                  e < 2 ? qr0 : qr1, p.S, p);
          s[n][e] = ok ? s[n][e] : kNegInf;
          if (e < 2)
            any0 |= ok;
          else
            any1 |= ok;
        }
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      any0 |= __shfl_xor_sync(0xffffffffu, any0, off);
      any1 |= __shfl_xor_sync(0xffffffffu, any1, off);
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float pe;
        if (e < 2) {
          pe = any0 ? exp2f(s[n][e] - mn0) : 0.f;
          rs0 += pe;
        } else {
          pe = any1 ? exp2f(s[n][e] - mn1) : 0.f;
          rs1 += pe;
        }
        s[n][e] = pe;
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
      rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
    }
    l0 = l0 * c0 + rs0;
    l1 = l1 * c1 + rs1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= c0;
      acc[n][1] *= c0;
      acc[n][2] *= c1;
      acc[n][3] *= c1;
    }

    // acc += p v: p (cast to T) from the score registers, v through
    // transposing ldmatrix, two 8-column tiles of v per load
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {Ops<T>::pack(s[2 * kk][0], s[2 * kk][1]),
                             Ops<T>::pack(s[2 * kk][2], s[2 * kk][3]),
                             Ops<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             Ops<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        if (2 * np < dv_tiles) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, Vs + (kk * 16 + lrow + (lmat & 1) * 8) * LD +
                                    np * 16 + (lmat >> 1) * 8);
          Ops<T>::mma(acc[2 * np], a, vf[0], vf[1]);
          Ops<T>::mma(acc[2 * np + 1], a, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();                        // this stage is free again
  }
  cp_async_wait<0>();   // a block that saw no key still owns its Q load

  // o = acc / l, or 0 where no key was visible
  T* ob = (T*)p.o + b * p.o_sb + h * p.o_sh;
  const int r0 = t0 + warp * 16 + g, r1 = r0 + 8;
  if (tig == 0) {
    write_lse(p, b, h, r0, m0, l0, true);
    write_lse(p, b, h, r1, m1, l1, true);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    if (n < dv_tiles) {
      const int col = n * 8 + tig * 2;
      if (r0 < p.T) {
        const float x0 = l0 > 0.f ? acc[n][0] / l0 : 0.f;
        const float x1 = l0 > 0.f ? acc[n][1] / l0 : 0.f;
        *reinterpret_cast<uint32_t*>(ob + r0 * p.o_st + col) =
            Ops<T>::pack(x0, x1);
      }
      if (r1 < p.T) {
        const float x2 = l1 > 0.f ? acc[n][2] / l1 : 0.f;
        const float x3 = l1 > 0.f ? acc[n][3] / l1 : 0.f;
        *reinterpret_cast<uint32_t*>(ob + r1 * p.o_st + col) =
            Ops<T>::pack(x2, x3);
      }
    }
  }
}

// float32: 16 query rows x 32 keys per tile, FFMA.
constexpr int kRowsF = 16, kKeysF = 32;

template <int D>
__global__ void __launch_bounds__(kThreads)
fa_f32_kernel(const Params p) {
  constexpr int LDK = D + 1;                // odd pitch: conflict-free rows
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);          // [kRowsF][LDK]
  float* Ks = Qs + kRowsF * LDK;                        // [kKeysF][LDK]
  float* Vs = Ks + kKeysF * LDK;                        // [kKeysF][D]
  float* Ps = Vs + kKeysF * D;                          // [kRowsF][kKeysF+1]
  __shared__ int qpos_s[kRowsF];
  __shared__ int ok_s[kRowsF][kKeysF];
  __shared__ float m_s[kRowsF], l_s[kRowsF], c_s[kRowsF];
  __shared__ int lo_s, hi_s;

  const int tid = threadIdx.x;
  const int b = blockIdx.z, h = blockIdx.y, t0 = blockIdx.x * kRowsF;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qb = (const float*)p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = (const float*)p.k + b * p.k_sb + hk * p.k_sh;
  const float* vb = (const float*)p.v + b * p.v_sb + hk * p.v_sh;

  long long key_begin, key_end;
  key_range<kRowsF>(p, b, t0, qpos_s, &lo_s, &hi_s, &key_begin, &key_end);
  for (int i = tid; i < kRowsF * D; i += kThreads) {
    const int r = i / D, d = i % D;
    Qs[r * LDK + d] = (t0 + r < p.T && d < p.Dh)
                          ? qb[(long long)(t0 + r) * p.q_st + d] : 0.f;
  }
  if (tid < kRowsF) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // score (row, key_j) for key_j = tid % 8 + 8 j; output (row, col_j)
  // for col_j = tid % 8 + 8 j
  const int row = tid / 8, lane8 = tid % 8;
  float acc[D / 8];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j] = 0.f;

  const long long tile_end = (key_end + kKeysF - 1) / kKeysF;
  for (long long tile = key_begin / kKeysF; tile < tile_end; ++tile) {
    const long long kv0 = tile * kKeysF;
    __syncthreads();
    for (int i = tid; i < kKeysF * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = kv0 + r < p.S;
      Ks[r * LDK + d] = (in && d < p.Dh) ? kb[(kv0 + r) * p.k_ss + d] : 0.f;
      Vs[r * D + d] = (in && d < p.Dv) ? vb[(kv0 + r) * p.v_ss + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKeysF / 8; ++j) {
      const int kj = lane8 + 8 * j;
      float x = 0.f;
      for (int d = 0; d < p.Dh; ++d)
        x = fmaf(Qs[row * LDK + d], Ks[kj * LDK + d], x);
      x *= p.scale;
      if (p.softcap != 0.f) x = tanhf(x / p.softcap) * p.softcap;
      const bool ok = visible(kv0 + kj, qpos_s[row], p.S, p);
      Ps[row * (kKeysF + 1) + kj] = ok ? x : kNegInf;
      ok_s[row][kj] = ok;
    }
    __syncthreads();
    if (tid < kRowsF) {                     // the online softmax, by row
      float* pr = Ps + tid * (kKeysF + 1);
      float mx = kNegInf;
      int any = 0;
      for (int j = 0; j < kKeysF; ++j) {
        mx = fmaxf(mx, pr[j]);
        any |= ok_s[tid][j];
      }
      const float mp = m_s[tid], mn = fmaxf(mp, mx);
      float rs = 0.f;
      for (int j = 0; j < kKeysF; ++j) {
        const float pe = any ? expf(pr[j] - mn) : 0.f;
        pr[j] = pe;
        rs += pe;
      }
      const float c = expf(mp - mn);
      c_s[tid] = c;
      l_s[tid] = l_s[tid] * c + rs;
      m_s[tid] = mn;
    }
    __syncthreads();
    const float c = c_s[row];
    const float* pr = Ps + row * (kKeysF + 1);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = lane8 + 8 * j;
      if (col < p.Dv) {
        float pv = 0.f;
        for (int kj = 0; kj < kKeysF; ++kj)
          pv = fmaf(pr[kj], Vs[kj * D + col], pv);
        acc[j] = acc[j] * c + pv;
      }
    }
  }
  __syncthreads();
  const int t = t0 + row;
  if (lane8 == 0) write_lse(p, b, h, t, m_s[row], l_s[row], false);
  if (t < p.T) {
    const float l = l_s[row];
    float* orow = (float*)p.o + b * p.o_sb + h * p.o_sh + t * p.o_st;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = lane8 + 8 * j;
      if (col < p.Dv) orow[col] = l > 0.f ? acc[j] / l : 0.f;
    }
  }
}

// ---- the wgmma variant ---------------------------------------------------
namespace wg {

constexpr int kConsumers = 2;                 // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;        // query rows per block
// 64 keys per stage: 128 would put the scores, the p fragments and the
// output accumulator of two products in flight past what ptxas fits
// without serialising the wgmmas (measured slower, PERF.md).  At Dh 256
// (O alone 128 registers a thread) 64 keys take 252 registers, and
// measured faster than 48 or 32 (PERF.md); a third K/V stage would pass
// the 227 KB of shared memory there.
constexpr int kKeys = 64;
// Two K/V stages.  At Dh 192 / Dv 128 they take 128 KB of shared memory
// and three would take 168 KB, but three measured no faster
// (tools/flash_mla_stages.py, PERF.md).
constexpr int kStages = 2;
// Each instantiation takes two head widths: DK, the depth of q k^T, and
// DV, the width of p v; Dh = Dv gives DK = DV.  DK = 192 with DV = 128
// is MLA's naive form (deepseek-v3), where Hq = Hkv: no GQA group shares
// a K/V tile, so the grid makes one (b, head)'s query tiles neighbours
// (kHeadMajor) and its K/V stays in L2 while they run, and the last 64
// columns of Q and K, the RoPE part, come from tensor maps of their own
// (kSplitRope), so the caller need not concatenate them.
template <int DK, int DV>
constexpr bool kHeadMajor = DK != DV;
template <int DK, int DV>
constexpr bool kSplitRope = DK != DV;
// At Dv 64 and 128 a third warpgroup, last in the block, is the
// producer, and setmaxnreg hands its registers to the consumers (24 /
// 240).  At Dh 256 ptxas does not compile the consumers within
// setmaxnreg's 240 (it spills and serialises the wgmmas, even at 32-key
// tiles, while the same code fits 240 registers without setmaxnreg;
// PERF.md), and a block of 9 warps is still allotted registers as 12
// (168 a thread).  So there the block is the two consumer warpgroups
// alone, up to 255 registers a thread, and their thread 0 issues the
// copies between its own products.  What a consumer holds depends on DV
// (O's DV / 2 accumulators), so 192 / 128 has the producer warpgroup.
template <int DV>
constexpr bool kProducerWarpgroup = DV != 256;
template <int DV>
constexpr int kThreads = 128 * (kProducerWarpgroup<DV> ? kConsumers + 1
                                                   : kConsumers);
constexpr int kPanel = 64;      // head-dim elements in one 128-byte row

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes).  A tile of R rows and
// D = 64 c head-dim elements is c panels of R rows x 128 bytes: TMA
// writes one panel per copy, and wgmma reads it through descriptors.
// K stages are DK wide, V stages DV wide.
template <int DK, int DV>
struct Layout {
  static constexpr int kQBytes = kRows * DK * 2;
  static constexpr int kKBytes = kKeys * DK * 2;
  static constexpr int kVBytes = kKeys * DV * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQBytes;                    // + stage * kKBytes
  static constexpr int kV = kK + kStages * kKBytes;     // + stage * kVBytes
  // mbarriers: Q full, then K full, V full, K free, V free [kStages]
  static constexpr int kBar = kV + kStages * kVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
};

__device__ __forceinline__ uint32_t bar_k(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
__device__ __forceinline__ uint32_t bar_v(uint32_t bars, int s) {
  return bars + 8 * (1 + kStages + s);
}
__device__ __forceinline__ uint32_t bar_k_free(uint32_t bars, int s) {
  return bars + 8 * (1 + 2 * kStages + s);
}
__device__ __forceinline__ uint32_t bar_v_free(uint32_t bars, int s) {
  return bars + 8 * (1 + 3 * kStages + s);
}


// Issues s = q k^T for this warpgroup's 64 rows and the kKeys keys of a
// K stage (DK / 16 steps of k16) and commits it as one wgmma group.  The
// descriptors are rebuilt from their base in every call, so the
// compiler keeps two registers for them, not sixteen.
template <typename T, int DK>
__device__ __forceinline__ void issue_qk(float (&sc)[kKeys / 2],
                                         uint64_t q_desc, uint64_t k_desc) {
  asm volatile("" : "+l"(q_desc), "+l"(k_desc));
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk)
    wgmma_ss<T>(sc, q_desc + (((kk / 4) * kRows * 128 + (kk % 4) * 32) >> 4),
                k_desc + (((kk / 4) * kKeys * 128 + (kk % 4) * 32) >> 4),
                kk > 0);
  wgmma_commit();
}

// Issues acc += p v for a V stage (read MN-major, that is transposed)
// with p in registers, keys 16 kk .. 16 kk + 15 in pf[4 kk .. 4 kk + 3],
// and commits it as one wgmma group.
template <typename T, int DV>
__device__ __forceinline__ void issue_pv(float (&acc)[DV / 2],
                                         const uint32_t (&pf)[kKeys / 4],
                                         uint64_t v_desc) {
  asm volatile("" : "+l"(v_desc));
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
    wgmma_rs<T>(acc, &pf[4 * kk], v_desc + ((kk * 16 * 128) >> 4));
  wgmma_commit();
}

// One consumer thread's two rows: row g and g + 8 of its warp's 16
// (accumulator element 4n + e is row g for e < 2, else g + 8, column
// 8n + 2 tig + (e & 1)).  Row i sees exactly the keys in (lo_i, hi_i]:
// hi = min(qpos, S - 1), or -1 for a padding row; lo = qpos - window
// with a window, else -1, clamped to [-1, hi].
struct Rows {
  int lo0, hi0, lo1, hi1;
  int full_lo, full_hi;   // a tile within [full_lo, full_hi] needs no mask
  int tig;
  float m0, m1, l0, l1;
};

__device__ __forceinline__ void row_bounds(int qp, const Params& p, int& lo,
                                           int& hi) {
  hi = qp < 0 ? -1 : min(qp, p.S - 1);
  long long l = p.has_window && qp >= 0 ? (long long)qp - p.window : -1;
  lo = (int)(l < -1 ? -1 : (l > hi ? hi : l));
}

// How a tile's scores q.k become logits in log2 units: times `in`, or
// with the softcap tanh(q.k * `in`) * `out` (`in` = 2 log2(e) scale /
// softcap, `out` = softcap log2(e)).
struct Logits {
  float in, out;
};

// The online softmax of one tile, in place: sc holds q.k of the rows
// against keys kv0 .. kv0 + kKeys - 1 on entry and p on exit; m and l
// move on, and c0, c1 get the factors that rescale the rows' earlier
// output.  The softcap is a template argument, so a launch without one
// carries no tanh code (whose registers would crowd the wgmmas').
template <bool kSoftcap>
__device__ __forceinline__ void softmax_tile(float (&sc)[kKeys / 2], int kv0,
                                             Rows& r, const Logits& lg,
                                             float& c0, float& c1) {
  // scores in the log2 domain, softcapped, then masked where this
  // warp's rows can miss a key of the tile
  if (kSoftcap) {
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j)
      sc[j] = tanh_2log2e(sc[j] * lg.in) * lg.out;
  } else {
#pragma unroll
    for (int j = 0; j < kKeys / 2; ++j) sc[j] *= lg.in;
  }
  int any0 = 1, any1 = 1;
  if (kv0 < r.full_lo || kv0 + kKeys - 1 > r.full_hi) {
    any0 = any1 = 0;
    const int key0 = kv0 + r.tig * 2;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + n * 8 + (e & 1);
        const bool ok = e < 2 ? key > r.lo0 && key <= r.hi0
                              : key > r.lo1 && key <= r.hi1;
        sc[4 * n + e] = ok ? sc[4 * n + e] : kNegInf;
        if (e < 2)
          any0 |= ok;
        else
          any1 |= ok;
      }
  }
  // row maxima and sums in two independent chains each (even and odd
  // 8-column groups), so their latencies overlap
  float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
    mx[n & 1] = fmaxf(mx[n & 1], fmaxf(sc[4 * n], sc[4 * n + 1]));
    mx[2 + (n & 1)] = fmaxf(mx[2 + (n & 1)], fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
  }
  float mx0 = fmaxf(mx[0], mx[1]), mx1 = fmaxf(mx[2], mx[3]);
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    any0 |= __shfl_xor_sync(0xffffffffu, any0, off);
    any1 |= __shfl_xor_sync(0xffffffffu, any1, off);
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  c0 = ex2(r.m0 - mn0);
  c1 = ex2(r.m1 - mn1);
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = (e < 2 ? any0 : any1)
                           ? ex2(sc[4 * n + e] - (e < 2 ? mn0 : mn1))
                           : 0.f;
      rs[(e < 2 ? 0 : 2) + (n & 1)] += pe;
      sc[4 * n + e] = pe;
    }
  float rs0 = rs[0] + rs[1], rs1 = rs[2] + rs[3];
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, off);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, off);
  }
  r.l0 = r.l0 * c0 + rs0;
  r.l1 = r.l1 * c1 + rs1;
  r.m0 = mn0;
  r.m1 = mn1;
}

// p in T, packed from the score registers into the A fragments of p v
template <typename T>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[kKeys / 4],
                                       const float (&sc)[kKeys / 2]) {
#pragma unroll
  for (int j = 0; j < kKeys / 4; ++j)
    pf[j] = Ops<T>::pack(sc[2 * j], sc[2 * j + 1]);
}


// The block's copies into shared memory, each issued by one thread: Q
// once, and tile j's K or V into stage j % kStages once every consumer
// warp has freed that stage of tile j - kStages.  With kSplitRope the
// last panel of Q and K comes from the RoPE maps (qr, kr): K's from kv
// head hr, 0 where every head shares one RoPE key.  The panels land
// where the concatenated operands' would, so the products are the same.
template <int DK, int DV>
struct Loader {
  using L = Layout<DK, DV>;
  const CUtensorMap *q, *k, *v, *qr, *kr;
  uint32_t base, bars;
  int tile_first, h, hk, hr, t0, b;

  static __device__ __forceinline__ bool rope_panel(int c) {
    return kSplitRope<DK, DV> && c == DK / kPanel - 1;
  }
  __device__ __forceinline__ void load_q() const {
    mbar_expect_tx(bars, L::kQBytes);
#pragma unroll
    for (int c = 0; c < DK / kPanel; ++c)
      tma_load_4d(base + L::kQ + c * kRows * 128, rope_panel(c) ? qr : q,
                  bars, rope_panel(c) ? 0 : c * kPanel, h, t0, b);
  }
  template <bool kIsV>
  __device__ __forceinline__ void load(int j) const {
    constexpr int kBytes = kIsV ? L::kVBytes : L::kKBytes;
    const int s = j % kStages;
    const uint32_t full = kIsV ? bar_v(bars, s) : bar_k(bars, s);
    mbar_wait(kIsV ? bar_v_free(bars, s) : bar_k_free(bars, s),
              ((j / kStages) & 1) ^ 1);
    mbar_expect_tx(full, kBytes);
    const uint32_t dst = base + (kIsV ? L::kV : L::kK) + s * kBytes;
    const int kv0 = (tile_first + j) * kKeys;
#pragma unroll
    for (int c = 0; c < (kIsV ? DV : DK) / kPanel; ++c) {
      const bool rope = !kIsV && rope_panel(c);
      tma_load_4d(dst + c * kKeys * 128, kIsV ? v : (rope ? kr : k), full,
                  rope ? 0 : c * kPanel, rope ? hr : hk, kv0, b);
    }
  }
};

template <typename T, int DK, int DV, bool kSoftcap>
__global__ void __launch_bounds__(kThreads<DV>, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_qr,
                const __grid_constant__ CUtensorMap tm_kr, const Params p) {
  using L = Layout<DK, DV>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ int qpos_s[kRows];
  __shared__ int lo_s, hi_s;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;

  const int tid = threadIdx.x;
  // longest first: the query tile counted from the last.  kHeadMajor:
  // a (b, head)'s tiles are neighbours, the tile the fast index; else
  // the tile is the slow one and a GQA group's heads are neighbours
  int bh, t0;
  if constexpr (kHeadMajor<DK, DV>) {
    const int q_tiles = (p.T + kRows - 1) / kRows;
    bh = blockIdx.x / q_tiles;
    t0 = (q_tiles - 1 - (int)(blockIdx.x % q_tiles)) * kRows;
  } else {
    bh = blockIdx.x;
    t0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  }
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  if (tid == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(bars, s), 1);
      mbar_init(bar_v(bars, s), 1);
      // one arrival per consumer warp
      mbar_init(bar_k_free(bars, s), 4 * kConsumers);
      mbar_init(bar_v_free(bars, s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  long long key_begin, key_end;   // key_range's barriers publish the inits
  key_range<kRows>(p, b, t0, qpos_s, &lo_s, &hi_s, &key_begin, &key_end);
  const int tile_first = (int)(key_begin / kKeys);
  const int n_tiles = (int)((key_end + kKeys - 1) / kKeys) - tile_first;
  const Loader<DK, DV> ld{&tm_q, &tm_k, &tm_v, &tm_qr, &tm_kr, base, bars,
                          tile_first, h, hk, p.k_rope ? 0 : hk, t0, b};

  if (kProducerWarpgroup<DV> && tid >= kConsumers * 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    if constexpr (kProducerWarpgroup<DV>)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128 && n_tiles > 0) {
      ld.load_q();
      for (int i = 0; i < n_tiles; ++i) {
        ld.template load<false>(i);
        ld.template load<true>(i);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    if constexpr (kProducerWarpgroup<DV>)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    // without a producer warpgroup thread 0 issues the copies: Q and the
    // first kStages tiles now, tile i + kStages - 1's K as tile i starts
    // (its stage freed by tile i - 1's q k^T), and tile i - 1 +
    // kStages's V once tile i - 1's p v is done
    const bool producer = !kProducerWarpgroup<DV> && tid == 0;
    if (producer && n_tiles > 0) {
      ld.load_q();
      for (int j = 0; j < kStages && j < n_tiles; ++j) {
        ld.template load<false>(j);
        ld.template load<true>(j);
      }
    }
    const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int row0 = wgi * 64 + warp * 16 + (lane >> 2);   // and row0 + 8
    Rows r;
    row_bounds(qpos_s[row0], p, r.lo0, r.hi0);
    row_bounds(qpos_s[row0 + 8], p, r.lo1, r.hi1);
    // a tile needs no mask when every row of the warp sees all its
    // keys: from the largest lo + 1 to the smallest hi of the 16 rows
    {
      int lo, hi;
      row_bounds(qpos_s[wgi * 64 + warp * 16 + (lane & 15)], p, lo, hi);
#pragma unroll
      for (int off = 1; off <= 8; off <<= 1) {
        lo = max(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = min(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      r.full_lo = lo + 1;
      r.full_hi = hi;
    }
    r.tig = lane & 3;
    r.m0 = r.m1 = kNegInf;
    r.l0 = r.l1 = 0.f;
    const Logits lg =
        kSoftcap ? Logits{2.f * kLog2e * p.scale / p.softcap,
                          p.softcap * kLog2e}
                 : Logits{p.scale * kLog2e, 0.f};
    const uint64_t q_desc = sw128_desc(base + L::kQ + wgi * 64 * 128, 16);
    const uint64_t k_desc = sw128_desc(base + L::kK, 16);
    const uint64_t v_desc = sw128_desc(base + L::kV, kKeys * 128);
    // stage steps in descriptor units
    constexpr uint32_t kKStep = L::kKBytes >> 4, kVStep = L::kVBytes >> 4;

    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    if (n_tiles > 0) {
      float sc[kKeys / 2];
      uint32_t pf[kKeys / 4];
      float c0, c1;
      // tile 0: s = q k^T and its p
      mbar_wait(bars, 0);
      mbar_wait(bar_k(bars, 0), 0);
      wgmma_fence();
      issue_qk<T, DK>(sc, q_desc, k_desc);
      wgmma_wait<0>();
      fence_regs(sc);
      release(bar_k_free(bars, 0));
      softmax_tile<kSoftcap>(sc, tile_first * kKeys, r, lg, c0, c1);
      pack_p<T>(pf, sc);
      // tile i: q k_i^T and p_{i-1} v_{i-1} in flight together
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % kStages, sp = (i - 1) % kStages;
        if (producer && i + kStages - 1 < n_tiles)
          ld.template load<false>(i + kStages - 1);
        mbar_wait(bar_k(bars, s), (i / kStages) & 1);
        mbar_wait(bar_v(bars, sp), ((i - 1) / kStages) & 1);
        fence_regs(acc);
        fence_regs(pf);
        wgmma_fence();
        issue_qk<T, DK>(sc, q_desc, k_desc + s * kKStep);
        issue_pv<T, DV>(acc, pf, v_desc + sp * kVStep);
        wgmma_wait<1>();               // q k_i^T is done
        fence_regs(sc);
        release(bar_k_free(bars, s));
        softmax_tile<kSoftcap>(sc, (tile_first + i) * kKeys, r, lg, c0, c1);
        wgmma_wait<0>();               // p_{i-1} v_{i-1} is done
        fence_regs(acc);
        fence_regs(pf);
        release(bar_v_free(bars, sp));
        if (producer && i - 1 + kStages < n_tiles)
          ld.template load<true>(i - 1 + kStages);
#pragma unroll
        for (int n = 0; n < DV / 8; ++n) {
          acc[4 * n] *= c0;
          acc[4 * n + 1] *= c0;
          acc[4 * n + 2] *= c1;
          acc[4 * n + 3] *= c1;
        }
        pack_p<T>(pf, sc);
      }
      // the last tile's p v
      const int s = (n_tiles - 1) % kStages;
      mbar_wait(bar_v(bars, s), ((n_tiles - 1) / kStages) & 1);
      fence_regs(acc);
      fence_regs(pf);
      wgmma_fence();
      issue_pv<T, DV>(acc, pf, v_desc + s * kVStep);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pf);
    }

    // o = acc / l, as acc times 1 / l (one division a row, not one an
    // element), or 0 where no key was visible
    T* ob = (T*)p.o + b * p.o_sb + h * p.o_sh;
    const int r0 = t0 + row0, r1 = r0 + 8;
    if (r.tig == 0) {
      write_lse(p, b, h, r0, r.m0, r.l0, true);
      write_lse(p, b, h, r1, r.m1, r.l1, true);
    }
    const float inv0 = r.l0 > 0.f ? 1.f / r.l0 : 0.f;
    const float inv1 = r.l1 > 0.f ? 1.f / r.l1 : 0.f;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + r.tig * 2;
      if (r0 < p.T)
        *reinterpret_cast<uint32_t*>(ob + r0 * p.o_st + col) =
            Ops<T>::pack(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r1 < p.T)
        *reinterpret_cast<uint32_t*>(ob + r1 * p.o_st + col) =
            Ops<T>::pack(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

}  // namespace wg

template <typename T, int DK, int DV>
int launch_wgmma(const Params& p, cudaStream_t stream) {
  constexpr CUtensorMapDataType type =
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const long long q_tiles = (p.T + wg::kRows - 1) / wg::kRows;
  const long long bh = (long long)p.B * p.Hq;
  if (wg::kHeadMajor<DK, DV> ? q_tiles * bh > INT_MAX
                             : q_tiles > 65535 || bh > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  // With kSplitRope the q and k maps span the first DK - 64 columns and
  // the RoPE maps the last 64: of q_rope and k_rope where the caller
  // passes them, else of q and k themselves, 64 columns in
  constexpr int kNope = wg::kSplitRope<DK, DV> ? DK - wg::kPanel : DK;
  CUtensorMap mq, mk, mv, mqr, mkr;
  int e = make_map(&mq, p.q, type, kNope, p.Hq, p.T, p.B, p.q_sh, p.q_st,
                   p.q_sb, wg::kRows);
  if (e == 0)
    e = make_map(&mk, p.k, type, kNope, p.Hkv, p.S, p.B, p.k_sh, p.k_ss,
                 p.k_sb, wg::kKeys);
  if (e == 0)
    e = make_map(&mv, p.v, type, DV, p.Hkv, p.S, p.B, p.v_sh, p.v_ss,
                 p.v_sb, wg::kKeys);
  if (e == 0 && wg::kSplitRope<DK, DV>) {
    if (p.q_rope != nullptr) {
      e = make_map(&mqr, p.q_rope, type, wg::kPanel, p.Hq, p.T, p.B,
                   p.qr_sh, p.qr_st, p.qr_sb, wg::kRows);
      if (e == 0)
        e = make_map(&mkr, p.k_rope, type, wg::kPanel, 1, p.S, p.B,
                     p.kr_sh, p.kr_ss, p.kr_sb, wg::kKeys);
    } else {
      e = make_map(&mqr, (const T*)p.q + kNope, type, wg::kPanel, p.Hq,
                   p.T, p.B, p.q_sh, p.q_st, p.q_sb, wg::kRows);
      if (e == 0)
        e = make_map(&mkr, (const T*)p.k + kNope, type, wg::kPanel, p.Hkv,
                     p.S, p.B, p.k_sh, p.k_ss, p.k_sb, wg::kKeys);
    }
  } else {
    mqr = mq;
    mkr = mk;
  }
  if (e != 0) return e;
  // + the base's alignment
  const int smem = wg::Layout<DK, DV>::kBytes + 1024;
  auto kern = p.softcap != 0.f ? wg::fa_wgmma_kernel<T, DK, DV, true>
                               : wg::fa_wgmma_kernel<T, DK, DV, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = wg::kHeadMajor<DK, DV>
                        ? dim3((unsigned)(q_tiles * bh))
                        : dim3((unsigned)bh, (unsigned)q_tiles);
  kern<<<grid, wg::kThreads<DV>, smem, stream>>>(mq, mk, mv, mqr, mkr, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_mma(const Params& p, cudaStream_t stream) {
  constexpr int BN = D > 128 ? 32 : 64;
  const int smem = (kRows + 4 * BN) * (D + 8) * (int)sizeof(T);
  auto kern = fa_mma_kernel<T, D, BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.T + kRows - 1) / kRows, p.Hq, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = ((kRowsF + kKeysF) * (D + 1) + kKeysF * D +
                    kRowsF * (kKeysF + 1)) * (int)sizeof(float);
  auto kern = fa_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.T + kRowsF - 1) / kRowsF, p.Hq, p.B);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch(int variant, int dtype, const Params& p, cudaStream_t stream) {
  switch (variant * 3 + dtype) {
    case 0 * 3 + 0: return launch_f32<D>(p, stream);
    case 1 * 3 + 1: return launch_mma<__nv_bfloat16, D>(p, stream);
    case 1 * 3 + 2: return launch_mma<__half, D>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// variant: 0 ffma (float32), 1 mma_sync (16-bit, head dims wgmma does
// not take), 2 wgmma (16-bit, Dh = Dv in {64, 128, 256}, or Dh 192 /
// Dv 128), as the caller chose it from the types and head dims; any
// other pairing returns cudaErrorInvalidValue and launches nothing.
// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike).
// q_rope, k_rope: null, or (wgmma at 192 / 128 alone) the RoPE columns
// of q and k as operands of their own: q (B, T, Hq, 128) and q_rope
// (B, T, Hq, 64), k (B, S, Hkv, 128) and k_rope (B, S, 1, 64), whose
// one head every query head reads; Dh is then q's width, 128, and Dr
// 64, and the logits are (q.k + q_rope.k_rope) * scale.  Dr is 0
// without them.
// strides: 20 element strides, (batch, position, head) of q, k, v and
// o, then (batch, position) of qpos (int32), then (batch, position,
// head) of q_rope and k_rope (ignored when they are null); every last
// dim is unit-stride.  has_window = 0 means causal only.  ffma and
// mma_sync compile the head width as the smallest of 64, 128, 256 that
// holds max(Dh, Dv).  The caller checks Dh, Dv <= 256, multiples of 8,
// Hq % Hkv == 0, 16-byte aligned rows for 16-bit types, and grid
// limits.
// lse: null, or (B, Hq, T) float32 contiguous for the rows' log-sum-exp.
// Returns cudaGetLastError() after the launch, or a negative code when
// a TMA tensor map could not be built (-1: no cuTensorMapEncodeTiled in
// the driver; -1000 - r: it returned CUresult r).
extern "C" int flash_attn_hd(const void* q, const void* k, const void* v,
                             const void* q_rope, const void* k_rope,
                             const int* qpos, void* o, void* lse,
                             int variant,
                             int dtype, int B, int T, int S, int Hq, int Hkv,
                             int Dh, int Dv, int Dr,
                             const long long* strides,
                             float scale, float softcap, int has_window,
                             long long window, void* stream) {
  if (B <= 0 || T <= 0 || Hq <= 0) return 0;
  Params p{q, k, v, qpos, o, (float*)lse, B, T, S, Hq, Hkv, Dh, Dv,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13],
           scale, softcap, has_window, window, q_rope, k_rope,
           strides[14], strides[15], strides[16], strides[17], strides[18],
           strides[19]};
  cudaStream_t s = (cudaStream_t)stream;
  const bool split = q_rope != nullptr;
  if (split != (k_rope != nullptr) || split != (Dr != 0) ||
      (split && variant != 2))
    return (int)cudaErrorInvalidValue;
  const bool wgmma_dims = Dh == Dv && (Dh == 64 || Dh == 128 || Dh == 256);
  const bool wgmma_mla = Dv == 128 && (split ? Dh == 128 && Dr == 64
                                             : Dh == 192);
  if ((variant == 2) != (dtype != 0 && ((wgmma_dims && !split) || wgmma_mla)))
    return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    if (wgmma_mla)
      return dtype == 1 ? launch_wgmma<__nv_bfloat16, 192, 128>(p, s)
                        : launch_wgmma<__half, 192, 128>(p, s);
    if (Dh == 64)
      return dtype == 1 ? launch_wgmma<__nv_bfloat16, 64, 64>(p, s)
                        : launch_wgmma<__half, 64, 64>(p, s);
    if (Dh == 128)
      return dtype == 1 ? launch_wgmma<__nv_bfloat16, 128, 128>(p, s)
                        : launch_wgmma<__half, 128, 128>(p, s);
    return dtype == 1 ? launch_wgmma<__nv_bfloat16, 256, 256>(p, s)
                      : launch_wgmma<__half, 256, 256>(p, s);
  }
  const int width = Dh > Dv ? Dh : Dv;
  if (width <= 64) return launch<64>(variant, dtype, p, s);
  if (width <= 128) return launch<128>(variant, dtype, p, s);
  return launch<256>(variant, dtype, p, s);
}
