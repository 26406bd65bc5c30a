// Causal / windowed GQA attention with a per-row query position, the
// forward of flash attention: o (B, T, Hq, Dv) from q (B, T, Hq, Dh),
// k (B, S, Hkv, Dh), v (B, S, Hkv, Dv) and qpos (B, T).
//
// Replaces the TPU kernel `flash_attention_pallas` / `_fa_kernel` in
// src/repro/kernels/flash_attention/kernel.py, and computes what it
// computes: a blockwise online softmax with float32 m, l and acc;
// q.k in float32, times `scale`, then an optional tanh softcap; the
// mask kpos <= qpos, kpos >= 0, qpos >= 0 and, with a window,
// kpos > qpos - window; masked logits -1e30; p cast to v's dtype
// before p.v, which accumulates in float32; rows with no unmasked key
// write exactly 0; query head h reads kv head h / (Hq / Hkv); a qpos
// of -1 marks a padding row.
//
// Bound on an H100: operations at the serving path's prefill shapes.
// A 2048-token causal prefill does 4 * Dh flops for each of T(T+1)/2
// unmasked pairs per head, about 1000 flops per byte of q, k, v and o
// at Dh = 128, far above the card's 295 flops per byte in bf16; its
// floor is the 989 TFLOP/s dense bf16 tensor-core peak.  Decode (one
// query row) would be byte-bound, but decode runs the dense path.
//
// Design (bf16 and fp16): one block of 4 warps per (b, h, 64 query
// rows), each warp owning 16 rows.  Q stays in shared memory; K and V
// tiles of 64 keys (32 at head dims above 128) stream through two
// shared-memory stages with cp.async, the next tile in flight while
// the current one is used.  Rows are padded by 8 elements so ldmatrix
// reads them free of bank conflicts: ldmatrix.x4 gives the A fragments
// of q and the B fragments of k, ldmatrix.x4.trans those of v, so one
// shared-memory instruction feeds two mma.sync m16n8k16 with float32
// accumulation (a product of two bf16 values is exact in float32, so
// this is the TPU kernel's math).  The scores stay in registers, in
// the log2 domain, so each probability is one exp2 (p is rounded to
// 16 bits before p.v, far coarser than the change of base); the mask
// is applied only to the tiles where some row of the warp can miss a
// key.  The online softmax reduces each row over the 4 threads of a
// quad, and the probabilities are packed from the score accumulators
// straight into the A fragments of p.v.  The kv loop runs only over the tiles
// that hold a visible key: from the block's smallest query position
// minus the window (when there is one) to its largest query position,
// both read from qpos, never assumed to be arange; so a causal prefill
// does about half the tiles and a padding block none.  Head dims are
// padded with zeros to a compiled width of 64, 128 or 256.  mma.sync
// reads every k and v fragment from shared memory once per warp, so
// shared-memory bandwidth, not the tensor cores, bounds this design on
// Hopper; wgmma (which reads B from shared memory once per warpgroup),
// TMA and warp specialisation are later work.
//
// float32 inputs take a plain FFMA loop (blocks of 16 query rows, 32
// keys), not TF32, which would miss the reference's 2e-5 bound.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kRows = 64;          // query rows per block, 16 per warp

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* qpos;
  void* o;
  int B, T, S, Hq, Hkv, Dh, Dv;
  // element strides: batch, position, head (the last dim is unit-stride)
  long long q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh, p_sb, p_st;
  float scale, softcap;
  int has_window;
  long long window;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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
int launch(int dtype, const Params& p, cudaStream_t stream) {
  switch (dtype) {
    case 0: return launch_f32<D>(p, stream);
    case 1: return launch_mma<__nv_bfloat16, D>(p, stream);
    case 2: return launch_mma<__half, D>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (q, k, v and o alike).
// strides: 14 element strides, (batch, position, head) of q, k, v and
// o, then (batch, position) of qpos (int32); every last dim is
// unit-stride.  has_window = 0 means causal only.  The compiled head
// width is the smallest of 64, 128, 256 that holds max(Dh, Dv); the
// caller checks Dh, Dv <= 256, multiples of 8, Hq % Hkv == 0, 16-byte
// aligned rows for 16-bit types, and grid limits.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_hd(const void* q, const void* k, const void* v,
                             const int* qpos, void* o, int dtype, int B,
                             int T, int S, int Hq, int Hkv, int Dh, int Dv,
                             const long long* strides, float scale,
                             float softcap, int has_window, long long window,
                             void* stream) {
  if (B <= 0 || T <= 0 || Hq <= 0) return 0;
  Params p{q, k, v, qpos, o, B, T, S, Hq, Hkv, Dh, Dv,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13],
           scale, softcap, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  const int width = Dh > Dv ? Dh : Dv;
  if (width <= 64) return launch<64>(dtype, p, s);
  if (width <= 128) return launch<128>(dtype, p, s);
  return launch<256>(dtype, p, s);
}
