// The backward of causal / windowed GQA flash attention: dq (B, T, Hq, D),
// dk (B, S, Hkv, D) and dv (B, S, Hkv, Dv) from q, k (D wide), v, the
// forward's output o and dO = dL/do (Dv wide), the per-row log-sum-exp
// lse (B, Hq, T) that the forward wrote, and qpos (B, T).
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
// Two variants, chosen by the operands' type and head dims
// (kernels/flash_attention/kernel.py: bwd_variant), between them every
// type and pair of head dims the forward takes.  Neither uses atomics:
// every sum has one fixed order, so each is bit-deterministic across
// launches.
//
// * wgmma (bf16 and fp16, D = Dv = 64, 128 or 256, or D 192 / Dv 128:
//   every training launch).
//   At D 64 and 128 five launches.  (a) A pre-pass, a block per
//   (64-row query tile, query head, batch): delta = sum dO * o per row and lse * log2(e) (1e30
//   for a row that sees no key, so that its p underflows to 0), both
//   float32, per tile; and, from the head-0 blocks, each row's visible
//   keys as (lo, hi], each tile's hull of them and the keys all its
//   rows see, so that no later launch reads qpos.  (b) dV and (c) dK:
//   one kernel, instantiated twice, a block per (128 keys, query head,
//   batch); key blocks in order, so under a causal mask the longest
//   run first, and the G heads of a GQA group neighbours in the grid,
//   so their K and V come from L2: at the training shape 1024 blocks
//   of 33,792 tile steps in all, the longest 64 of them, a quarter of
//   one SM's even share.  At D 64 and 128 three warpgroups;
//   the last is the producer (setmaxnreg 24 / 240): one thread loads K
//   (and V) once with TMA, then streams (Q, dO) tiles of 64 rows
//   through a 2-stage ring on mbarriers (rows past T arrive as zeros),
//   with the tile's lse and delta and row bounds as bulk copies,
//   skipping tiles whose hull misses the block.  Each consumer
//   warpgroup owns 64 keys: S^T = K Q^T (and dP^T = V dO^T; wgmma
//   m64n64k16, both operands K-major in shared memory), then P^T =
//   select(visible, 2^(z log2 e - lse log2 e), 0) (and dS^T = P^T
//   (dP^T - delta) (softcap factor) scale) in place, the mask applied
//   only on tiles where a row can miss one of the block's keys; the
//   result rounded to the operand type in registers is already the A
//   fragment of the next product, so dV += P^T dO (dK += dS^T Q; wgmma
//   m64nDk16, A from registers, dO or Q read MN-major from the tile
//   the scores came from) needs no transpose.  One kernel holding both
//   dK and dV (64 + 64 float32 registers a thread at D = 128) beside
//   S^T and dP^T does not fit the 168 registers ptxas allows a block
//   of 384 threads: it serialises every wgmma and spills.  With G > 1
//   each block writes its query head's float32 partial to scratch (2,
//   B, S, Hq, D), and (e) sums the G partials of a kv head in head
//   order and rounds.  (d) dQ: a block per (128 query rows, query
//   head, batch), longest first: Q and dO loaded once, (K, V) tiles of
//   64 keys streamed over the keys the rows see; per consumer S = Q K^T
//   and dP = dO V^T, then dS, then dQ += dS K (K read MN-major); one
//   store.  So (b)-(d) do 16 D flops per visible pair and query head
//   (S three times, dP twice) against the bound's 10 D: the price of
//   a deterministic sum without atomics within the register budget.
//   At D 256 (gemma2, recurrentgemma) an accumulator is 128 registers
//   a thread, one a warpgroup, and ptxas holds a block of 384 threads
//   (or 288) to 168 (the forward's Dh-256 consumers spilled and
//   serialised every wgmma under setmaxnreg), so a block is two
//   warpgroups (256 threads, up to 255 registers each), one thread of
//   which issues the copies; four launches, (a) and (e) as above and
//   between them: (b) dK and dV in one pass, a block per (64 keys,
//   query head, batch), 1024 blocks at gemma2's training shape, its two
//   warpgroups split by role on the same 64 keys: warpgroup 0 S^T =
//   K Q^T, P^T, dV += P^T dO; warpgroup 1 dP^T = V dO^T, then dS^T from
//   P^T (times the softcap's factor, float32, handed over in 16 KB of
//   shared memory: thread t of both warpgroups holds the same elements)
//   and dK += dS^T Q.  Streamed parts are whole 64-row query tiles (S^T
//   and dP^T m64n64); K and V take 64 KB, two stages of Q and dO 128
//   KB.  (c) dQ as at D 128 but with the two consumer warpgroups
//   alone, their thread 0 issuing the copies, and (K, V) streamed in
//   three 32-key stages (S and dP m64n32).  Both take the softcap's tanh
//   on the MUFU, as the forward.  So the
//   backward does 14 D flops a visible pair and query head (8 + 6)
//   against the bound's 10 D.
//   At D 192 / Dv 128 (deepseek-v3's MLA in its naive form, 128 query
//   heads over 128, the RoPE columns joined to q and k) the same four
//   launches: the dK/dV pass by role with S^T over 192 and dP^T over
//   128, dV (64 registers) on the S^T side and dK (96, a new m64n192k16)
//   on the other, three stages of Q and dO, each side taking two parts
//   an iteration so that its products overlap its own elementwise math;
//   dQ as at D 256 (no producer
//   warpgroup, 256 threads: dQ's 96 registers beside S, dP and dS at
//   64 keys do not fit 168) with three 64-key stages of K and V.  The
//   pre-pass's delta runs over Dv.  Per visible pair and query head 2
//   (4 D + 3 Dv) = 2304 flops (the dK/dV pass 4 (D + Dv) = 1280, dQ 2
//   (2 D + Dv) = 1024, which computes S and dP again) against the
//   bound's 2 (3 D + 2 Dv) = 1664.  With G = 1 there is no GQA sum.
//   Times at deepseek-v3's training microbatch (128 heads, 4096 tokens,
//   causal) against the bound, and the first design's, are in PERF.md.
// * ffma (float32 at every head dim; bf16 and fp16 at every pair of head
//   dims wgmma does not take: Dh and Dv multiples of 8 up to 256, Dh !=
//   Dv allowed, such as the reduced configs' Dh 16 and MLA's 24 / 16):
//   FlashAttention-2's split into three launches, as plain FFMA loops on
//   operands widened to float32, not TF32: (a) delta, one warp per (b,
//   t, h) row; (b) dK, dV, a block per (64 keys, 32 at 256; query head,
//   batch) over the query tiles whose qpos range can see the block,
//   with G > 1 writing the head's float32 partials that wgmma's GQA sum
//   (e) then sums; (c) dQ, a block per (16 query rows, query head,
//   batch) over the key tiles its rows can see, longest first.  Shared
//   memory and registers are sized for max(D, Dv) rounded up to 64, 128
//   or 256, the columns past D or Dv zeros.
//   A simple design that is right, not a fast one: per visible pair and
//   query head it does 2 (5 D + 3 Dv) flops (S and dP twice, once in each
//   pass) on the FP32 units (67 TFLOP/s), against the bound's 2 (3 D +
//   2 Dv) at the tensor cores' 989 in 16-bit types.
// wgmma rounds p and dz to the operand type for its products, as
// FlashAttention-2 does (the reference keeps them float32; the tests
// state the tolerance); ffma keeps them float32 and rounds dq, dk and dv
// once.  Times against the bound are in PERF.md.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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
  // written by (a): ffma (B, Hq, T) delta; wgmma (B, Hq,
  // n_tiles, 2, 64), each tile's lse * log2(e), then its delta
  float* delta;
  // wgmma: (B, 64 n_tiles) int2 row bounds (lo, hi], then (B, n_tiles)
  // int4 tile ranges, written by (a); else null
  int* rows;
  // wgmma with G > 1: (2, B, S, Hq, max(D, Dv)), dk's partials then
  // dv's; else null
  float* part;
  void* dq;              // (B, T, Hq, D), contiguous
  void* dk;              // (B, S, Hkv, D), contiguous
  void* dv;              // (B, S, Hkv, Dv), contiguous
  int B, T, S, Hq, Hkv;
  int D, Dv;             // head dims of q and k, of v, o and dout
  int n_tiles;           // wgmma: 64-row query tiles, 2 * ceil(T / 128)
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
};

template <> struct Ops<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
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
  for (int c = lane; c < p.Dv; c += 32) s = fmaf(to_f(d[c]), to_f(o[c]), s);
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

// ---- the ffma pair: every type and head dims ------------------------------
// Plain FFMA loops on float32 in shared memory, not TF32 or the tensor
// cores: 16-bit operands are widened as they are loaded, every sum is
// float32, and dq, dk and dv are rounded to the operand type once, as
// they are stored.  DM, the width of the shared-memory rows and of the
// register accumulators, is max(D, Dv) rounded up to 64, 128 or 256;
// columns of q and k at D or past, and of v and dO at Dv or past, load
// as zeros, so they add nothing to a sum, and a store writes only the
// columns below D (dq, dk) or Dv (dv), as the forward's ffma kernel
// masks `d < p.Dv`.  The dot products run to D and to Dv alone.
template <int DM>
constexpr int kFfmaKeys = DM == 256 ? 32 : 64;

__device__ __forceinline__ void store_as(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}
__device__ __forceinline__ void store_as(__half* dst, float x) {
  *dst = __float2half(x);
}

// (b): BK keys a block (64, or 32 at DM = 256, so that a thread's dk and
// dv columns stay 2 x 64 registers), query tiles of 16, one query head
// a block.  With G > 1 each block writes its head's float32 partials of
// dk and dv to scratch (2, B, S, Hq, max(D, Dv)), as wgmma's passes do,
// and wgmma's gqa_sum_kernel sums a kv head's G partials in head order
// and rounds them; with G = 1 the block writes dk and dv.  Thread t
// owns key row t % BK and the columns (t / BK) * COLS .. + COLS of its
// dk and dv rows.
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads) dkdv_ffma_kernel(const Params p) {
  constexpr int BK = kFfmaKeys<DM>, BQ = 16, LDK = DM + 1, LDP = BQ + 1;
  constexpr int COLS = DM / (kThreads / BK);
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
  const int b = blockIdx.z, h = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const long long kv0 = (long long)blockIdx.x * BK;
  const long long kv_last = (kv0 + BK < p.S ? kv0 + BK : (long long)p.S) - 1;
  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  const T* qb = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* db = (const T*)p.dout + b * p.d_sb + h * p.d_sh;
  for (int i = tid; i < BK * DM; i += kThreads) {
    const int r = i / DM, c = i % DM;
    const bool in = kv0 + r < p.S;
    Ks[r * LDK + c] = in && c < p.D ? to_f(kb[(kv0 + r) * p.k_ss + c]) : 0.f;
    Vs[r * LDK + c] = in && c < p.Dv ? to_f(vb[(kv0 + r) * p.v_ss + c]) : 0.f;
  }
  const int r = tid % BK, c0 = (tid / BK) * COLS;
  const long long key = kv0 + r;
  float dk[COLS], dv[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) dk[j] = dv[j] = 0.f;

  for (int t0 = 0; t0 < p.T; t0 += BQ) {
    int lo, hi;
    warp_qpos_range(p, b, t0, BQ, lo, hi);
    if (!tile_sees(p, lo, hi, kv0, kv_last)) continue;
    __syncthreads();
    for (int i = tid; i < BQ * DM; i += kThreads) {
      const int qr = i / DM, c = i % DM;
      const bool in = t0 + qr < p.T;
      const long long t = t0 + qr;
      Qs[qr * LDK + c] = in && c < p.D ? to_f(qb[t * p.q_st + c]) : 0.f;
      dOs[qr * LDK + c] = in && c < p.Dv ? to_f(db[t * p.d_st + c]) : 0.f;
    }
    if (tid < BQ) {
      const int t = t0 + tid;
      const bool in = t < p.T;
      qpos_s[tid] = in ? p.qpos[b * p.p_sb + t * p.p_st] : -1;
      lse_s[tid] = in ? p.lse[lse_index(p, b, h, t)] : 0.f;
      delta_s[tid] = in ? p.delta[lse_index(p, b, h, t)] : 0.f;
    }
    __syncthreads();
    // p^T and dz^T at (r, q) for q = tid / BK + (kThreads / BK) i
    for (int qc = tid / BK; qc < BQ; qc += kThreads / BK) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < p.D; ++c)
        s = fmaf(Ks[r * LDK + c], Qs[qc * LDK + c], s);
      for (int c = 0; c < p.Dv; ++c)
        dp = fmaf(Vs[r * LDK + c], dOs[qc * LDK + c], dp);
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
      for (int j = 0; j < COLS; ++j) {
        dv[j] = fmaf(pe, dOs[qc * LDK + c0 + j], dv[j]);
        dk[j] = fmaf(dz, Qs[qc * LDK + c0 + j], dk[j]);
      }
    }
  }
  if (key >= p.S) return;
  if (p.part != nullptr) {               // this head's float32 partials
    const int Dp = p.D > p.Dv ? p.D : p.Dv;
    float* pk = p.part + (((long long)b * p.S + key) * p.Hq + h) * Dp;
    float* pv = pk + (long long)p.B * p.S * p.Hq * Dp;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      if (c0 + j < p.D) pk[c0 + j] = dk[j];
      if (c0 + j < p.Dv) pv[c0 + j] = dv[j];
    }
    return;
  }
  const long long row = ((long long)b * p.S + key) * p.Hkv + hk;
  T* dkr = (T*)p.dk + row * p.D;
  T* dvr = (T*)p.dv + row * p.Dv;
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    if (c0 + j < p.D) store_as(dkr + c0 + j, dk[j]);
    if (c0 + j < p.Dv) store_as(dvr + c0 + j, dv[j]);
  }
}

// (c): 16 query rows a block, key tiles of 32.  Thread t owns query row
// t % 16 and the columns t / 16 + 8 j of its dq row.  One block an SM
// at least, so that ptxas need not hold the 16-bit types' DM 64
// instance to 64 registers (it spilled 4 bytes there).
template <typename T, int DM>
__global__ void __launch_bounds__(kThreads, 1) dq_ffma_kernel(const Params p) {
  constexpr int BQ = 16, BK = 32, LDK = DM + 1, LDZ = BK + 1, NC = DM / 8;
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
  const T* qb = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* db = (const T*)p.dout + b * p.d_sb + h * p.d_sh;
  const T* kb = (const T*)p.k + b * p.k_sb + hk * p.k_sh;
  const T* vb = (const T*)p.v + b * p.v_sb + hk * p.v_sh;
  for (int i = tid; i < BQ * DM; i += kThreads) {
    const int qr = i / DM, c = i % DM;
    const bool in = t0 + qr < p.T;
    const long long t = t0 + qr;
    Qs[qr * LDK + c] = in && c < p.D ? to_f(qb[t * p.q_st + c]) : 0.f;
    dOs[qr * LDK + c] = in && c < p.Dv ? to_f(db[t * p.d_st + c]) : 0.f;
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
    for (int i = tid; i < BK * DM; i += kThreads) {
      const int kr = i / DM, c = i % DM;
      const bool in = kv0 + kr < p.S;
      Ks[kr * LDK + c] =
          in && c < p.D ? to_f(kb[(kv0 + kr) * p.k_ss + c]) : 0.f;
      Vs[kr * LDK + c] =
          in && c < p.Dv ? to_f(vb[(kv0 + kr) * p.v_ss + c]) : 0.f;
    }
    __syncthreads();
    // dz at (r, kc) for kc = tid / 16 + 8 i
    for (int kc = cg; kc < BK; kc += kThreads / BQ) {
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < p.D; ++c)
        s = fmaf(Qs[r * LDK + c], Ks[kc * LDK + c], s);
      for (int c = 0; c < p.Dv; ++c)
        dp = fmaf(dOs[r * LDK + c], Vs[kc * LDK + c], dp);
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
    T* out = (T*)p.dq + (((long long)b * p.T + t) * p.Hq + h) * p.D;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (cg + 8 * j < p.D) store_as(out + cg + 8 * j, dq[j]);
  }
}

// ---- the wgmma variant -----------------------------------------------------
namespace wg {

// D 64 and 128: the dK, dV and dQ kernels have two consumer warpgroups
// of 64 keys (dK, dV) or 64 query rows (dQ) and a producer warpgroup
// last, to which setmaxnreg leaves 24 registers (the consumers 240)
constexpr int kConsumers = 2;
constexpr int kTile = 64;        // rows of the pre-pass's query tiles
constexpr int kBlock = 64 * kConsumers;   // keys (dK, dV) or rows (dQ) a block
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoKey = 1e30f;  // lse * log2(e) of a row that sees no key
constexpr int kThreads3 = 128 * (kConsumers + 1);
// The dQ kernel keeps this shape where q and k are 192 or 256 wide too,
// where ptxas holds a block of 384 threads (or 288) to 168 registers
// and a consumer needs more (at D 256 its accumulator alone is 128; at
// 192 dQ's 96 beside S, dP and dS at 64 keys are some 180): there the
// block is the two consumer warpgroups alone (up to 255 registers),
// their thread 0 issues the copies between its own products, and K and
// V stream in three stages: of 32 keys at D 256 beside Q and dO of 128
// rows (128 KB), S and dP m64n32; of 64 keys at 192 / 128 beside Q and
// dO (80 KB), 200 KB in all.  (A dQ split by role like the dK/dV pass,
// and one that issued the next stage's scores behind this stage's
// product, were slower at D 256: PERF.md.)  Templated on q's and k's
// width D.
template <int D>
constexpr bool kProducerWarpgroup = D <= 128;
template <int D>
constexpr int kThreadsAt = 128 * (kProducerWarpgroup<D> ? kConsumers + 1
                                                        : kConsumers);
template <int D>
constexpr int kSub = D == 256 ? 32 : kTile;     // keys a dQ stage
// dQ's K/V stages: without a producer warpgroup a third fits beside Q
// and dO, so a stage is refilled three stages ahead of its use
template <int D>
constexpr int kQStages = kProducerWarpgroup<D> ? kStages : 3;

// Row t sees exactly the keys in (lo, hi]: hi = min(qpos, S - 1), or -1
// for a padding row or one past T; lo = qpos - window with a window,
// else -1, clamped to [-1, hi].
__device__ __forceinline__ void row_bounds(int qp, const Params& p, int& lo,
                                           int& hi) {
  hi = qp < 0 ? -1 : min(qp, p.S - 1);
  long long l = p.has_window && qp >= 0 ? (long long)qp - p.window : -1;
  lo = (int)(l < -1 ? -1 : (l > hi ? hi : l));
}

// A tile's keys, as int4 (x, y, z, w): every key a row of it sees is in
// [x, y] (x > y when none); every row sees every key in [z, w].
__device__ __forceinline__ bool tile_sees(int4 r, int k0, int k1) {
  return r.y >= k0 && r.x <= k1;
}
__device__ __forceinline__ bool tile_full(int4 r, int k0, int k1) {
  return r.z <= k0 && k1 <= r.w;
}
__device__ __forceinline__ const int4* tile_ranges(const Params& p, int b) {
  return reinterpret_cast<const int4*>(
             p.rows + 2LL * p.B * p.n_tiles * kTile) + (long long)b * p.n_tiles;
}

// (a) a block per (64-row query tile, query head, batch)
template <typename T>
__global__ void __launch_bounds__(256) prep_kernel(const Params p) {
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* st = p.delta + ((long long)(b * p.Hq + h) * p.n_tiles + i) * 2 * kTile;
  for (int r = warp; r < kTile; r += 8) {
    const int t = i * kTile + r;
    float s = 0.f;
    if (t < p.T) {
      const T* o = (const T*)p.o + b * p.o_sb + t * p.o_st + h * p.o_sh;
      const T* d = (const T*)p.dout + b * p.d_sb + t * p.d_st + h * p.d_sh;
      for (int c = 2 * lane; c < p.Dv; c += 64)
        s = fmaf(to_f(d[c]), to_f(o[c]), fmaf(to_f(d[c + 1]), to_f(o[c + 1]), s));
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) {
      float l2 = kNoKey;
      if (t < p.T) {
        const float x = p.lse[lse_index(p, b, h, t)];
        if (x > 0.5f * kNegInf) l2 = x * kLog2e;
      }
      st[r] = l2;
      st[kTile + r] = s;
    }
  }
  if (h != 0) return;                          // the rest is per (tile, b)
  __shared__ int4 part_s[2];
  if (threadIdx.x < kTile) {
    const int t = i * kTile + threadIdx.x;
    int lo, hi;
    row_bounds(t < p.T ? p.qpos[b * p.p_sb + t * p.p_st] : -1, p, lo, hi);
    reinterpret_cast<int2*>(p.rows)[(long long)b * p.n_tiles * kTile + t] =
        make_int2(lo, hi);
    const bool any = lo < hi;
    int4 r = make_int4(any ? lo + 1 : INT_MAX, any ? hi : -1, lo + 1, hi);
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      r.x = min(r.x, __shfl_xor_sync(0xffffffffu, r.x, off));
      r.y = max(r.y, __shfl_xor_sync(0xffffffffu, r.y, off));
      r.z = max(r.z, __shfl_xor_sync(0xffffffffu, r.z, off));
      r.w = min(r.w, __shfl_xor_sync(0xffffffffu, r.w, off));
    }
    if (lane == 0) part_s[warp] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int4 a = part_s[0], c = part_s[1];
    const_cast<int4*>(tile_ranges(p, b))[i] = make_int4(
        min(a.x, c.x), max(a.y, c.y), max(a.z, c.z), min(a.w, c.w));
  }
}

// Issues d = A B^T over D, A the warpgroup's 64 rows of an operand of
// ROWS rows at `a`, B the N rows at `bt`, both K-major, and commits it
// as one wgmma group.  The descriptors are rebuilt from their base in
// every call, so the compiler keeps two registers for them, not sixteen.
template <typename T, int D, int ROWS, int N>
__device__ __forceinline__ void issue_abt(float (&d)[N / 2], uint64_t a,
                                          uint64_t bt) {
  asm volatile("" : "+l"(a), "+l"(bt));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<T>(d, a + (((kk / 4) * ROWS * 128 + (kk % 4) * 32) >> 4),
                bt + (((kk / 4) * N * 128 + (kk % 4) * 32) >> 4), kk > 0);
  wgmma_commit();
}

// Issues acc += F Z and commits it: F (64 x K) in registers, columns
// 16 kk .. 16 kk + 15 in f[4 kk .. 4 kk + 3]; Z the K x D tile at `z`,
// read MN-major (its panels K * 128 bytes apart).
template <typename T, int D, int K>
__device__ __forceinline__ void issue_fz(float (&acc)[D / 2],
                                         const uint32_t (&f)[K / 4],
                                         uint64_t z) {
  asm volatile("" : "+l"(z));
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<T>(acc, &f[4 * kk], z + ((kk * 16 * 128) >> 4));
  wgmma_commit();
}

// the accumulator (64 x N, f32) rounded to T, packed as the A
// fragments of issue_fz
template <typename T, int N>
__device__ __forceinline__ void pack(uint32_t (&f)[N / 4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) f[j] = Ops<T>::pack(d[2 * j], d[2 * j + 1]);
}

// Turns the score accumulator s (q.k) into p and, with kGrad, dp
// (dO.v) into dz * scale, in place, for one thread's element.  lse2 and
// delta are the element's row's, lo and hi its row bounds (used when
// `masked`).  With kFastTanh (D 256) the softcap's tanh is the
// forward's, tanh_2log2e of s * tin (tin = 2 log2(e) scale / softcap),
// else the library's tanhf.
template <bool kSoftcap, bool kGrad, bool kFastTanh = false>
__device__ __forceinline__ void grad_elem(float& s, float& dp, float lse2,
                                          float delta, int key, int lo,
                                          int hi, bool masked,
                                          const Params& p, float scale_log2,
                                          float tin = 0.f) {
  float z, fac = 1.f;
  if (kSoftcap) {
    const float th = kFastTanh ? tanh_2log2e(s * tin)
                               : tanhf(s * p.scale / p.softcap);
    z = th * p.softcap * kLog2e;
    fac = 1.f - th * th;
  } else {
    z = s * scale_log2;
  }
  float pe = ex2(z - lse2);
  if (masked && !(key > lo && key <= hi)) pe = 0.f;
  s = pe;
  if (kGrad) {
    float dz = pe * (dp - delta);
    if (kSoftcap) dz *= fac;
    dp = dz * p.scale;
  }
}

// Dynamic shared memory from a 1024-byte aligned base: K and V of the
// block's keys, then kStages stages of a streamed Q tile, of its dO
// tile, of its rows' lse * log2(e) and delta, and of its row bounds
template <int D>
struct KVLayout {
  static constexpr int kRows = kTile;                   // rows a stage
  static constexpr int kKVBytes = kBlock * D * 2;       // K or V
  static constexpr int kTileBytes = kRows * D * 2;      // a Q or dO stage
  static constexpr int kStatBytes = 2 * kRows * 4;      // lse2, then delta
  static constexpr int kRowBytes = kRows * 8;           // (lo, hi) a row
  static constexpr int kK = 0;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;               // + stage * kTileBytes
  static constexpr int kO = kQ + kStages * kTileBytes;
  static constexpr int kStat = kO + kStages * kTileBytes;   // + stage * kStatBytes
  static constexpr int kRow = kStat + kStages * kStatBytes; // + stage * kRowBytes
  // mbarriers: K and V full, then full [kStages], free [kStages]
  static constexpr int kBar = kRow + kStages * kRowBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
};

// the mbarriers of a ring of S stages: one for the block's resident
// tiles, then full [S], free [S]
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) {
  return bars + 8 * (1 + s);
}
template <int S = kStages>
__device__ __forceinline__ uint32_t bar_free(uint32_t bars, int s) {
  return bars + 8 * (1 + S + s);
}

template <int S = kStages>
__device__ __forceinline__ void init_bars(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full(bars, s), 1);
      mbar_init(bar_free<S>(bars, s), 4 * kConsumers);   // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// (b) dV and (c) dK at D 64 and 128: a block per (kBlock keys, query
// head, batch).  One kernel holding both dK and dV (64 + 64 registers a
// thread at D = 128) beside S^T and dP^T would pass the 168 registers
// ptxas gives a block of 384 threads, and it then serialises the wgmmas
// and spills; two kernels, each with one accumulator, pay for it with
// S^T computed twice.  The block streams every 64-row query tile whose
// rows see one of its keys, in order, a stage each.
template <typename T, int D, bool kSoftcap, bool kDK>
__global__ void __launch_bounds__(kThreads3, 1)
dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert(D == 64 || D == 128, "D 256 has dkdv_roles_kernel");
  using L = KVLayout<D>;
  constexpr int kR = L::kRows;
  constexpr int kParts = kTile / kR;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int kv0 = blockIdx.y * kBlock;   // the first keys see the most rows
  const int kv_last = kv0 + kBlock - 1;
  const int4* tiles = tile_ranges(p, b);
  const float* stats =
      p.delta + (long long)(b * p.Hq + h) * p.n_tiles * 2 * kTile;
  const int* rows = p.rows + (long long)b * p.n_tiles * kTile * 2;
  init_bars(bars);

  auto load_kv = [&]() {
    mbar_expect_tx(bars, (kDK ? 2 : 1) * L::kKVBytes);
#pragma unroll
    for (int c = 0; c < D / kTmaPanel; ++c) {
      tma_load_4d(base + L::kK + c * kBlock * 128, &tm_k, bars,
                  c * kTmaPanel, hk, kv0, b);
      if (kDK)
        tma_load_4d(base + L::kV + c * kBlock * 128, &tm_v, bars,
                    c * kTmaPanel, hk, kv0, b);
    }
  };
  // part j of query tile i into stage s
  auto load_part = [&](int i, int j, int s) {
    const uint32_t full = bar_full(bars, s);
    mbar_expect_tx(full, 2 * L::kTileBytes + L::kStatBytes + L::kRowBytes);
    const int row0 = i * kTile + j * kR;
#pragma unroll
    for (int c = 0; c < D / kTmaPanel; ++c) {
      tma_load_4d(base + L::kQ + s * L::kTileBytes + c * kR * 128, &tm_q,
                  full, c * kTmaPanel, h, row0, b);
      tma_load_4d(base + L::kO + s * L::kTileBytes + c * kR * 128, &tm_do,
                  full, c * kTmaPanel, h, row0, b);
    }
    // the part's lse2, then its delta: one copy when the part is the
    // whole tile, else two
    const float* st = stats + i * 2 * kTile + j * kR;
    const uint32_t st_s = base + L::kStat + s * L::kStatBytes;
    if constexpr (kParts == 1) {
      bulk_load(st_s, st, L::kStatBytes, full);
    } else {
      bulk_load(st_s, st, kR * 4, full);
      bulk_load(st_s + kR * 4, st + kTile, kR * 4, full);
    }
    bulk_load(base + L::kRow + s * L::kRowBytes, rows + row0 * 2, kR * 8,
              full);
  };
  // steps (i, j) to the next part the block streams; i = n_tiles past
  // the last
  auto next = [&](int& i, int& j) {
    if (++j < kParts) return;
    j = 0;
    do {
      ++i;
    } while (i < p.n_tiles && !tile_sees(__ldg(tiles + i), kv0, kv_last));
  };

  if (tid >= kConsumers * 128) {
    // ---- producer warpgroup: one thread issues every copy ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128) {
      load_kv();
      int i = -1, j = kParts - 1;
      next(i, j);
      for (int n = 0; i < p.n_tiles; ++n, next(i, j)) {
        const int s = n % kStages;
        mbar_wait(bar_free(bars, s), ((n / kStages) & 1) ^ 1);
        load_part(i, j, s);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int tig = lane & 3;
    const int kw0 = kv0 + 64 * wgi, kw_last = kw0 + 63;
    const int key0 = kw0 + warp * 16 + (lane >> 2);    // and key0 + 8
    const uint64_t k_desc = sw128_desc(base + L::kK + wgi * 64 * 128, 16);
    const uint64_t v_desc = sw128_desc(base + L::kV + wgi * 64 * 128, 16);
    const float scale_log2 = p.scale * kLog2e;
    float acc[D / 2];                       // dK or dV rows key0, key0 + 8
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    mbar_wait(bars, 0);
    int n = 0;
    for (int i = 0; i < p.n_tiles; ++i) {
      const int4 tr = __ldg(tiles + i);
      if (!tile_sees(tr, kv0, kv_last)) continue;
      const bool mine = tile_sees(tr, kw0, kw_last);
      const bool masked = !tile_full(tr, kw0, kw_last);
      for (int j = 0; j < kParts; ++j, ++n) {
        const int s = n % kStages;
        mbar_wait(bar_full(bars, s), (n / kStages) & 1);
        if (mine) {
          const uint32_t q_s = base + L::kQ + s * L::kTileBytes;
          const uint32_t o_s = base + L::kO + s * L::kTileBytes;
          const float* lse2 = reinterpret_cast<const float*>(
              sm + L::kStat + s * L::kStatBytes);
          const int* rb =
              reinterpret_cast<const int*>(sm + L::kRow + s * L::kRowBytes);
          float st[kR / 2], dpt[kR / 2];   // S^T then P^T; dP^T then dS^T
          wgmma_fence();
          issue_abt<T, D, kBlock, kR>(st, k_desc, sw128_desc(q_s, 16));
          if (kDK) issue_abt<T, D, kBlock, kR>(dpt, v_desc, sw128_desc(o_s, 16));
          wgmma_wait<0>();
          fence_regs(st);
          if (kDK) fence_regs(dpt);
          // element 4 nn + e: key key0 + 8 (e >> 1), query row
          // 8 nn + 2 tig + (e & 1) of the part
#pragma unroll
          for (int nn = 0; nn < kR / 8; ++nn) {
            const int col = nn * 8 + tig * 2;
            const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
            const float2 dl =
                kDK ? *reinterpret_cast<const float2*>(lse2 + kR + col)
                    : make_float2(0.f, 0.f);
            int4 bnd = make_int4(0, 0, 0, 0);
            if (masked) bnd = *reinterpret_cast<const int4*>(rb + 2 * col);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              grad_elem<kSoftcap, kDK>(st[4 * nn + e], dpt[4 * nn + e],
                                       (e & 1) ? l2.y : l2.x,
                                       (e & 1) ? dl.y : dl.x,
                                       key0 + 8 * (e >> 1),
                                       (e & 1) ? bnd.z : bnd.x,
                                       (e & 1) ? bnd.w : bnd.y, masked, p,
                                       scale_log2);
          }
          // dK += dS^T Q, or dV += P^T dO
          uint32_t f[kR / 4];
          pack<T, kR>(f, kDK ? dpt : st);
          fence_regs(acc);
          fence_regs(f);
          wgmma_fence();
          issue_fz<T, D, kR>(acc, f, sw128_desc(kDK ? q_s : o_s, kR * 128));
          wgmma_wait<0>();
          fence_regs(acc);
          fence_regs(f);
        }
        release(bar_free(bars, s));
      }
    }

    // rows key0 and key0 + 8: this head's float32 partial, or with one
    // query head per kv head the result
    const long long other = kDK ? 0 : (long long)p.B * p.S * p.Hq * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= p.S) continue;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        const int col = nn * 8 + tig * 2, j = 4 * nn + 2 * half;
        if (p.part != nullptr) {
          const long long at = (((long long)b * p.S + key) * p.Hq + h) * D + col;
          *reinterpret_cast<float2*>(p.part + other + at) =
              make_float2(acc[j], acc[j + 1]);
        } else {
          const long long at = (((long long)b * p.S + key) * p.Hkv + hk) * D + col;
          *reinterpret_cast<uint32_t*>((T*)(kDK ? p.dk : p.dv) + at) =
              Ops<T>::pack(acc[j], acc[j + 1]);
        }
      }
    }
  }
}

// Dynamic shared memory of the dQ kernel: Q (DK wide) and dO (DV) of
// the block's rows, then kS stages of a streamed K tile and of its V
// tile
template <int DK, int DV>
struct QLayout {
  static constexpr int kKeys = kSub<DK>;                // keys a stage
  static constexpr int kS = kQStages<DK>;               // stages
  static constexpr int kQBytes = kBlock * DK * 2;       // Q
  static constexpr int kOBytes = kBlock * DV * 2;       // dO
  static constexpr int kKBytes = kKeys * DK * 2;        // a K stage
  static constexpr int kVBytes = kKeys * DV * 2;        // a V stage
  static constexpr int kQ = 0;
  static constexpr int kO = kQBytes;
  static constexpr int kK = kQBytes + kOBytes;          // + stage * kKBytes
  static constexpr int kV = kK + kS * kKBytes;          // + stage * kVBytes
  // mbarriers: Q and dO full, then full [kS], free [kS]
  static constexpr int kBar = kV + kS * kVBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kS);
};

// (d) dQ: a block per (kBlock query rows, query head, batch); q and k
// DK wide, v and dO DV
template <typename T, int DK, int DV, bool kSoftcap>
__global__ void __launch_bounds__(kThreadsAt<DK>, 1)
dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  constexpr int D = DK;
  using L = QLayout<DK, DV>;
  constexpr int kK = L::kKeys;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.Hq, h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kConsumers;   // longest first
  const int4* tiles = tile_ranges(p, b);
  init_bars<L::kS>(bars);
  // the keys any row of the block sees, in kK-key stages
  const int4 ta = __ldg(tiles + i0), tb = __ldg(tiles + i0 + 1);
  const int key_lo = min(ta.x, tb.x), key_hi = max(ta.y, tb.y);
  const int tile_first = key_hi >= key_lo ? key_lo / kK : 0;
  const int n_stages = key_hi >= key_lo ? key_hi / kK + 1 - tile_first : 0;

  auto load_q = [&]() {
    mbar_expect_tx(bars, L::kQBytes + L::kOBytes);
#pragma unroll
    for (int c = 0; c < DK / kTmaPanel; ++c)
      tma_load_4d(base + L::kQ + c * kBlock * 128, &tm_q, bars,
                  c * kTmaPanel, h, i0 * kTile, b);
#pragma unroll
    for (int c = 0; c < DV / kTmaPanel; ++c)
      tma_load_4d(base + L::kO + c * kBlock * 128, &tm_do, bars,
                  c * kTmaPanel, h, i0 * kTile, b);
  };
  // K and V stage n into stage s
  auto load_kv = [&](int n, int s) {
    const int kv0 = (tile_first + n) * kK;
    mbar_expect_tx(bar_full(bars, s), L::kKBytes + L::kVBytes);
#pragma unroll
    for (int c = 0; c < DK / kTmaPanel; ++c)
      tma_load_4d(base + L::kK + s * L::kKBytes + c * kK * 128, &tm_k,
                  bar_full(bars, s), c * kTmaPanel, hk, kv0, b);
#pragma unroll
    for (int c = 0; c < DV / kTmaPanel; ++c)
      tma_load_4d(base + L::kV + s * L::kVBytes + c * kK * 128, &tm_v,
                  bar_full(bars, s), c * kTmaPanel, hk, kv0, b);
  };

  if (kProducerWarpgroup<D> && tid >= kConsumers * 128) {
    if constexpr (kProducerWarpgroup<D>)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == kConsumers * 128 && n_stages > 0) {
      load_q();
      for (int n = 0; n < n_stages; ++n) {
        const int s = n % L::kS;
        mbar_wait(bar_free<L::kS>(bars, s), ((n / L::kS) & 1) ^ 1);
        load_kv(n, s);
      }
    }
  } else {
    if constexpr (kProducerWarpgroup<D>)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    // without a producer warpgroup thread 0 issues the copies, as in the
    // dK and dV kernels
    const bool producer = !kProducerWarpgroup<D> && tid == 0;
    if (producer && n_stages > 0) {
      load_q();
      for (int n = 0; n < L::kS && n < n_stages; ++n) load_kv(n, n);
    }
    const int wgi = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int tig = lane & 3;
    const int i = i0 + wgi;                         // this warpgroup's tile
    const int4 tr = wgi ? tb : ta;
    const int r0 = warp * 16 + (lane >> 2);         // and r0 + 8, in the tile
    const float* stats =
        p.delta + ((long long)(b * p.Hq + h) * p.n_tiles + i) * 2 * kTile;
    const int2* rb = reinterpret_cast<const int2*>(p.rows) +
                     ((long long)b * p.n_tiles + i) * kTile;
    const float lse0 = stats[r0], lse1 = stats[r0 + 8];
    const float dl0 = stats[kTile + r0], dl1 = stats[kTile + r0 + 8];
    const int2 b0 = rb[r0], b1 = rb[r0 + 8];
    const uint64_t q_desc = sw128_desc(base + L::kQ + wgi * 64 * 128, 16);
    const uint64_t o_desc = sw128_desc(base + L::kO + wgi * 64 * 128, 16);
    const float scale_log2 = p.scale * kLog2e;
    const float tin = kSoftcap ? 2.f * kLog2e * p.scale / p.softcap : 0.f;
    float dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
    if (n_stages > 0) mbar_wait(bars, 0);
    for (int n = 0; n < n_stages; ++n) {
      const int s = n % L::kS;
      const int kv0 = (tile_first + n) * kK;
      mbar_wait(bar_full(bars, s), (n / L::kS) & 1);
      if (tile_sees(tr, kv0, kv0 + kK - 1)) {
        const uint32_t k_s = base + L::kK + s * L::kKBytes;
        const uint32_t v_s = base + L::kV + s * L::kVBytes;
        float sc[kK / 2], dp[kK / 2];     // S then P; dP then dS
        wgmma_fence();
        issue_abt<T, DK, kBlock, kK>(sc, q_desc, sw128_desc(k_s, 16));
        issue_abt<T, DV, kBlock, kK>(dp, o_desc, sw128_desc(v_s, 16));
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        // element 4 n + e: row r0 + 8 (e >> 1), key kv0 + 8 n + 2 tig + (e & 1)
        const bool masked = !tile_full(tr, kv0, kv0 + kK - 1);
#pragma unroll
        for (int j = 0; j < kK / 2; ++j) {
          const bool up = (j & 3) >= 2;
          grad_elem<kSoftcap, true, D == 256>(
              sc[j], dp[j], up ? lse1 : lse0, up ? dl1 : dl0,
              kv0 + (j / 4) * 8 + tig * 2 + (j & 1), up ? b1.x : b0.x,
              up ? b1.y : b0.y, masked, p, scale_log2, tin);
        }
        uint32_t sf[kK / 4];
        pack<T, kK>(sf, dp);
        fence_regs(dq);
        fence_regs(sf);
        wgmma_fence();
        issue_fz<T, D, kK>(dq, sf, sw128_desc(k_s, kK * 128));   // dQ += dS K
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(sf);
      }
      release(bar_free<L::kS>(bars, s));
      if (producer && n + L::kS < n_stages) {
        mbar_wait(bar_free<L::kS>(bars, s), (n / L::kS) & 1);
        load_kv(n + L::kS, s);
      }
    }
    T* out = (T*)p.dq + h * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = i * kTile + r0 + 8 * half;
      if (t >= p.T) continue;
      T* row = out + ((long long)b * p.T + t) * p.Hq * D;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn) {
        const int j = 4 * nn + 2 * half;
        *reinterpret_cast<uint32_t*>(row + nn * 8 + tig * 2) =
            Ops<T>::pack(dq[j], dq[j + 1]);
      }
    }
  }
}

// ---- D 256 and 192 / 128: dK and dV in one pass, split by role ----
// A consumer's accumulator of 64 x 256 float32 takes 128 registers a
// thread, so a block holds one a warpgroup.  Rather than two launches
// each recomputing S^T beside one accumulator (dV, then dK, the first
// design at D 256), the two warpgroups of one block take the two halves of the
// work on the same 64 keys: the S^T side turns its scores into P^T and
// hands P^T (times the softcap's factor) to the dP^T side through
// shared memory, where thread t of the other warpgroup holds the same
// elements in the same accumulator layout.  The block is the two
// warpgroups alone, 256 threads and up to 255 registers each: with a
// producer warp of its own (288 threads) ptxas gave 168, as it does a
// block of 384, and the pass spilled 928 bytes (PERF.md).  So thread
// 0 of the dP^T side, the side that releases a stage last, issues the
// copies, each right after that release, kS parts ahead, where it
// waits on no other warp.  Each warpgroup waits for each of its
// products before its next step, so that no product is in flight across
// the loop's back edge (else ptxas serialises the wgmmas, C7515); the
// two warpgroups' products and elementwise math overlap each other.
// At DK 192 / DV 128 (MLA's naive form: q and k 192 wide, v 128) the
// same pass: S^T = K Q^T over 192, dV (64 x 128, 64 registers) on the
// S^T side, dP^T = V dO^T over 128, dK (64 x 192, 96 registers) on the
// other; K, V and three stages of Q and dO take 160 KB.  There a 64 x 64
// tile carries 640 columns of products against 1024 at D 256, for the
// same elementwise work, so a warpgroup that waits for each of its
// products before its math leaves the tensor cores idle whenever both
// sides do elementwise work (the first design: the pass at 35.5% of the
// tensor cores' peak, against 44% at D 256).  So at 192 / 128
// (kPair) each side takes two parts an iteration and overlaps its own
// products with its own math (FlashAttention-3's intra-warpgroup
// overlap): it issues the scores of both parts, runs part a's math while
// part b's scores run, issues part a's product, runs part b's math while
// that product runs, then issues part b's; it waits for everything
// before the loop's back edge (C7515).  P^T goes through two exchange
// buffers, part a's and part b's, each with its own pair of named
// barriers, so neither side waits for the other to have read a buffer
// before it writes the next part.  A second score tile costs 32
// registers a thread; at D 256 the accumulator's 128 leave no room for
// it, nor does shared memory hold a second exchange buffer beside two
// stages there, so D 256 keeps one part an iteration.
constexpr int kRoleThreads = 2 * 128;
constexpr int kRoleRows = 64;    // keys of a block, rows of a part
// named barriers (0 is __syncthreads) of the block's 256 threads: P^T
// in exchange buffer x full, and read
__device__ __forceinline__ int bar_pfull(int x) { return 1 + 2 * x; }
__device__ __forceinline__ int bar_pfree(int x) { return 2 + 2 * x; }

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One element of P (or P^T) from its score s, in place, as grad_elem;
// returns it times the softcap's factor (dz over dz before the cap),
// what the dP side multiplies by (dP - delta).  The logit in log2 units
// is s * in, or with the softcap tanh_2log2e(s * in) * out (in = 2
// log2(e) scale / softcap, out = softcap log2(e)), as the forward's.
template <bool kSoftcap>
__device__ __forceinline__ float prob_elem(float& s, float lse2, int key,
                                           int lo, int hi, bool masked,
                                           float in, float out) {
  float z, fac = 1.f;
  if (kSoftcap) {
    const float th = tanh_2log2e(s * in);
    z = th * out;
    fac = 1.f - th * th;
  } else {
    z = s * in;
  }
  float pe = ex2(z - lse2);
  if (masked && !(key > lo && key <= hi)) pe = 0.f;
  s = pe;
  return kSoftcap ? pe * fac : pe;
}

// two parts an iteration, each side overlapping its products with its
// math: at DK 192 / DV 128 only (above)
template <int DK>
constexpr bool kPair = DK == 192;
// The grid's order.  At D 256 the (batch, head) is the fast index, so
// that a GQA group's heads, which share K and V, are neighbours.  At
// 192 / 128 with 128 heads that put 128 heads' blocks of one key range
// on the card at once, each streaming Q and dO tiles that no other
// resident block reads: every tile came from device memory, 10.9 GB a
// call at deepseek-v3's training shape, and the copies, not the
// products, held the pass back.  So there a (batch, head)'s key blocks
// are neighbours (the key block the fast index, longest first), and the
// blocks resident together read the same head's Q and dO, 2.5 MB, from
// L2.
template <int DK>
constexpr bool kHeadMajor = DK == 192;

// Dynamic shared memory of dkdv_roles_kernel from a 1024-byte aligned
// base: K (DK wide) and V (DV) of the block's 64 keys, kS stages of a
// 64-row Q tile and of its dO tile, the P^T exchange buffers (float32,
// one at D 256, two at 192 / 128), then per stage the rows' lse2 and
// delta and their row bounds, and the mbarriers.  Two stages at D 256
// (215,080 B); at 192 / 128 three beside two exchange buffers (199,736
// B), or four beside one (225,352 B), which leaves the S^T side waiting
// for the dP^T side to have read part n before it writes part n + 1 and
// measured slower (tools/bwd_layouts.py, PERF.md).
template <int DK, int DV>
struct RoleKVLayout {
  static constexpr int kXBufs = kPair<DK> ? 2 : 1;
  static constexpr int kS = DK == 256 ? kStages : 5 - kXBufs;
  static constexpr int kKBytes = kRoleRows * DK * 2;     // K, or a Q stage
  static constexpr int kVBytes = kRoleRows * DV * 2;     // V, or a dO stage
  static constexpr int kXBytes = kRoleRows * kRoleRows * 4;  // an exchange
  static constexpr int kStatBytes = 2 * kRoleRows * 4;
  static constexpr int kRowBytes = kRoleRows * 8;
  static constexpr int kK = 0;
  static constexpr int kV = kKBytes;
  static constexpr int kQ = kKBytes + kVBytes;           // + stage * kKBytes
  static constexpr int kO = kQ + kS * kKBytes;           // + stage * kVBytes
  static constexpr int kX = kO + kS * kVBytes;           // + x * kXBytes
  static constexpr int kStat = kX + kXBufs * kXBytes;
  static constexpr int kRow = kStat + kS * kStatBytes;
  // mbarriers: K and V full, then full [kS], free [kS]
  static constexpr int kBar = kRow + kS * kRowBytes;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kS);
};

// probes of the dK/dV pass at 192 / 128, not the function (their outputs
// are not the gradients): kNoMath leaves out the elementwise math and
// the exchange's loads and stores between each side's two products (the
// named barriers stay), kNoCopies every copy of a part after the first
// kS (each part reuses what its stage holds)
enum { kNoProbe = 0, kNoMath = 1, kNoCopies = 2 };
// the probe entry's other codes, for timing each launch alone by CUDA
// events: the pre-pass alone, and the pre-pass and the dK/dV pass as the
// function runs it (no kernel of its own)
enum { kPrePassAlone = 3, kPassAlone = 4 };

// (b) dK and dV in one pass: a block per (64 keys, query head, batch),
// key blocks in order (under a causal mask the longest first), a GQA
// group's heads neighbours in the grid.  Warpgroup 0: S^T = K Q^T
// (m64n64k16, both K-major, over DK), P^T in place, P^T times the
// softcap factor to the exchange, dV += P^T dO (A from registers, dO
// read MN-major).  Warpgroup 1: dP^T = V dO^T (over DV), then, once P^T
// is in, dS^T = P^T (dP^T - delta) (softcap factor) scale and dK +=
// dS^T Q.  4 (DK + DV) flops a visible pair and query head.  The block
// streams every 64-row query tile whose rows see one of its keys, a
// stage each.
template <typename T, int DK, int DV, bool kSoftcap, int kProbe = kNoProbe>
__global__ void __launch_bounds__(kRoleThreads, 1)
dkdv_roles_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const Params p) {
  static_assert((DK == 256 && DV == 256) || (DK == 192 && DV == 128),
                "the role split is the D 256 and 192 / 128 design");
  static_assert(kProbe == kNoProbe || DK == 192, "probes at 192 / 128");
  using L = RoleKVLayout<DK, DV>;
  constexpr int kR = kRoleRows, kS = L::kS, kXB = L::kXBufs;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + L::kBar;
  const int tid = threadIdx.x;
  const int bh = kHeadMajor<DK> ? blockIdx.y : blockIdx.x;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int kv0 = (kHeadMajor<DK> ? blockIdx.x : blockIdx.y) * kR;
  const int kv_last = kv0 + kR - 1;
  const int4* tiles = tile_ranges(p, b);
  const float* stats =
      p.delta + (long long)(b * p.Hq + h) * p.n_tiles * 2 * kTile;
  const int* rows = p.rows + (long long)b * p.n_tiles * kTile * 2;
  init_bars<kS>(bars);
  // the next query tile after i whose rows see one of the block's keys;
  // n_tiles past the last
  auto next = [&](int i) {
    do {
      ++i;
    } while (i < p.n_tiles && !tile_sees(__ldg(tiles + i), kv0, kv_last));
    return i;
  };

  // tile i into stage s: its Q and dO, its rows' lse2 and delta and
  // their bounds
  auto load_part = [&](int i, int s) {
    const uint32_t full = bar_full(bars, s);
    mbar_expect_tx(full, L::kKBytes + L::kVBytes + L::kStatBytes +
                             L::kRowBytes);
#pragma unroll
    for (int c = 0; c < DK / kTmaPanel; ++c)
      tma_load_4d(base + L::kQ + s * L::kKBytes + c * kR * 128, &tm_q,
                  full, c * kTmaPanel, h, i * kTile, b);
#pragma unroll
    for (int c = 0; c < DV / kTmaPanel; ++c)
      tma_load_4d(base + L::kO + s * L::kVBytes + c * kR * 128, &tm_do,
                  full, c * kTmaPanel, h, i * kTile, b);
    bulk_load(base + L::kStat + s * L::kStatBytes, stats + i * 2 * kTile,
              L::kStatBytes, full);
    bulk_load(base + L::kRow + s * L::kRowBytes, rows + i * kTile * 2,
              L::kRowBytes, full);
  };
  // the copier: K, V and the first kS parts now, the rest in the loop
  // below
  const bool copier = tid == 128;
  int i = next(-1);
  int ahead = p.n_tiles;                  // the copier's next part's tile
  if (copier) {
    mbar_expect_tx(bars, L::kKBytes + L::kVBytes);
#pragma unroll
    for (int c = 0; c < DK / kTmaPanel; ++c)
      tma_load_4d(base + L::kK + c * kR * 128, &tm_k, bars, c * kTmaPanel,
                  hk, kv0, b);
#pragma unroll
    for (int c = 0; c < DV / kTmaPanel; ++c)
      tma_load_4d(base + L::kV + c * kR * 128, &tm_v, bars, c * kTmaPanel,
                  hk, kv0, b);
    ahead = i;
    for (int n = 0; n < kS && ahead < p.n_tiles; ++n, ahead = next(ahead))
      load_part(ahead, n);
  }

  // ---- consumers: warpgroup 0 the S^T side (dV), 1 the dP^T side (dK),
  // each running its own loop: a wgmma that the two sides issue with
  // other widths inside one loop is divergent code, where ptxas
  // serialises every wgmma (C7520)
  const int wgi = tid / 128, t = tid % 128, warp = t / 32, lane = tid % 32;
  const int tig = lane & 3;
  const int key0 = kv0 + warp * 16 + (lane >> 2);    // and key0 + 8
  const float lg_in = kSoftcap ? 2.f * kLog2e * p.scale / p.softcap
                               : p.scale * kLog2e;
  const float lg_out = p.softcap * kLog2e;
  mbar_wait(bars, 0);
  auto side = [&](auto role) {
    constexpr int kSide = decltype(role)::value;
    // the scores' depth and the accumulator's width: S^T = K Q^T over
    // DK and dV (DV wide), or dP^T = V dO^T over DV and dK (DK wide)
    constexpr int kDepth = kSide ? DV : DK, kW = kSide ? DK : DV;
    const uint64_t a_desc = sw128_desc(base + (kSide ? L::kV : L::kK), 16);
    // the S^T side reads Q for its scores and dO for its product, the
    // dP^T side the other way round
    const uint32_t score_b = base + (kSide ? L::kO : L::kQ);
    const uint32_t acc_b = base + (kSide ? L::kQ : L::kO);
    constexpr int score_st = kSide ? L::kVBytes : L::kKBytes;
    constexpr int acc_st = kSide ? L::kKBytes : L::kVBytes;
    float acc[kW / 2];                    // dV or dK rows key0, key0 + 8
#pragma unroll
    for (int j = 0; j < kW / 2; ++j) acc[j] = 0.f;

    // part n (tile i) in stage s: waits for its copy
    auto arrived = [&](int s, int n) {
      if (kProbe != kNoCopies || n < kS)
        mbar_wait(bar_full(bars, s), (n / kS) & 1);
    };
    // its scores, issued as one wgmma group and not waited for
    auto scores = [&](float (&sc)[kR / 2], int s) {
      wgmma_fence();
      issue_abt<T, kDepth, kR, kR>(sc, a_desc,
                                   sw128_desc(score_b + s * score_st, 16));
    };
    // its elementwise math, through exchange buffer x: the S^T side
    // writes P^T once the dP^T side has read the buffer's last part
    // (reuse), the dP^T side reads it and then frees the buffer for a
    // later part (later)
    auto math = [&](float (&sc)[kR / 2], int s, int i, int x, bool reuse,
                    bool later) {
      const float* st = reinterpret_cast<const float*>(
          sm + L::kStat + s * L::kStatBytes);
      float4* xbuf = reinterpret_cast<float4*>(sm + L::kX + x * L::kXBytes);
      if constexpr (kSide == 0) {
        if (reuse) named_sync(bar_pfree(x));
        if constexpr (kProbe != kNoMath) {
          // element 4 nn + e: key key0 + 8 (e >> 1), query row nn * 8 +
          // 2 tig + (e & 1) of the part
          const int* rb =
              reinterpret_cast<const int*>(sm + L::kRow + s * L::kRowBytes);
          const bool masked = !tile_full(__ldg(tiles + i), kv0, kv_last);
#pragma unroll
          for (int nn = 0; nn < kR / 8; ++nn) {
            const int col = nn * 8 + tig * 2;
            const float2 l2 = *reinterpret_cast<const float2*>(st + col);
            int4 bnd = make_int4(0, 0, 0, 0);
            if (masked) bnd = *reinterpret_cast<const int4*>(rb + 2 * col);
            float pf[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pf[e] = prob_elem<kSoftcap>(
                  sc[4 * nn + e], (e & 1) ? l2.y : l2.x, key0 + 8 * (e >> 1),
                  (e & 1) ? bnd.z : bnd.x, (e & 1) ? bnd.w : bnd.y, masked,
                  lg_in, lg_out);
            xbuf[nn * 128 + t] = make_float4(pf[0], pf[1], pf[2], pf[3]);
          }
        }
        named_arrive(bar_pfull(x));
      } else {
        named_sync(bar_pfull(x));
        if constexpr (kProbe != kNoMath) {
#pragma unroll
          for (int nn = 0; nn < kR / 8; ++nn) {
            const float4 xv = xbuf[nn * 128 + t];
            const float2 dl = *reinterpret_cast<const float2*>(
                st + kR + nn * 8 + tig * 2);
            const float pf[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e)
              sc[4 * nn + e] = pf[e] *
                               (sc[4 * nn + e] - ((e & 1) ? dl.y : dl.x)) *
                               p.scale;
          }
        }
        if (later) named_arrive(bar_pfree(x));
      }
    };
    // dV += P^T dO, or dK += dS^T Q, issued and not waited for
    auto product = [&](uint32_t (&f)[kR / 4], const float (&sc)[kR / 2],
                       int s) {
      pack<T, kR>(f, sc);
      fence_regs(f);
      fence_regs(acc);
      wgmma_fence();
      issue_fz<T, kW, kR>(acc, f, sw128_desc(acc_b + s * acc_st, kR * 128));
    };
    // part n's stage read by this warpgroup; the copier refills it with
    // part n + kS once both sides are done with it (the S^T side runs
    // ahead, so it already is)
    auto done = [&](int s, int n) {
      release(bar_free<kS>(bars, s));
      if (kSide == 1 && kProbe != kNoCopies && copier && ahead < p.n_tiles) {
        mbar_wait(bar_free<kS>(bars, s), (n / kS) & 1);
        load_part(ahead, s);
        ahead = next(ahead);
      }
    };

    float sc[kR / 2];                     // S^T then P^T, or dP^T then dS^T
    uint32_t f[kR / 4];
    int n = 0;
    if constexpr (kPair<DK>) {
      // parts n (tile i, exchange 0) and n + 1 (tile ib, exchange 1)
      float sc2[kR / 2];
      uint32_t f2[kR / 4];
      int ib = i < p.n_tiles ? next(i) : p.n_tiles;
      while (ib < p.n_tiles) {
        const int sa = n % kS, sb = (n + 1) % kS;
        const int ic = next(ib);          // parts n + 2 and n + 3
        const int id = ic < p.n_tiles ? next(ic) : p.n_tiles;
        arrived(sa, n);
        scores(sc, sa);
        arrived(sb, n + 1);
        scores(sc2, sb);
        wgmma_wait<1>();                  // part n's scores
        fence_regs(sc);
        math(sc, sa, i, 0, n > 0, kXB == 1 || ic < p.n_tiles);
        product(f, sc, sa);
        wgmma_wait<1>();                  // part n + 1's scores
        fence_regs(sc2);
        math(sc2, sb, ib, kXB - 1, kXB == 1 || n > 0,
             (kXB == 1 ? ic : id) < p.n_tiles);
        product(f2, sc2, sb);
        wgmma_wait<1>();                  // part n's product
        fence_regs(f);
        done(sa, n);
        // nothing in flight across the back edge (else C7515)
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(f2);
        done(sb, n + 1);
        n += 2;
        i = ic;
        ib = id;
      }
    }
    // one part an iteration: every part at D 256, at 192 / 128 the last
    // of an odd count (exchange 0, read by no later part)
    for (; i < p.n_tiles; ++n) {
      const int s = n % kS;
      const int in = next(i);             // the part after this one
      arrived(s, n);
      scores(sc, s);
      wgmma_wait<0>();
      fence_regs(sc);
      math(sc, s, i, 0, kXB == 2 ? n > 1 : n > 0, in < p.n_tiles);
      product(f, sc, s);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(f);
      done(s, n);
      i = in;
    }
    if constexpr (kProbe != kNoProbe) return;

    // rows key0 and key0 + 8: this head's float32 partial, or with one
    // query head per kv head the result; part[0] is dK, part[1] dV, each
    // row max(DK, DV) floats apart
    constexpr int kP = DK > DV ? DK : DV;
    const long long other = kSide ? 0 : (long long)p.B * p.S * p.Hq * kP;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key >= p.S) continue;
#pragma unroll
      for (int nn = 0; nn < kW / 8; ++nn) {
        const int col = nn * 8 + tig * 2, j = 4 * nn + 2 * half;
        if (p.part != nullptr) {
          const long long at =
              (((long long)b * p.S + key) * p.Hq + h) * kP + col;
          *reinterpret_cast<float2*>(p.part + other + at) =
              make_float2(acc[j], acc[j + 1]);
        } else {
          const long long at =
              (((long long)b * p.S + key) * p.Hkv + hk) * kW + col;
          *reinterpret_cast<uint32_t*>((T*)(kSide ? p.dk : p.dv) + at) =
              Ops<T>::pack(acc[j], acc[j + 1]);
        }
      }
    }
  };
  if (wgi == 0)
    side(std::integral_constant<int, 0>{});
  else
    side(std::integral_constant<int, 1>{});
}

// (e) dk and dv: the G float32 partials of each kv head, summed in head
// order and rounded; four elements a thread.  A partial's rows are
// max(D, Dv) floats apart.  The ffma pair's partials too, float32
// included
template <typename T>
__global__ void __launch_bounds__(256) gqa_sum_kernel(const Params p) {
  const long long rows = (long long)p.B * p.S * p.Hkv;
  const long long quads_k = rows * p.D / 4;
  long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= quads_k + rows * p.Dv / 4) return;
  const int which = i >= quads_k;               // 0 dk, 1 dv
  if (which) i -= quads_k;
  const int G = p.Hq / p.Hkv;
  const int W = which ? p.Dv : p.D, Dp = max(p.D, p.Dv);
  const long long e = 4 * i;                    // into (B, S, Hkv, W)
  const int d = (int)(e % W);
  const long long bsk = e / W;                  // (b S + s) Hkv + hk
  const int hk = (int)(bsk % p.Hkv);
  const float* src = p.part + which * ((long long)p.B * p.S * p.Hq * Dp) +
                     ((bsk / p.Hkv) * p.Hq + (long long)hk * G) * Dp + d;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int gi = 1; gi < G; ++gi) {
    const float4 x = *reinterpret_cast<const float4*>(src + (long long)gi * Dp);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  T* dst = (T*)(which ? p.dv : p.dk) + e;
  if constexpr (std::is_same<T, float>::value)
    *reinterpret_cast<float4*>(dst) = acc;
  else
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(Ops<T>::pack(acc.x, acc.y), Ops<T>::pack(acc.z, acc.w));
}

}  // namespace wg

// ---- launches --------------------------------------------------------------
template <typename K>
int launch(K kern, dim3 grid, int smem, const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_delta(const Params& p, cudaStream_t s) {
  const long long rows = (long long)p.B * p.T * p.Hq;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// the ffma pair's launches: delta, dK and dV, dQ, and with G > 1 the
// GQA sum
template <typename T, int DM>
int launch_ffma(const Params& p, cudaStream_t s) {
  constexpr int BK = kFfmaKeys<DM>;
  int e = launch_delta<T>(p, s);
  if (e != 0) return e;
  e = launch(dkdv_ffma_kernel<T, DM>, dim3((p.S + BK - 1) / BK, p.Hq, p.B),
             ((2 * BK + 2 * 16) * (DM + 1) + 2 * BK * 17) * 4, p, s);
  if (e != 0) return e;
  e = launch(dq_ffma_kernel<T, DM>, dim3((p.T + 15) / 16, p.Hq, p.B),
             ((2 * 16 + 2 * 32) * (DM + 1) + 16 * 33) * 4, p, s);
  if (e != 0 || p.part == nullptr) return e;
  const long long sum_blocks =
      ((long long)p.B * p.S * p.Hkv * (p.D + p.Dv) / 4 + 255) / 256;
  if (sum_blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  wg::gqa_sum_kernel<T><<<(unsigned)sum_blocks, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ffma_any(const Params& p, cudaStream_t s) {
  const int dm = p.D > p.Dv ? p.D : p.Dv;
  return dm <= 64    ? launch_ffma<T, 64>(p, s)
         : dm <= 128 ? launch_ffma<T, 128>(p, s)
                     : launch_ffma<T, 256>(p, s);
}

// one launch of a wgmma kernel of `threads` threads with `smem` bytes of
// dynamic shared memory
template <typename K>
int launch_tma(K kern, dim3 grid, int threads, int smem,
               const CUtensorMap& m0,
               const CUtensorMap& m1, const CUtensorMap& m2,
               const CUtensorMap& m3, const Params& p, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, threads, smem, s>>>(m0, m1, m2, m3, p);
  return (int)cudaGetLastError();
}

// DK: the width of q and k; DV: of v, o and dout (DK = DV but for MLA's
// 192 / 128).  With a probe code (192 / 128 only) the pre-pass alone
// (kPrePassAlone), or it and the dK/dV pass alone: the function's
// (kPassAlone) or a probe of it (kNoMath, kNoCopies).
template <typename T, int DK, int DV, bool kSoftcap, int kProbe = 0>
int launch_wgmma(const Params& p, cudaStream_t s) {
  constexpr int kKernelProbe =
      kProbe == wg::kNoMath || kProbe == wg::kNoCopies ? kProbe
                                                       : wg::kNoProbe;
  constexpr CUtensorMapDataType type = tma_type<T>();
  // keys of a dK/dV block: 128 at D 64 and 128, 64 in the one pass by
  // role at D 256 and 192 / 128; the dQ kernel's blocks of 128 rows
  // stream kSub keys a stage
  constexpr bool roles = DK >= 192;
  constexpr int blk = roles ? wg::kRoleRows : wg::kBlock;
  constexpr int sub = wg::kSub<DK>;
  const long long key_blocks = (p.S + blk - 1) / blk;
  const long long sum_blocks =
      ((long long)p.B * p.S * p.Hkv * (DK + DV) / 4 + 255) / 256;
  if (key_blocks > 65535 || p.n_tiles / 2 > 65535 ||
      (long long)p.B * p.Hq > (wg::kHeadMajor<DK> ? 65535 : INT_MAX) ||
      sum_blocks > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  // q and dO in streamed tiles of 64 rows (dK, dV) and blocks of 128
  // (dQ); k and v in blocks of blk keys (dK, dV) and streamed tiles of
  // sub (dQ)
  CUtensorMap q_t, o_t, k_b, v_b, q_b, o_b, k_t, v_t;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int width, heads, n;
    long long sh, st, sb;
    int rows;
  } maps[8] = {
      {&q_t, p.q, DK, p.Hq, p.T, p.q_sh, p.q_st, p.q_sb, wg::kTile},
      {&o_t, p.dout, DV, p.Hq, p.T, p.d_sh, p.d_st, p.d_sb, wg::kTile},
      {&k_b, p.k, DK, p.Hkv, p.S, p.k_sh, p.k_ss, p.k_sb, blk},
      {&v_b, p.v, DV, p.Hkv, p.S, p.v_sh, p.v_ss, p.v_sb, blk},
      {&q_b, p.q, DK, p.Hq, p.T, p.q_sh, p.q_st, p.q_sb, wg::kBlock},
      {&o_b, p.dout, DV, p.Hq, p.T, p.d_sh, p.d_st, p.d_sb, wg::kBlock},
      {&k_t, p.k, DK, p.Hkv, p.S, p.k_sh, p.k_ss, p.k_sb, sub},
      {&v_t, p.v, DV, p.Hkv, p.S, p.v_sh, p.v_ss, p.v_sb, sub}};
  for (const auto& m : maps) {
    const int e = make_map(m.map, m.ptr, type, m.width, m.heads, m.n, p.B,
                           m.sh, m.st, m.sb, m.rows);
    if (e != 0) return e;
  }
  wg::prep_kernel<T><<<dim3(p.n_tiles, p.Hq, p.B), 256, 0, s>>>(p);
  int e = (int)cudaGetLastError();
  if (kProbe == wg::kPrePassAlone) return e;
  const dim3 kv_grid =
      wg::kHeadMajor<DK> ? dim3((unsigned)key_blocks, p.B * p.Hq)
                         : dim3(p.B * p.Hq, (unsigned)key_blocks);
  if constexpr (roles) {
    if (e == 0)
      e = launch_tma(wg::dkdv_roles_kernel<T, DK, DV, kSoftcap, kKernelProbe>,
                     kv_grid, wg::kRoleThreads,
                     wg::RoleKVLayout<DK, DV>::kBytes + 1024, q_t, o_t, k_b,
                     v_b, p, s);
    if (kProbe != 0) return e;
  } else {
    static_assert(DK == DV, "two passes take DK = DV");
    const int kv_smem = wg::KVLayout<DK>::kBytes + 1024;   // + the alignment
    if (e == 0)
      e = launch_tma(wg::dkv_wgmma_kernel<T, DK, kSoftcap, false>, kv_grid,
                     wg::kThreads3, kv_smem, q_t, o_t, k_b, v_b, p, s);
    if (e == 0)
      e = launch_tma(wg::dkv_wgmma_kernel<T, DK, kSoftcap, true>, kv_grid,
                     wg::kThreads3, kv_smem, q_t, o_t, k_b, v_b, p, s);
  }
  if (e == 0)
    e = launch_tma(wg::dq_wgmma_kernel<T, DK, DV, kSoftcap>,
                   dim3(p.B * p.Hq, p.n_tiles / 2), wg::kThreadsAt<DK>,
                   wg::QLayout<DK, DV>::kBytes + 1024, q_b, o_b, k_t, v_t, p,
                   s);
  if (e != 0 || p.part == nullptr) return e;
  wg::gqa_sum_kernel<T><<<(unsigned)sum_blocks, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int DK, int DV = DK>
int launch_16(const Params& p, cudaStream_t s) {
  return p.softcap != 0.f ? launch_wgmma<T, DK, DV, true>(p, s)
                          : launch_wgmma<T, DK, DV, false>(p, s);
}


}  // namespace

// dtype: 0 float32, 1 bfloat16 or 2 float16, for q, k, v, o, dout, dq,
// dk and dv alike.  Head dims: Dh (q, k) and Dv (v, o, dout) multiples
// of 8 up to 256, what the forward takes.  The wgmma variant takes the
// 16-bit types at Dh = Dv in {64, 128, 256} and at Dh 192 / Dv 128; the
// ffma pair every other type and pair.  Any other head dim or dtype, or
// missing scratch, returns cudaErrorInvalidValue and launches nothing.
// strides: 17 element
// strides, (batch, position, head) of q, k, v, o and dout, then (batch,
// position) of qpos (int32); every last dim is unit-stride.  lse (B, Hq,
// T) float32 from the forward.  Scratch, allocated by the caller, with
// n = 2 ceil(T / 128): delta float32, (B, Hq, T) for ffma, (B, Hq, n, 2,
// 64) for wgmma; rows int32 (B, 64 n, 2) then (B, n, 4) for wgmma, else
// null; part float32 (2, B, S, Hq, max(Dh, Dv)) for either variant with
// Hq > Hkv, else null.  dq (B, T, Hq, Dh), dk (B, S, Hkv, Dh) and dv (B,
// S, Hkv, Dv) contiguous outputs.
// has_window = 0 means causal only.  The caller checks Hq % Hkv == 0,
// 16-byte aligned rows for 16-bit types and grid limits; with B, T, S
// or Hq zero nothing is launched (the caller's outputs are zeros).
// Launches the variant's kernels on `stream` and returns
// cudaGetLastError() after the first that fails, else 0, or a negative
// code when a TMA tensor map could not be built (-1: no
// cuTensorMapEncodeTiled in the driver; -1000 - r: it returned CUresult
// r).
extern "C" int flash_attn_bwd_hd(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const int* qpos, const void* lse,
                                 void* delta, void* rows, void* part,
                                 void* dq, void* dk, void* dv, int dtype,
                                 int B, int T, int S, int Hq, int Hkv, int D,
                                 int Dv, const long long* strides,
                                 float scale, float softcap, int has_window,
                                 long long window, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0) return 0;
  if (D <= 0 || D > 256 || D % 8 != 0 || Dv <= 0 || Dv > 256 ||
      Dv % 8 != 0 || dtype < 0 || dtype > 2 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  // MLA's naive form: q and k 192 wide, v 128
  const bool mla = D == 192 && Dv == 128;
  const bool wgmma_dims = D == Dv && (D == 64 || D == 128 || D == 256);
  const bool wgmma = dtype != 0 && (wgmma_dims || mla);
  if ((wgmma && rows == nullptr) || (Hq > Hkv && part == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, qpos, (const float*)lse, (float*)delta,
           (int*)rows, Hq > Hkv ? (float*)part : nullptr,
           dq, dk, dv, B, T, S, Hq, Hkv, D, Dv, (T + 127) / 128 * 2,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13], strides[14],
           strides[15], strides[16], scale, softcap, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  if (!wgmma)
    return dtype == 0   ? launch_ffma_any<float>(p, s)
           : dtype == 1 ? launch_ffma_any<__nv_bfloat16>(p, s)
                        : launch_ffma_any<__half>(p, s);
  if (dtype == 1)
    return mla        ? launch_16<__nv_bfloat16, 192, 128>(p, s)
           : D == 64  ? launch_16<__nv_bfloat16, 64>(p, s)
           : D == 128 ? launch_16<__nv_bfloat16, 128>(p, s)
                      : launch_16<__nv_bfloat16, 256>(p, s);
  return mla        ? launch_16<__half, 192, 128>(p, s)
         : D == 64  ? launch_16<__half, 64>(p, s)
         : D == 128 ? launch_16<__half, 128>(p, s)
                    : launch_16<__half, 256>(p, s);
}

// Probes of the dK/dV pass at Dh 192 / Dv 128 in bfloat16 without a
// softcap, for measurements, not the function: on flash_attn_bwd_hd's
// arguments, the pre-pass and then the pass with probe 1 its elementwise
// math left out, or 2 its copies of every part after the first three
// (dq, dk and dv not written); probe 3 the pre-pass alone, 4 the
// pre-pass and the dK/dV pass alone (dk and dv written, dq not), so that
// CUDA events time each launch by difference.  Any other shape, dtype or
// probe returns cudaErrorInvalidValue and launches nothing.
extern "C" int flash_attn_bwd_probe_hd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const int* qpos, const void* lse, void* delta,
    void* rows, void* part, void* dq, void* dk, void* dv, int dtype, int B,
    int T, int S, int Hq, int Hkv, int D, int Dv, const long long* strides,
    float scale, float softcap, int has_window, long long window,
    void* stream, int probe) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0) return 0;
  if (dtype != 1 || D != 192 || Dv != 128 || softcap != 0.f || Hkv <= 0 ||
      Hq % Hkv != 0 || rows == nullptr || (Hq > Hkv && part == nullptr) ||
      probe < wg::kNoMath || probe > wg::kPassAlone)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, dout, qpos, (const float*)lse, (float*)delta,
           (int*)rows, Hq > Hkv ? (float*)part : nullptr,
           dq, dk, dv, B, T, S, Hq, Hkv, D, Dv, (T + 127) / 128 * 2,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11], strides[12], strides[13], strides[14],
           strides[15], strides[16], scale, softcap, has_window, window};
  cudaStream_t s = (cudaStream_t)stream;
  using BF = __nv_bfloat16;
  switch (probe) {
    case wg::kNoMath:
      return launch_wgmma<BF, 192, 128, false, wg::kNoMath>(p, s);
    case wg::kNoCopies:
      return launch_wgmma<BF, 192, 128, false, wg::kNoCopies>(p, s);
    case wg::kPrePassAlone:
      return launch_wgmma<BF, 192, 128, false, wg::kPrePassAlone>(p, s);
    default:
      return launch_wgmma<BF, 192, 128, false, wg::kPassAlone>(p, s);
  }
}
