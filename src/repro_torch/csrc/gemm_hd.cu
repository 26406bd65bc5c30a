// C (M, N) = alpha * A (M, K) @ B (K, N) with float32 accumulation;
// A and B are both float32 or both bfloat16, C is float32 or bfloat16.
//
// Replaces the TPU kernel `gemm_pallas` / `_gemm_kernel`
// (src/repro/kernels/gemm_hd/kernel.py:40).
//
// Bound on an H100: operations.  The product does 2*M*N*K flops on
// (M*K + K*N + M*N) elements: at the main path's (2560, 10240, 10240)
// that is over 3000 flops per byte, so its floor is the FP32 peak
// outside the tensor cores, 67 TFLOP/s on an H100 SXM (8.013 ms).
// float32 inputs must take the IEEE path (FFMA), not TF32, to meet the
// reference's bound against a float64 product, which rules the tensor
// cores out for them: the only way to the bound is to keep the FFMA
// pipes fed.
//
// Two variants, chosen by the caller (kernels/gemm_hd/kernel.py:
// gemm_variant) and launched as asked or not at all:
//
// * pipelined (float32 in and out, the main path).  A block of 256
//   threads owns a 128 x 128 tile of C; its 8 warps tile it 2 x 4, 64 x
//   32 each, and a thread keeps 8 x 8 outputs as 2 x 2 sub-tiles of
//   4 x 4, rows 32 and columns 16 apart.  Each k step feeds its 64 FFMAs
//   from four 16-byte shared loads (two of A, two of B), conflict-free
//   or broadcast within a warp.  K advances 16 at a time through two
//   shared-memory stages: the next slice's global loads (16 bytes a
//   thread) are in flight in registers while the current one is
//   multiplied, then land in the other stage, with one barrier per
//   slice.  A is stored k-major (transposed through those registers)
//   so that its loads are 16 bytes wide too.  Tiles inside C with
//   16-byte aligned rows take unmasked vector loads and stores; edge
//   tiles and odd pitches take masked scalar ones.  Each output sums
//   its K products in order with fmaf and is scaled once by alpha
//   (__fmul_rn).  __launch_bounds__(256, 2) keeps two blocks per SM.
// * tiled (any bfloat16 input or output): the first design, one
//   8-deep K step staged in shared memory at a time, converted to
//   float32 on load; thread (ty, tx) owns rows ty + 16*i and columns
//   tx + 16*j.
//
// Ragged M, N and K are masked (zero-filled loads, guarded stores),
// never padded.  Leading-dimension strides let a rank's row band of a
// larger buffer go in without a copy, and let the result go straight
// into the rank's row band of C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8, kTM = 8, kTN = 8;
constexpr int kThreads = 256;  // 16 x 16 threads, each kTM x kTN outputs

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch does
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const TIn* __restrict__ A, const TIn* __restrict__ B,
            TOut* __restrict__ C, int M, int N, int K, long long lda,
            long long ldb, long long ldc, float alpha) {
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // staging coordinates: A by (row, 4 consecutive k), B by (k, 4 columns
  // 32 apart so a warp's loads and shared stores are contiguous)
  const int a_row = tid >> 1, a_k = (tid & 1) * 4;
  const int b_k = tid >> 5, b_col = tid & 31;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int gm = m0 + a_row;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int gk = k0 + a_k + t;
      As[a_k + t][a_row] =
          (gm < M && gk < K) ? to_f32(A[(long long)gm * lda + gk]) : 0.f;
    }
    const int gk = k0 + b_k;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int gn = n0 + b_col + 32 * t;
      Bs[b_k][b_col + 32 * t] =
          (gk < K && gn < N) ? to_f32(B[(long long)gk * ldb + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) store(&C[(long long)gm * ldc + gn], __fmul_rn(alpha, acc[i][j]));
    }
  }
}


// ---- the pipelined float32 variant ------------------------------------
namespace pipe {

constexpr int kBM = 128, kBN = 128, kBK = 16;
constexpr int kThreads = 256;
constexpr int kLdA = kBM + 4;   // As[k][m]: 16-byte rows, fewer conflicts

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One K slice of A (kBM x kBK) and B (kBK x kBN) in registers: thread t
// holds A rows (t / 4) and (t / 4 + 64) at k 4 (t % 4) .. + 3, and B
// rows (t / 32) and (t / 32 + 8) at columns 4 (t % 32) .. + 3.
struct Slice {
  float4 a[2], b[2];
};

__device__ __forceinline__ void load_slice(Slice& r, const float* A,
                                           const float* B, int M, int N,
                                           int K, long long lda,
                                           long long ldb, int m0, int n0,
                                           int k0, bool vec_a, bool vec_b) {
  const int tid = threadIdx.x;
  const bool k_in = k0 + kBK <= K;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tid / 4 + 64 * h, k = k0 + 4 * (tid % 4);
    const int gm = m0 + row;
    if (vec_a && k_in) {
      r.a[h] = *reinterpret_cast<const float4*>(A + (long long)gm * lda + k);
    } else {
      const bool in = gm < M;
      const float* src = A + (long long)gm * lda + k;
      r.a[h].x = in && k < K ? src[0] : 0.f;
      r.a[h].y = in && k + 1 < K ? src[1] : 0.f;
      r.a[h].z = in && k + 2 < K ? src[2] : 0.f;
      r.a[h].w = in && k + 3 < K ? src[3] : 0.f;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gk = k0 + tid / 32 + 8 * h, col = n0 + 4 * (tid % 32);
    if (vec_b && k_in) {
      r.b[h] = *reinterpret_cast<const float4*>(B + (long long)gk * ldb + col);
    } else {
      const bool in = gk < K;
      const float* src = B + (long long)gk * ldb + col;
      r.b[h].x = in && col < N ? src[0] : 0.f;
      r.b[h].y = in && col + 1 < N ? src[1] : 0.f;
      r.b[h].z = in && col + 2 < N ? src[2] : 0.f;
      r.b[h].w = in && col + 3 < N ? src[3] : 0.f;
    }
  }
}

__device__ __forceinline__ void store_slice(const Slice& r,
                                            float (*As)[kLdA],
                                            float (*Bs)[kBN]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = tid / 4 + 64 * h, k = 4 * (tid % 4);
    As[k][row] = r.a[h].x;
    As[k + 1][row] = r.a[h].y;
    As[k + 2][row] = r.a[h].z;
    As[k + 3][row] = r.a[h].w;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float4*>(&Bs[tid / 32 + 8 * h][4 * (tid % 32)]) = r.b[h];
}

__global__ void __launch_bounds__(kThreads, 2)
gemm_f32_pipelined(const float* __restrict__ A, const float* __restrict__ B,
                   float* __restrict__ C, int M, int N, int K, long long lda,
                   long long ldb, long long ldc, float alpha) {
  __shared__ __align__(16) float As[2][kBK][kLdA];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // this thread's outputs: rows rb + 32 sm + i, columns cb + 16 sn + j
  const int rb = (warp / 4) * 64 + (lane / 4) * 4;
  const int cb = (warp % 4) * 32 + (lane % 4) * 4;
  const bool in_m = m0 + kBM <= M, in_n = n0 + kBN <= N;
  // unmasked 16-byte loads where the whole slice is inside and aligned
  const bool vec_a = in_m && lda % 4 == 0 && aligned16(A);
  const bool vec_b = in_n && ldb % 4 == 0 && aligned16(B);

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_slices = (K + kBK - 1) / kBK;
  Slice r;
  if (n_slices > 0) {
    load_slice(r, A, B, M, N, K, lda, ldb, m0, n0, 0, vec_a, vec_b);
    store_slice(r, As[0], Bs[0]);
  }
  __syncthreads();
  for (int kt = 0; kt < n_slices; ++kt) {
    const int s = kt & 1;
    const bool next = kt + 1 < n_slices;
    if (next)   // in flight while this slice is multiplied
      load_slice(r, A, B, M, N, K, lda, ldb, m0, n0, (kt + 1) * kBK, vec_a,
                 vec_b);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[s][kk][rb]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[s][kk][rb + 32]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[s][kk][cb]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[s][kk][cb + 16]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous barrier
    if (next) store_slice(r, As[s ^ 1], Bs[s ^ 1]);
    __syncthreads();
  }

  const bool vec_c = in_m && in_n && ldc % 4 == 0 && aligned16(C);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + rb + 32 * (i / 4) + i % 4;
#pragma unroll
    for (int sn = 0; sn < 2; ++sn) {
      const int gn = n0 + cb + 16 * sn;
      float* dst = C + (long long)gm * ldc + gn;
      const float4 v = make_float4(
          __fmul_rn(alpha, acc[i][4 * sn]), __fmul_rn(alpha, acc[i][4 * sn + 1]),
          __fmul_rn(alpha, acc[i][4 * sn + 2]),
          __fmul_rn(alpha, acc[i][4 * sn + 3]));
      if (vec_c) {
        *reinterpret_cast<float4*>(dst) = v;
      } else if (gm < M) {
        if (gn < N) dst[0] = v.x;
        if (gn + 1 < N) dst[1] = v.y;
        if (gn + 2 < N) dst[2] = v.z;
        if (gn + 3 < N) dst[3] = v.w;
      }
    }
  }
}

}  // namespace pipe

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            long long lda, long long ldb, long long ldc, float alpha,
            cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      (const TIn*)a, (const TIn*)b, (TOut*)c, M, N, K, lda, ldb, ldc, alpha);
}

}  // namespace

// variant: 0 tiled (any bfloat16 input or output), 1 pipelined
// (float32 in and out), as the caller chose it from the types; any
// other pairing returns cudaErrorInvalidValue and launches nothing.  a: (M, K) rows of pitch
// lda; b: (K, N) rows of pitch ldb; c: (M, N) rows of pitch ldc.
// in_bf16 / out_bf16 select bfloat16 over float32.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_hd(const void* a, const void* b, void* c, int M, int N,
                       int K, long long lda, long long ldb, long long ldc,
                       float alpha, int in_bf16, int out_bf16, int variant,
                       void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 1) {
    if (in_bf16 || out_bf16) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + pipe::kBN - 1) / pipe::kBN,
                    (M + pipe::kBM - 1) / pipe::kBM);
    pipe::gemm_f32_pipelined<<<grid, pipe::kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (float*)c, M, N, K, lda, ldb, ldc,
        alpha);
    return (int)cudaGetLastError();
  }
  if (variant != 0 || !(in_bf16 || out_bf16))
    return (int)cudaErrorInvalidValue;
  if (!in_bf16)
    launch<float, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
  else if (out_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
  else
    launch<__nv_bfloat16, float>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
  return (int)cudaGetLastError();
}
