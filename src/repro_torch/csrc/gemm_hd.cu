// C (M, N) = alpha * A (M, K) @ B (K, N) with float32 accumulation;
// A and B are both float32 or both bfloat16, C is float32 or bfloat16.
//
// Replaces the TPU kernel `gemm_pallas` / `_gemm_kernel` in
// src/repro/kernels/gemm_hd/kernel.py.
//
// Bound on an H100: operations.  The product does 2*M*N*K flops on
// (M*K + K*N + M*N) elements: at the main path's (2560, 10240, 10240)
// that is over 3000 flops per byte, so its floor is the FP32 peak
// outside the tensor cores, 67 TFLOP/s on an H100 SXM.  float32 inputs
// must take the IEEE path (FFMA), not TF32, to meet the reference's
// bound against a float64 product, which rules the tensor cores out
// for them.
//
// Design: the classic shared-memory tiling with register blocking.  A
// block of 256 threads owns a 128 x 128 tile of C; each thread keeps an
// 8 x 8 sub-tile in registers, so 16 shared-memory loads feed 64 FFMAs.
// Each K step stages a 128 x 8 slice of A (transposed, padded against
// bank conflicts) and an 8 x 128 slice of B in shared memory, converted
// to float32 on load, so bfloat16 inputs accumulate in float32 like the
// TPU kernel's scratch accumulator.  Thread (ty, tx) owns rows
// ty + 16*i and columns tx + 16*j: its shared-memory reads are
// broadcasts or conflict-free, and the warp's stores coalesce.  Ragged
// M, N and K are masked (zero-filled loads, guarded stores), never
// padded.  Leading-dimension strides let a rank's row band of a larger
// buffer go in without a copy, and let the result go straight into the
// rank's row band of C.  alpha is applied in the epilogue.
// Double buffering, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, int M, int N, int K,
            long long lda, long long ldb, long long ldc, float alpha,
            cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      (const TIn*)a, (const TIn*)b, (TOut*)c, M, N, K, lda, ldb, ldc, alpha);
}

}  // namespace

// a: (M, K) rows of pitch lda; b: (K, N) rows of pitch ldb; c: (M, N)
// rows of pitch ldc.  in_bf16 / out_bf16 select bfloat16 over float32.
// Returns cudaGetLastError() after the launch.
extern "C" int gemm_hd(const void* a, const void* b, void* c, int M, int N,
                       int K, long long lda, long long ldb, long long ldc,
                       float alpha, int in_bf16, int out_bf16, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
    else
      launch<__nv_bfloat16, float>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
    else
      launch<float, float>(a, b, c, M, N, K, lda, ldb, ldc, alpha, s);
  }
  return (int)cudaGetLastError();
}
