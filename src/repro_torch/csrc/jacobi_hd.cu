// One 5-point Jacobi sweep over a row-major (M, N) float32 array; the
// first and last rows and columns pass through unchanged.
//
// Replaces the TPU kernel `jacobi_pallas` / `_jacobi_kernel` in
// src/repro/kernels/stencil_hd/kernel.py.
//
// Bound on an H100: bytes.  A sweep must read M*N*4 bytes and write 4
// bytes for each element it produces, for 5 floating-point operations
// per element (0.6 flop per byte), so its floor is the bytes over the
// 3.35 TB/s of device memory.  The design therefore only tries to
// touch each byte once:
// every thread owns one column and walks kRows consecutive rows,
// carrying the above / centre / below values of its column in
// registers, so each vertical neighbour comes from device memory once;
// the left and right neighbours are the adjacent threads' centre
// values and hit in L1.  A warp's loads and stores are 128 contiguous
// bytes.  The ragged last block of rows or columns is masked, never
// padded.  The kernel writes only a window of the result, rows
// [i0, i1) and columns [j0, j1), through a row pitch: a rank's step
// sweeps its slab (band plus halo rows) and stores the band's interior
// straight into the destination buffer, with no temporary and no
// copy back.  Threads are laid out from column j0 rounded down to a
// multiple of 32, not from j0, so that a warp's accesses stay on
// 128-byte lines when the window starts at column 1 (threads left of
// j0 only return).  Vector loads are later work.
//
// Bitwise contract: the sum is ((left + right) + above) + below in
// float32, then * 0.25f, written with __fadd_rn / __fmul_rn so that
// the compiler can neither contract nor reassociate it.  That is the
// plain PyTorch version's order and the reference's (x / 4 == x * 0.25
// exactly in IEEE), so the sweep is bit-identical to both.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;
constexpr int kAlign = 32;  // columns per 128-byte line of float32

__global__ void __launch_bounds__(kThreads)
jacobi_kernel(const float* __restrict__ x, float* __restrict__ y,
              int M, int N, long long ldx, long long ldy,
              int i0, int i1, int j0, int j1) {
  const int j = j0 / kAlign * kAlign + blockIdx.x * kThreads + threadIdx.x;
  if (j < j0 || j >= j1) return;
  const int r0 = i0 + blockIdx.y * kRows;
  const int r1 = min(r0 + kRows, i1);
  const bool edge_col = (j == 0) || (j == N - 1);
  const float* col = x + j;
  float* out_col = y + (j - j0);
  float above = (r0 > 0) ? col[(long long)(r0 - 1) * ldx] : 0.f;
  float centre = col[(long long)r0 * ldx];
  for (int i = r0; i < r1; ++i) {
    const long long r = (long long)i * ldx;
    const float below = (i + 1 < M) ? col[r + ldx] : 0.f;
    float out = centre;
    if (!edge_col && i != 0 && i != M - 1) {
      const float left = col[r - 1];
      const float right = col[r + 1];
      out = __fmul_rn(
          __fadd_rn(__fadd_rn(__fadd_rn(left, right), above), below), 0.25f);
    }
    out_col[(long long)(i - i0) * ldy] = out;
    above = centre;
    centre = below;
  }
}

}  // namespace

// x: (M, N) rows of pitch ldx elements.  Writes rows [i0, i1) and
// columns [j0, j1) of the sweep to y, whose rows have pitch ldy: the
// result's element (i, j) goes to y[(i - i0) * ldy + (j - j0)].  y must
// not overlap x.  Returns cudaGetLastError() after the launch.
extern "C" int jacobi_hd_f32(const void* x, void* y, int M, int N,
                             long long ldx, long long ldy, int i0, int i1,
                             int j0, int j1, void* stream) {
  if (i1 <= i0 || j1 <= j0) return 0;
  const dim3 grid((j1 - j0 / kAlign * kAlign + kThreads - 1) / kThreads,
                  (i1 - i0 + kRows - 1) / kRows);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  jacobi_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, M, N, ldx, ldy, i0, i1, j0, j1);
  return (int)cudaGetLastError();
}
