// Hopper building blocks shared by the wgmma variants of the flash
// forward (flash_attn_hd.cu) and backward (flash_attn_bwd_hd.cu):
// mbarriers, TMA copies (tensor maps built at run time through the
// driver's cuTensorMapEncodeTiled), wgmma shared-memory descriptors for
// the 128-byte swizzle, and the wgmma products m64n{32,64}k16 (both operands
// in shared memory) and m64n{64,128,192,256}k16 (A in registers, B read
// MN-major), and the softcap's tanh on the MUFU.  Every function is
// inline; each source that includes the header compiles its own copy.
// sm_90a only.
#pragma once

#include <cuda.h>          // CUtensorMap; the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTmaPanel = 64;   // 16-bit elements in one 128-byte row

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the thread sleeps in the wait (up to the 10 ms hint) instead of
// spinning and taking issue slots from the warps that compute
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
// Waits until the phase of parity `parity` of the barrier has
// completed.  Every wait here is for a copy or for one tile's work,
// microseconds; one that outlasts 2^32 cycles (over 2 s) traps, so a
// fault in the pipeline ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// one box of a 4-d tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes global -> shared, both
// 16-byte aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units, the latter two
// in the high word.  K-major operands step 8-row groups by 1024 bytes
// and ignore the leading offset; MN-major ones step 8-row groups of the
// reduction dim by 1024 bytes and 64-column panels by `lbo` (the
// panel's bytes).  Shared addresses stay under 256 KB, so an offset
// added to the low word never carries into the other fields.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  const uint32_t lo = ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
  const uint32_t hi = (1024u >> 4) | (1u << 30);
  return ((uint64_t)hi << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x in one MUFU instruction; results under 2^-126 flush to 0, far
// below what p keeps once it is rounded to 16 bits
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) from x = 2 y log2(e), as 1 - 2 / (2^x + 1): one ex2 and one
// rcp, both approximate (MUFU), within about 5e-7 of tanh(y) (2^x = inf
// gives 1, 0 gives -1), where the library's tanhf takes some twenty
// instructions.  Times a softcap of 50 that is about 2.5e-5 of a
// logit, far under the 2^-9 to which p is rounded.
__device__ __forceinline__ float tanh_2log2e(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(ex2(x) + 1.f));
  return fmaf(-2.f, r, 1.f);
}

#define WG_D8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define WG_D16 WG_D8(0), WG_D8(8)
#define WG_D32 WG_D16, WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_D96 WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88)
#define WG_D128                                                           \
  WG_D64, WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96),          \
      WG_D8(104), WG_D8(112), WG_D8(120)

// D (64 x 64, f32) (+)= A (64 x 16, shared, K-major) B^T (64 x 16,
// shared, K-major); scale_d = 0 overwrites D
#define WGMMA_SS_N64(TY)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "              \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "          \
  "%25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
// D (64 x 32, f32) (+)= A (64 x 16, shared, K-major) B^T (32 x 16,
// shared, K-major)
#define WGMMA_SS_N32(TY)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "              \
  "%13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
// D (64 x N, f32) += A (64 x 16, registers) B (16 x N, shared, MN-major)
#define WGMMA_RS_N128(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "              \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "          \
  "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "          \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "          \
  "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "          \
  "%61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N256(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                           \
  "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " "            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "          \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "          \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "  \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "    \
  "%119, %120, %121, %122, %123, %124, %125, %126, %127}, "               \
  "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N192(TY)                                                 \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"                           \
  "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " "            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                   \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "          \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "          \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "          \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "          \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "          \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "         \
  "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
#define WGMMA_RS_N64(TY)                                                  \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "              \
  "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "          \
  "%25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, "            \
  "%36, p, 1, 1, 1;\n}\n"

template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_SS_N64("f16") : WG_D32 : "l"(da), "l"(db),
                 "r"(scale_d));
  else
    asm volatile(WGMMA_SS_N64("bf16") : WG_D32 : "l"(da), "l"(db),
                 "r"(scale_d));
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_SS_N32("f16") : WG_D16 : "l"(da), "l"(db),
                 "r"(scale_d));
  else
    asm volatile(WGMMA_SS_N32("bf16") : WG_D16 : "l"(da), "l"(db),
                 "r"(scale_d));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_RS_N256("f16") : WG_D128 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(WGMMA_RS_N256("bf16") : WG_D128 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[96], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_RS_N192("f16") : WG_D96 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(WGMMA_RS_N192("bf16") : WG_D96 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_RS_N128("f16") : WG_D64 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(WGMMA_RS_N128("bf16") : WG_D64 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    asm volatile(WGMMA_RS_N64("f16") : WG_D32 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  else
    asm volatile(WGMMA_RS_N64("bf16") : WG_D32 : "r"(a[0]), "r"(a[1]),
                 "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// one arrival per consumer warp, once the warp's wgmma reads are done
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// cuTensorMapEncodeTiled from the driver, found at run time so that the
// library links against the CUDA runtime alone
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Errors of the host-side set-up, returned negative so that they do not
// collide with cudaError_t codes.
constexpr int kNoEncoder = -1;        // the driver has no cuTensorMapEncodeTiled
constexpr int kEncodeFailed = -1000;  // minus the CUresult

// A 4-d map over (D, heads, positions, batch) of a 16-bit operand with
// element strides (head, position, batch); boxes of 64 x 1 x rows x 1
// with the 128-byte swizzle; boxes past the end read as zeros.
int make_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
             int D, int heads, long long n, int batch, long long s_head,
             long long s_pos, long long s_batch, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)(n > 0 ? n : 1),
                              (cuuint64_t)batch};
  const long long elem[3] = {s_head, s_pos, s_batch};
  // a dim of extent 1 is never stepped along (the caller passes stride
  // 0): give it the packed stride, which TMA accepts
  cuuint64_t strides[3];
  cuuint64_t span = (cuuint64_t)D * 2;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] > 1 ? (cuuint64_t)elem[i] * 2 : span;
    span = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)kTmaPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, type, 4, const_cast<void*>(base), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed - (int)r;
}

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

}  // namespace
