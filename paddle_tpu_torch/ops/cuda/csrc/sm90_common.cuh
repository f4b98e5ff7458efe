// Hopper (sm_90a) building blocks in raw PTX, shared by the tensor-core
// kernels (the *_sm90.cu files, and the *_tf32.cu files through
// sm90_tf32.cuh):
//   - mbarriers: init, arrive, arrive with an expected transaction count,
//     parity wait;
//   - TMA: a 4-D tiled tensor map over a [B, S, H, D] 16-bit tensor with its
//     own strides, encoded on the host through cuTensorMapEncodeTiled
//     (reached by cudaGetDriverEntryPoint, so the library needs no -lcuda),
//     and the tile load that completes on an mbarrier;
//   - cp.async: 4-byte copies into shared memory whose landing is an
//     arrival on an mbarrier;
//   - wgmma: the shared-memory matrix descriptor for the 128-byte swizzle,
//     fence / commit / wait, the m64nNk16 products with f32 accumulators
//     (A and B from shared memory, or A from registers), and the
//     accumulator's (row, col) map.
//
// Element type. Every product and packing helper takes the 16-bit element
// type T as a template parameter, __nv_bfloat16 (the default) or __half
// (Elem<T>: the wgmma type, the pair type and its rounding, the TMA data
// type); tiles, swizzles and descriptors are the same for both, since both
// are 2 bytes an element.
//
// Tile layout. A tile is loaded as boxes of 64 16-bit columns (128 bytes, one
// swizzle row) by `rows` rows; a head dim of 128 is two such boxes, one
// after the other. Each box lands 1024-byte aligned, in the 128-byte
// swizzle that wgmma's SW128 layout reads: 8-row atoms of 1024 bytes. For a
// K-major operand (the reduction dim contiguous) the descriptor steps 32
// bytes along a row per k16 slice; for an MN-major one (the output dim
// contiguous, the transpose bit set) it steps 16 rows, 2048 bytes, per k16
// slice, and LBO is the byte distance between 64-column boxes.
//
// Accumulator map of an m64nN product in a warpgroup: thread t (0..127),
// warp w = t / 32, lane l; d[4 i + 2 h + e] sits at row 16 w + l / 4 + 8 h,
// column 8 i + 2 (l % 4) + e (i < N / 8, h, e in {0, 1}). The four threads
// of a quad (l / 4 equal) share two rows. Rounding columns [16 k, 16 k + 16)
// of d pairwise to T gives, in order, the four A registers of k slice k
// of a product that takes d as its register operand (pack_a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// ------------------------------------------------------------ element type

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  using T2 = __nv_bfloat162;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static T2 pack2(float a, float b) { return __floats2bfloat162_rn(a, b); }
};

template <>
struct Elem<__half> {
  using T2 = __half2;
  static constexpr CUtensorMapDataType kTma = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  __device__ __forceinline__ static T2 pack2(float a, float b) { return __floats2half2_rn(a, b); }
};

template <typename T>
constexpr bool kIsHalf = std::is_same<T, __half>::value;

// two values rounded to nearest even into one register of T pairs
template <typename T>
__device__ __forceinline__ uint32_t pack_pair(float a, float b) {
  typename Elem<T>::T2 v = Elem<T>::pack2(a, b);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------------ device

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// returns once the barrier's phase of the given parity has completed. A
// phase that never completes (a lost arrival or transaction) traps after
// about 2^35 cycles, some 17 s, so it surfaces as a launch error, not a hang
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 35)) __trap();
}

// box at coordinates (c0, c1, c2, c3) = (column, head, row, batch) into
// shared memory at dst; its bytes complete a transaction on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4 bytes from global src into shared memory at dst, or 4 zero bytes when
// !valid (nothing is read then, but src must be a valid address); lands
// asynchronously, tracked by cp_async_mbar_arrive
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(valid ? 4 : 0)
               : "memory");
}

// an arrival on bar, one of its expected count (.noinc), made once this
// thread's earlier cp.async copies have landed
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle, atoms 1024-byte aligned
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ties the accumulator registers to this point of the program, so the
// compiler neither reads them before wgmma_wait nor writes them after a
// product is issued
template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the A registers (T pairs) of k slice k from accumulator-layout values x
template <typename T = __nv_bfloat16, int R>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[R], int k) {
#pragma unroll
  for (int r = 0; r < 4; ++r) a[r] = pack_pair<T>(x[8 * k + 2 * r], x[8 * k + 2 * r + 1]);
}

// the A registers of k slice k of x in two T parts, hi + lo = x to about
// twice T's significant bits (16 for bf16, 22 for fp16, whose lo part of a
// value under 2^-3 loses bits below fp16's smallest normal, 2^-14): hi
// rounds x, lo rounds what hi left out
template <typename T = __nv_bfloat16, int R>
__device__ __forceinline__ void pack_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&x)[R], int k) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = x[8 * k + 2 * r], x1 = x[8 * k + 2 * r + 1];
    typename Elem<T>::T2 h = Elem<T>::pack2(x0, x1);
    typename Elem<T>::T2 l = Elem<T>::pack2(x0 - __low2float(h), x1 - __high2float(h));
    hi[r] = *reinterpret_cast<uint32_t*>(&h);
    lo[r] = *reinterpret_cast<uint32_t*>(&l);
  }
}

// 2^x on the special-function unit (flushes results below 2^-126 to 0;
// 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max and sum over the four threads of a quad (the threads that share a row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The wgmma instructions, one macro each over the element type string TY
// ("bf16" or "f16"): PTX names the type in the mnemonic.
#define SM90_WGMMA_SS(TY) \
asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]) \
  : "l"(desc_a), "l"(desc_b), "r"(accumulate))

#define SM90_WGMMA_SS_SET(TY) \
asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, " \
  "%32, %33, p, 1, 1, 0, 0;\n}\n" \
  : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), \
  "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), \
  "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), \
  "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), \
  "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), \
  "=f"(d[30]), "=f"(d[31]) \
  : "l"(desc_a), "l"(desc_b), "r"(0))

#define SM90_WGMMA_RS64(TY) \
asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31" \
  "}, " \
  "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

#define SM90_WGMMA_RS128(TY) \
asm volatile( \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
  "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63" \
  "}, " \
  "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
  : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
  "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
  "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
  "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
  "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), \
  "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
  : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B K-major in shared memory
// (descriptors), accumulate = 0 overwrites d
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int accumulate) {
  if constexpr (kIsHalf<T>) {
    SM90_WGMMA_SS("f16");
  } else {
    SM90_WGMMA_SS("bf16");
  }
}

// d[64 x 64] = A[64 x 16] . B[16 x 64], the first k slice of a product:
// d's earlier values are neither read nor kept alive
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_ss_set(float (&d)[32], uint64_t desc_a,
                                                       uint64_t desc_b) {
  if constexpr (kIsHalf<T>) {
    SM90_WGMMA_SS_SET("f16");
  } else {
    SM90_WGMMA_SS_SET("bf16");
  }
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]: A in registers (four T pairs a
// thread, see pack_a), B MN-major in shared memory (the transpose bit)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  if constexpr (kIsHalf<T>) {
    SM90_WGMMA_RS64("f16");
  } else {
    SM90_WGMMA_RS64("bf16");
  }
}

// d[64 x 128] += A[64 x 16] . B[16 x 128]: A in registers (four T pairs a
// thread, see pack_a), B MN-major in shared memory (the transpose bit)
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  if constexpr (kIsHalf<T>) {
    SM90_WGMMA_RS128("f16");
  } else {
    SM90_WGMMA_RS128("bf16");
  }
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  wgmma_m64n64k16_rs<T>(d, a, b);
}

template <typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  wgmma_m64n128k16_rs<T>(d, a, b);
}

// -------------------------------------------------------------------- host

// status returned when a tensor map cannot be encoded (not a cudaError_t)
constexpr int kErrTensorMap = 9001;

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A tensor map over the 16-bit [B, S, H, D] tensor at base (elements of
// type dtype, bf16 by default), strides in
// elements (the last dim contiguous): dims (D, H, S, B), boxes of 64
// columns x 1 head x box_rows rows x 1 batch, 128-byte swizzle. Reads past
// S (and past D when D < 64) are filled with zeros. The wrapper guarantees
// what TMA needs: base 16-byte aligned, every stride a multiple of 16 bytes.
inline bool encode_bshd(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                        long long sb, long long ss, long long sh, int box_rows,
                        CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
