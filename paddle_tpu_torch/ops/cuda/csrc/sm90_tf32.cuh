// Hopper (sm_90a) building blocks for float32 attention on the tensor cores
// in 3xTF32, shared by flash_attention_fwd_tf32.cu (K1) and
// flash_attention_dq_tf32.cu (K2), on top of sm90_common.cuh:
//   - the split of a float into two TF32 parts, hi = tf32(x) rounded to
//     nearest (ties away from zero) and lo = tf32(x - hi); every product a.b
//     runs as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi in f32 accumulators, which
//     keeps f32's accuracy to about 2^-21 of |a||b|; a single TF32 product
//     keeps about 2^-11;
//   - the m64nNk8 .tf32 wgmma products with f32 accumulators, A and B from
//     shared memory (SS) or A from registers (RS);
//   - the A registers of a k slice of an accumulator (pack_a_tf32) and the
//     order of keys in a transposed tile that makes them line up;
//   - the byte offset of an element in a 128-byte-swizzled tile, and the
//     passes that round a tile in place beside its lo tile and write a
//     tile transposed;
//   - a float32 encode_bshd (TMA tensor map).
//
// TF32 operands are K-major only. wgmma's transpose bit exists for 16-bit
// types alone, and TMA does not transpose, so a B operand whose reduction
// dim is the tile's row dim (V in P.V, K in dS.K) is written transposed
// into shared memory by threads. wgmma reads B only from shared memory, so
// a B operand's lo part is a tile of its own, formed after the TMA arrival.
// Those tiles are written by the generic proxy and read by wgmma through
// the async proxy: fence_proxy_async, then a barrier, separates the two.
//
// Tile layout. A float32 tile of `rows` rows is stored as boxes of 32
// columns (128 bytes, one swizzle row) x rows, one box after the other;
// within a box, 16-byte chunk c of row r sits at chunk c ^ (r % 8), the
// 128-byte swizzle TMA writes and wgmma's SW128 layout reads. A k8 slice is
// 32 bytes of a row, so a K-major operand steps 32 bytes per k slice
// inside a box, as the bf16 products step per k16 slice.
//
// Key order of a transposed tile. The A fragment of an m64nNk8 tf32 product
// holds (row l/4 + 8h, column l%4 + 4e) in register 2e + h (thread l of a
// warp); the accumulator of a score tile holds (row l/4 + 8h, key
// 8i + 2(l%4) + e) in d[4i + 2h + e]. So a transposed tile stores key
// 8g + 2c + e of each 8-key group at position 8g + c + 4e: then k slice i's
// A registers are d[4i], d[4i + 2], d[4i + 1], d[4i + 3] as they stand, and
// the sum over keys is the same sum in another order.
#pragma once

#include "sm90_common.cuh"

namespace sm90 {

// ------------------------------------------------------------------ device

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from
// zero; the 13 low bits of the result are 0
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// orders this thread's earlier generic-proxy shared-memory accesses before
// later async-proxy ones (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of element (row, col) of a tile of `rows` rows
__device__ __forceinline__ uint32_t tile_offset(int row, int col, int rows) {
  return static_cast<uint32_t>((col >> 5) * rows * 128 + row * 128 +
                               ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2));
}

// hi = tf32(x) in place and lo = tf32(x - hi) at the same offset of lo_buf,
// over the first `bytes` bytes of buf (a multiple of 16), by `threads`
// threads (tid one of them); the layout does not matter
__device__ __forceinline__ void split_in_place(uint8_t* buf, uint8_t* lo_buf, int bytes, int tid,
                                               int threads) {
  for (int off = 16 * tid; off < bytes; off += 16 * threads) {
    float4 x = *reinterpret_cast<float4*>(buf + off);
    float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
    *reinterpret_cast<float4*>(buf + off) = hi;
    *reinterpret_cast<float4*>(lo_buf + off) =
        make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y), tf32_rna(x.z - hi.z),
                    tf32_rna(x.w - hi.w));
  }
}

// hi and lo of x[0..1] into the tiles at hi_buf + off and lo_buf + off
__device__ __forceinline__ void store_split2(uint8_t* hi_buf, uint8_t* lo_buf, uint32_t off,
                                             float2 x) {
  const float2 hi = make_float2(tf32_rna(x.x), tf32_rna(x.y));
  *reinterpret_cast<float2*>(hi_buf + off) = hi;
  *reinterpret_cast<float2*>(lo_buf + off) =
      make_float2(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y));
}

// Writes a block of 8 rows (keys 8g..8g + 7 of a K or V tile) x columns n0,
// n0 + 1 (x[r] = the pair of row 8g + r) transposed, in hi and lo parts:
// column n0 + w becomes row n0 + w of the transposed tiles, each of `rows`
// rows, its keys in the order of the note above
__device__ __forceinline__ void store_transposed(uint8_t* hi_buf, uint8_t* lo_buf, int g, int n0,
                                                 const float2 (&x)[8], int rows) {
#pragma unroll
  for (int w = 0; w < 2; ++w)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a0 = w ? x[e].y : x[e].x, a1 = w ? x[2 + e].y : x[2 + e].x;
      const float a2 = w ? x[4 + e].y : x[4 + e].x, a3 = w ? x[6 + e].y : x[6 + e].x;
      const float4 hi = make_float4(tf32_rna(a0), tf32_rna(a1), tf32_rna(a2), tf32_rna(a3));
      const uint32_t off = tile_offset(n0 + w, 8 * g + 4 * e, rows);
      *reinterpret_cast<float4*>(hi_buf + off) = hi;
      *reinterpret_cast<float4*>(lo_buf + off) = make_float4(
          tf32_rna(a0 - hi.x), tf32_rna(a1 - hi.y), tf32_rna(a2 - hi.z), tf32_rna(a3 - hi.w));
    }
}

// the A registers of k slice i of accumulator-layout values x, in hi and
// lo parts (keys in the order of a transposed tile, see the note above)
template <int R>
__device__ __forceinline__ void pack_a_tf32(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                            const float (&x)[R], int i) {
  const float v[4] = {x[4 * i], x[4 * i + 2], x[4 * i + 1], x[4 * i + 3]};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float h = tf32_rna(v[r]);
    hi[r] = __float_as_uint(h);
    lo[r] = __float_as_uint(tf32_rna(v[r] - h));
  }
}

#define SM90_TF32_D16                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define SM90_TF32_D32                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define SM90_TF32_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                      \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "             \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "             \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define SM90_OUT16(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),            \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),    \
      "+f"(d[14]), "+f"(d[15])
#define SM90_OUT32(d)                                                                            \
  SM90_OUT16(d), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),   \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),              \
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define SM90_OUT64(d)                                                                            \
  SM90_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),   \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),              \
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),              \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),              \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),              \
      "+f"(d[62]), "+f"(d[63])

// d[64 x 32] (+)= A[64 x 8] . B[8 x 32], tf32, A and B K-major in shared
// memory (descriptors); accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " SM90_TF32_D16
      ", %16, %17, p, 1, 1;\n}\n"
      : SM90_OUT16(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 8] . B[8 x 64], as above
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_TF32_D32
      ", %32, %33, p, 1, 1;\n}\n"
      : SM90_OUT32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 8] . B[8 x 64], tf32: A in registers (four tf32 a
// thread, see pack_a_tf32), B K-major in shared memory
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " SM90_TF32_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SM90_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64 x 128] += A[64 x 8] . B[8 x 128], as above
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SM90_TF32_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SM90_OUT64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SM90_TF32_D16
#undef SM90_TF32_D32
#undef SM90_TF32_D64
#undef SM90_OUT16
#undef SM90_OUT32
#undef SM90_OUT64

// -------------------------------------------------------------------- host

// A tensor map over the float32 [B, S, H, D] tensor at base, strides in
// elements (the last dim contiguous): dims (D, H, S, B), boxes of 32
// columns (128 bytes) x 1 head x box_rows rows x 1 batch, 128-byte swizzle.
// Reads past S (and past D when D < 32) are filled with zeros. The wrapper
// guarantees what TMA needs: base 16-byte aligned, every stride a multiple
// of 4 floats.
inline bool encode_bshd_f32(CUtensorMap* map, const void* base, int B, int S, int H, int D,
                            long long sb, long long ss, long long sh, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 4, static_cast<cuuint64_t>(ss) * 4,
                                 static_cast<cuuint64_t>(sb) * 4};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
