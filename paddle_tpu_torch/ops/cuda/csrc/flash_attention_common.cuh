// Shared by the flash-attention kernels K1-K3 and the FlashMask kernels:
// tile sizes, type conversions, row reductions over 16 lanes, and the
// dropout hash.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paddle_fa {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
  // the xor butterfly leaves the same bits in all 16 lanes (a + b == b + a)
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// Dropout: the hash of paddle_tpu/ops/pallas/flash_attention.py::_dropout_mask,
// bit for bit. The key mixes (seed, b, h, iq, ik), where iq and ik are the
// PALLAS tile ids (block_q, block_k from _blocks, passed in), not this
// kernel's 64 x 64 tiles; the element hash mixes the row and column inside
// the Pallas tile, then runs the murmur3 finalizer. All arithmetic wraps in
// uint32 as the Pallas uint32 vector ops do. An element is kept iff the hash
// is <= thresh = uint32((1 - p) * 0xFFFFFFFF), computed on the host in
// doubles.
__device__ __forceinline__ uint32_t mix(uint32_t key, uint32_t part, uint32_t mult) {
  return (key ^ (part * mult)) * 0x01000193u;
}

// key after the (seed, b, h) steps
__device__ __forceinline__ uint32_t head_key(uint32_t seed, int b, int h) {
  return mix(mix(seed, static_cast<uint32_t>(b), 0x9E3779B9u), static_cast<uint32_t>(h),
             0x85EBCA6Bu);
}

// key after the iq step, for one global row
__device__ __forceinline__ uint32_t row_key(uint32_t head, int iq) {
  return mix(head, static_cast<uint32_t>(iq), 0xC2B2AE35u);
}

// keep bit of the element at row r and column c inside the Pallas tile
// (iq, ik), given the row's key
__device__ __forceinline__ bool keep_bit(uint32_t rkey, int ik, int r, int c, uint32_t thresh) {
  const uint32_t key = mix(rkey, static_cast<uint32_t>(ik), 0x27D4EB2Fu);
  uint32_t x = (static_cast<uint32_t>(r) * 0x9E3779B9u) ^
               (static_cast<uint32_t>(c) * 0x85EBCA6Bu) ^ key;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x <= thresh;
}

// What a kernel needs to replay the mask.
struct DropoutArgs {
  const int* seed;    // (1,) int32 on the device
  int on;             // dropout > 0
  float keep_prob;    // 1 - p, rounded to f32 once on the host
  uint32_t thresh;
  int block_q;        // Pallas tiles
  int block_k;
};

}  // namespace paddle_fa
