// RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w over
// the last dim of a [rows, d] tensor, computed in f32 and stored in x's dtype.
//
// Replaces paddle_tpu/ops/pallas/rms_norm.py::_rms_kernel (launched by
// _rms_norm_fwd). It computes the same function, not the same blocks: the
// Pallas kernel's row blocking (block_rows dividing rows) does not change a
// row's result, so the tiling here is free.
//   - x and w are upcast to f32; the mean of squares is an f32 sum over the
//     row divided by d; y = x * rsqrt(ms + eps), then y * w; the result is
//     rounded once to x's dtype (f32 or bf16, round to nearest even);
//   - x's rows may be strided (ldx elements apart); the last dim must be
//     contiguous. w is [d] contiguous, in f32 or bf16 independently of x.
//     out is [rows, d] contiguous;
//   - any rows (the last block's rows past the end do nothing) and any d.
//
// Design. d <= 2048: one warp per row, eight rows per 256-thread block.
// d > 2048 (llama2_7b / llama3_8b's 4096): one 256-thread block per row. Each
// thread sums the squares of its chunks in f32, the warp sums by xor shuffles,
// and with a block per row the eight warp sums meet in shared memory, where
// every thread adds them in the same order. A second pass reads x again (from
// L1/L2: one row is at most a few KB) and writes y. Loads and stores of x and
// y are 16 bytes a thread (4 f32 or 8 bf16) when d, the row stride and both
// base pointers allow it; otherwise one element a thread (an odd d). w is read
// one element at a time through the read-only cache.
//
// Bound on an H100 SXM (3.35 TB/s HBM): the work is ~4 operations per element,
// far below the ~295 operations per byte at which compute would bind, so it is
// bound by bytes: at the Llama training shape rows = 4 x 2048 = 8192, d = 768,
// bf16, x read once and y written once move 25.2 MB, about 7.5 us. The two
// passes over x cost a second read that L1/L2 mostly absorb; a one-pass
// version holding the row in registers is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* x;
  const void* w;
  void* out;
  long long rows;
  long long d;
  long long ldx;
  float eps;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T as one aligned load or store (16 bytes, or one element)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename TX, typename TW, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads) rms_norm_kernel(const Params p) {
  constexpr int kRows = kThreads / TPR;  // rows per block
  const int tid = threadIdx.x;
  const int t = tid % TPR;               // thread within the row
  const long long row = static_cast<long long>(blockIdx.x) * kRows + tid / TPR;
  const bool active = row < p.rows;      // uniform over a row's threads
  const long long nvec = p.d / VEC;
  const Vec<TX, VEC>* xr =
      reinterpret_cast<const Vec<TX, VEC>*>(static_cast<const TX*>(p.x) + row * p.ldx);

  float ss = 0.f;
  if (active) {
    for (long long c = t; c < nvec; c += TPR) {
      const Vec<TX, VEC> xv = xr[c];
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float f = to_float(xv.v[i]);
        ss = fmaf(f, f, ss);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if constexpr (TPR > 32) {
    __shared__ float part[TPR / 32];
    if ((tid & 31) == 0) part[tid / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < TPR / 32; ++i) ss += part[i];
  }
  if (!active) return;

  const float inv = rsqrtf(ss / static_cast<float>(p.d) + p.eps);
  const TW* w = static_cast<const TW*>(p.w);
  Vec<TX, VEC>* yr = reinterpret_cast<Vec<TX, VEC>*>(static_cast<TX*>(p.out) + row * p.d);
  for (long long c = t; c < nvec; c += TPR) {
    const Vec<TX, VEC> xv = xr[c];
    Vec<TX, VEC> yv;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = to_float(xv.v[i]) * inv;
      yv.v[i] = from_float<TX>(y * to_float(__ldg(w + c * VEC + i)));
    }
    yr[c] = yv;
  }
}

template <typename TX, typename TW, int VEC>
cudaError_t launch_vec(const Params& p, cudaStream_t s) {
  if (p.d <= 2048) {
    const long long blocks = (p.rows + kThreads / 32 - 1) / (kThreads / 32);
    rms_norm_kernel<TX, TW, VEC, 32><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  } else {
    rms_norm_kernel<TX, TW, VEC, kThreads><<<static_cast<unsigned>(p.rows), kThreads, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t launch_t(const Params& p, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  const bool aligned = p.d % kVec == 0 && p.ldx % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(p.x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(p.out) % 16 == 0;
  return aligned ? launch_vec<TX, TW, kVec>(p, s) : launch_vec<TX, TW, 1>(p, s);
}

template <typename TX>
cudaError_t launch_w(const Params& p, int w_dtype, cudaStream_t s) {
  return w_dtype == 0   ? launch_t<TX, float>(p, s)
         : w_dtype == 1 ? launch_t<TX, __nv_bfloat16>(p, s)
                        : cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16. Returns the cudaError_t of the launch.
extern "C" int paddle_rms_norm_fwd(const void* x, const void* w, void* out, int x_dtype,
                                   int w_dtype, long long rows, long long d, long long ldx,
                                   float eps, void* stream) {
  // the grid's x dimension holds at most 2^31 - 1 blocks
  if (rows < 1 || d < 1 || ldx < d || rows > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.rows = rows;
  p.d = d;
  p.ldx = ldx;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = x_dtype == 0   ? launch_w<float>(p, w_dtype, s)
                    : x_dtype == 1 ? launch_w<__nv_bfloat16>(p, w_dtype, s)
                                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
