// RMSNorm for Hopper (sm_90a), forward and backward, over the last dim of a
// [rows, d] tensor, computed in f32.
//
// Forward (K4), paddle_rms_norm_fwd: y = x * rsqrt(mean(x^2) + eps) * w,
// stored in x's dtype. Replaces paddle_tpu/ops/pallas/rms_norm.py::_rms_kernel
// (launched by _rms_norm_fwd). It computes the same function, not the same
// blocks: the Pallas kernel's row blocking does not change a row's result.
//   - x and w are upcast to f32; the sum of squares is an f32 sum over the
//     row, divided by d; y = x * rsqrt(ms + eps), then y * w, rounded once to
//     x's dtype (f32, bf16 or fp16, round to nearest even);
//   - x's rows may be strided (ldx elements apart); the last dim must be
//     contiguous. w is [d] contiguous, in f32, bf16 or fp16 independently of x.
//     out is [rows, d] contiguous.
//
// Backward, paddle_rms_norm_bwd: the port's counterpart of the jnp _bwd of
// paddle_tpu/ops/pallas/rms_norm.py (no Pallas kernel there; XLA fuses it).
// From x, w, g [rows, d] (g in x's dtype, rows strided ldg apart) and eps:
//   inv = rsqrt(mean(x^2) + eps), xn = x * inv, gw = g * w,
//   dx = inv * (gw - xn * mean(gw * xn))   rounded once to x's dtype,
//   dw = sum over rows of g * xn           rounded once to w's dtype.
// mean(gw * xn) is taken as inv * sum(gw * x) / d, so one pass of row sums
// (sum x^2 and sum gw * x together) serves both.
//
// Design. Both are bound by bytes (about 4 and 11 f32 operations an element,
// far below the ~20 operations per byte at which the CUDA cores would bind),
// so each element of x (and g) is read from HBM once and each output written
// once:
//   - one pass: a row's share is loaded whole into registers, every 16-byte
//     load issued before any arithmetic, then reduced, then written from the
//     same registers. The count of 16-byte vectors a thread holds, NV, is a
//     template parameter chosen from d (1, 2, 3, 4, 6 or 8, the tail masked),
//     within a budget of values a thread (32 forward, holding x and w; 24
//     backward, holding x, g, w and the dw partials). A warp takes a row
//     while the row fits 32 lanes' budget (d <= 1024 forward, <= 768
//     backward: Llama's 768 in both), else a 256-thread block does (d = 4096:
//     16 f32 values a thread forward); beyond the block's budget, or when the
//     row is not 16-byte aligned (an odd d), the same kernel's general
//     instantiation (NV = 0) loops over the row twice, the second pass from
//     L1/L2. Each thread addresses its vectors from one base pointer a row,
//     at offsets known at compile time;
//   - w is read as 16-byte vectors once a thread and held in registers
//     across the rows a warp (or block) walks: the grid is at most 8 blocks
//     an SM forward (all the warps an SM holds, so up to 8448 rows a warp
//     takes one row) and 2 blocks an SM backward, the rows dealt out evenly,
//     row r to warp r mod (the grid's warps);
//   - the backward's weight gradient has no atomics, so it is the same bits
//     on every run and in a CUDA graph: each lane sums g * xn for its columns
//     over its warp's rows in row order; the 8 warps of a block add theirs in
//     shared memory in a fixed tree (w0+w4, w1+w5, ..., then w0+w2, w1+w3,
//     then w0+w1) and write one f32 row of partials a block; a second launch
//     (rms_norm_dw_kernel, 32 columns x 32 warps a block) sums the rows of
//     partials over blocks in a fixed order (warp j takes blocks j, j+32, ...
//     in order, then the 32 warp sums in order) and rounds to w's dtype. Two
//     launches a call, always. The grid depends only on (rows, d, the card).
//
// Bounds on an H100 SXM (3.35 TB/s HBM) at Llama's training shape, rows =
// 4 x 2048 = 8192, d = 768: forward, x read and y written once, 25.2 MB bf16
// (7.5 us) and 50.3 MB f32 (15.0 us); backward, x and g read and dx written
// once, 37.7 MB bf16 (11.3 us) and 75.5 MB f32 (22.5 us); the partials are
// 256 x 768 f32 (0.8 MB), read once more by the second launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// values a thread holds in registers: forward x and w; backward x, g, w and
// the dw partials. Past these the row takes a block, then the general path
constexpr int kFwdValues = 32;
constexpr int kBwdValues = 24;
// blocks an SM holds: the forward's grid is at most the card's full
// occupancy (64 warps an SM), the backward's is 2 blocks an SM, and the
// caller sizes the partials from it. Both are launch bounds too: given an
// occupancy to meet, ptxas keeps every value in registers rather than
// spilling a few to reach a higher one of its own choosing
constexpr int kFwdBlocksPerSm = 8;
constexpr int kFwdMinBlocksPerSm = 2;
constexpr int kBwdBlocksPerSm = 2;
// the second backward launch: 32 columns, 32 warps over the blocks' partials
constexpr int kDwWarps = 32;
// a row's width, so that its vector counts and offsets fit an int
constexpr long long kMaxD = 1LL << 30;

struct FwdParams {
  const void* x;
  const void* w;
  void* out;
  long long rows;
  long long d;
  long long ldx;
  float eps;
};

struct BwdParams {
  const void* x;
  const void* w;
  const void* g;
  void* dx;
  float* partial;  // [gridDim.x, d] f32
  long long rows;
  long long d;
  long long ldx;
  long long ldg;
  float eps;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// N elements of T as one load or store: 16 bytes (two for 8 f32), or one
// element
template <typename T, int N>
struct alignas(sizeof(T) * N < 16 ? sizeof(T) * N : 16) Vec {
  T v[N];
};

template <int N, typename T>
__device__ __forceinline__ void load(const T* p, float (&f)[N]) {
  const Vec<T, N> v = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_float(v.v[i]);
}

template <int N, typename T>
__device__ __forceinline__ void store(T* p, const float (&f)[N]) {
  Vec<T, N> v;
#pragma unroll
  for (int i = 0; i < N; ++i) v.v[i] = from_float<T>(f[i]);
  *reinterpret_cast<Vec<T, N>*>(p) = v;
}

// a vector's elements as f32, and a vector of zeros (a masked lane's)
template <typename T, int N>
__device__ __forceinline__ float at(const Vec<T, N>& v, int i) {
  return to_float(v.v[i]);
}

template <typename T, int N>
__device__ __forceinline__ void zero(Vec<T, N>& v) {
#pragma unroll
  for (int i = 0; i < N; ++i) v.v[i] = from_float<T>(0.f);
}

// A thread's NV vectors of a row (or of w): p points at its first, the
// others lie TPR vectors apart (offsets known at compile time); `live`
// counts the row's vectors from the first on, and those past it are zeros.
template <int TPR, int NV, typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, int live, Vec<T, VEC> (&v)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (i * TPR < live) {
      v[i] = *reinterpret_cast<const Vec<T, VEC>*>(p + i * TPR * VEC);
    } else {
      zero(v[i]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// the sum over a row's TPR threads of each thread's v (every thread gets
// it); with a block a row, the warps' sums meet in part[it & 1] (two
// buffers, so one barrier a row) and every thread adds them in order
template <int TPR, int K>
__device__ __forceinline__ void row_sum(float (&v)[K], float (*part)[kWarps][K], long long it) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if constexpr (TPR > 32) {
    float(*buf)[K] = part[it & 1];
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) buf[threadIdx.x / 32][k] = v[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) v[k] += buf[i][k];
    }
  }
}

// Forward. TPR threads a row (32 or kThreads); NV vectors of VEC elements a
// thread held in registers, or NV = 0 for the general two-pass loop.
template <typename TX, typename TW, int VEC, int TPR, int NV>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocksPerSm) rms_norm_kernel(const FwdParams p) {
  constexpr int kRows = kThreads / TPR;  // rows a block takes at once
  __shared__ float part[2][kWarps][1];
  const int t = threadIdx.x % TPR;
  const long long first = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x / TPR;
  const long long stride = static_cast<long long>(gridDim.x) * kRows;
  const long long nvec = p.d / VEC;
  const float d = static_cast<float>(p.d);
  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  const TW* __restrict__ w = static_cast<const TW*>(p.w);
  TX* __restrict__ out = static_cast<TX*>(p.out);

  if constexpr (NV > 0) {
    // x and w stay in their own types in registers (8 bf16 in 4 registers)
    const int live = static_cast<int>(nvec) - t;
    Vec<TW, VEC> wv[NV];
    Vec<TX, VEC> xv[NV];
    load_row<TPR>(w + t * VEC, live, wv);
    if (first < p.rows) load_row<TPR>(x + first * p.ldx + t * VEC, live, xv);
    long long it = 0;
#pragma unroll 1
    for (long long row = first; row < p.rows; row += stride, ++it) {
      float ss[1] = {0.f};
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss[0] = fmaf(at(xv[i], j), at(xv[i], j), ss[0]);
      }
      row_sum<TPR>(ss, part, it);
      const float inv = rsqrtf(ss[0] / d + p.eps);
      TX* yr = out + row * p.d + t * VEC;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i * TPR < live) {
          float y[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) y[j] = at(xv[i], j) * inv * at(wv[i], j);
          store<VEC>(yr + i * TPR * VEC, y);
        }
      }
      if (row + stride < p.rows) load_row<TPR>(x + (row + stride) * p.ldx + t * VEC, live, xv);
    }
  } else {
    long long it = 0;
#pragma unroll 1
    for (long long row = first; row < p.rows; row += stride, ++it) {
      const TX* xr = x + row * p.ldx;
      float ss[1] = {0.f};
      for (long long c = t; c < nvec; c += TPR) {
        float xv[VEC];
        load<VEC>(xr + c * VEC, xv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) ss[0] = fmaf(xv[j], xv[j], ss[0]);
      }
      row_sum<TPR>(ss, part, it);
      const float inv = rsqrtf(ss[0] / d + p.eps);
      TX* yr = out + row * p.d;
      for (long long c = t; c < nvec; c += TPR) {
        float xv[VEC], wv[VEC], y[VEC];
        load<VEC>(xr + c * VEC, xv);
        load<VEC>(w + c * VEC, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) y[j] = xv[j] * inv * wv[j];
        store<VEC>(yr + c * VEC, y);
      }
    }
  }
}

// Backward, first launch: dx, and one row of dw partials a block. TPR, NV,
// VEC as in the forward.
template <typename TX, typename TW, int VEC, int TPR, int NV>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm) rms_norm_bwd_kernel(const BwdParams p) {
  constexpr int kRows = kThreads / TPR;
  __shared__ float part[2][kWarps][2];
  const int t = threadIdx.x % TPR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long first = static_cast<long long>(blockIdx.x) * kRows + threadIdx.x / TPR;
  const long long stride = static_cast<long long>(gridDim.x) * kRows;
  const long long nvec = p.d / VEC;
  const float d = static_cast<float>(p.d);
  const TX* __restrict__ x = static_cast<const TX*>(p.x);
  const TX* __restrict__ g = static_cast<const TX*>(p.g);
  const TW* __restrict__ w = static_cast<const TW*>(p.w);
  TX* __restrict__ dx = static_cast<TX*>(p.dx);
  float* __restrict__ partial = p.partial + static_cast<long long>(blockIdx.x) * p.d;

  if constexpr (NV > 0) {
    const int live = static_cast<int>(nvec) - t;
    Vec<TW, VEC> wv[NV];
    float acc[NV][VEC];
    load_row<TPR>(w + t * VEC, live, wv);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
    }
    long long it = 0;
#pragma unroll 1
    for (long long row = first; row < p.rows; row += stride, ++it) {
      Vec<TX, VEC> xv[NV], gv[NV];
      load_row<TPR>(x + row * p.ldx + t * VEC, live, xv);
      load_row<TPR>(g + row * p.ldg + t * VEC, live, gv);
      float s[2] = {0.f, 0.f};  // sum x^2, sum g * w * x
#pragma unroll
      for (int i = 0; i < NV; ++i) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[0] = fmaf(at(xv[i], j), at(xv[i], j), s[0]);
          s[1] = fmaf(at(gv[i], j) * at(wv[i], j), at(xv[i], j), s[1]);
        }
      }
      row_sum<TPR>(s, part, it);
      const float inv = rsqrtf(s[0] / d + p.eps);
      const float m = inv * s[1] / d;  // mean(gw * xn)
      TX* dxr = dx + row * p.d + t * VEC;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i * TPR < live) {
          float o[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float xn = at(xv[i], j) * inv;
            acc[i][j] = fmaf(at(gv[i], j), xn, acc[i][j]);
            o[j] = inv * (at(gv[i], j) * at(wv[i], j) - xn * m);
          }
          store<VEC>(dxr + i * TPR * VEC, o);
        }
      }
    }
    if constexpr (TPR == 32) {
      // the 8 warps' partials meet in a fixed tree; warp 0 writes the sum
      __shared__ float red[kWarps / 2][NV * VEC][32];
#pragma unroll
      for (int half = kWarps / 2; half > 0; half /= 2) {
        if (warp >= half && warp < 2 * half) {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) red[warp - half][i * VEC + j][lane] = acc[i][j];
          }
        }
        __syncthreads();
        if (warp < half) {
#pragma unroll
          for (int i = 0; i < NV; ++i) {
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[i][j] += red[warp][i * VEC + j][lane];
          }
        }
        __syncthreads();
      }
      if (warp != 0) return;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i * TPR < live) store<VEC>(partial + (t + i * TPR) * VEC, acc[i]);
    }
  } else {
    // the general path: a block a row (TPR == kThreads), each thread adding
    // into its own columns of the block's partials row by row
    long long it = 0;
#pragma unroll 1
    for (long long row = first; row < p.rows; row += stride, ++it) {
      const TX* xr = x + row * p.ldx;
      const TX* gr = g + row * p.ldg;
      float s[2] = {0.f, 0.f};
      for (long long c = t; c < nvec; c += TPR) {
        float xv[VEC], gv[VEC], wv[VEC];
        load<VEC>(xr + c * VEC, xv);
        load<VEC>(gr + c * VEC, gv);
        load<VEC>(w + c * VEC, wv);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s[0] = fmaf(xv[j], xv[j], s[0]);
          s[1] = fmaf(gv[j] * wv[j], xv[j], s[1]);
        }
      }
      row_sum<TPR>(s, part, it);
      const float inv = rsqrtf(s[0] / d + p.eps);
      const float m = inv * s[1] / d;
      TX* dxr = dx + row * p.d;
      for (long long c = t; c < nvec; c += TPR) {
        float xv[VEC], gv[VEC], wv[VEC], o[VEC], a[VEC];
        load<VEC>(xr + c * VEC, xv);
        load<VEC>(gr + c * VEC, gv);
        load<VEC>(w + c * VEC, wv);
        if (it == 0) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) a[j] = 0.f;
        } else {
          load<VEC>(partial + c * VEC, a);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float xn = xv[j] * inv;
          a[j] = fmaf(gv[j], xn, a[j]);
          o[j] = inv * (gv[j] * wv[j] - xn * m);
        }
        store<VEC>(dxr + c * VEC, o);
        store<VEC>(partial + c * VEC, a);
      }
    }
  }
}

// Backward, second launch: dw[c] = the blocks' partials summed in a fixed
// order, rounded to w's dtype. 32 columns a block, one a lane.
template <typename TW>
__global__ void __launch_bounds__(32 * kDwWarps) rms_norm_dw_kernel(const float* __restrict__ partial,
                                                                    TW* __restrict__ dw, int blocks,
                                                                    long long d) {
  __shared__ float red[kDwWarps][33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long c = static_cast<long long>(blockIdx.x) * 32 + lane;
  float s = 0.f;
  if (c < d) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kDwWarps) s += partial[b * d + c];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < kDwWarps; ++i) total += red[i][lane];
    dw[c] = from_float<TW>(total);
  }
}

// ---- launch ----

int sm_count() {
  int dev = 0, n = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// at most `cap` blocks for `groups` row groups, the groups dealt out evenly
long long balanced_grid(long long groups, long long cap) {
  if (groups <= cap) return groups;
  const long long per = (groups + cap - 1) / cap;
  return (groups + per - 1) / per;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the NV of {1, 2, 3, 4, 6, 8} at or above n and within max_nv, else 0
int pick_nv(long long n, int max_nv) {
  for (int nv : {1, 2, 3, 4, 6, 8}) {
    if (nv >= n && nv <= max_nv) return nv;
  }
  return 0;
}

template <int N>
using Int = std::integral_constant<int, N>;

// f(Int<NV>) for the NV picked, instantiating only NVs up to MAX (0: the
// general path)
template <int MAX, typename F>
cudaError_t with_nv(int nv, F&& f) {
  switch (nv) {
    case 1: if constexpr (MAX >= 1) return f(Int<1>{}); break;
    case 2: if constexpr (MAX >= 2) return f(Int<2>{}); break;
    case 3: if constexpr (MAX >= 3) return f(Int<3>{}); break;
    case 4: if constexpr (MAX >= 4) return f(Int<4>{}); break;
    case 6: if constexpr (MAX >= 6) return f(Int<6>{}); break;
    case 8: if constexpr (MAX >= 8) return f(Int<8>{}); break;
    default: break;
  }
  return f(Int<0>{});
}

// launch(Int<VEC>, Int<TPR>, Int<NV>) for the shape of a call: rows that are
// not 16-byte aligned take the general path an element at a time; aligned
// ones 16-byte vectors, a warp a row while NV fits VALUES a thread, else a
// block a row, else the general path
template <typename TX, int VALUES, typename L>
cudaError_t dispatch(long long d, bool aligned, L&& launch) {
  constexpr int kVec = 16 / sizeof(TX);
  constexpr int kMax = VALUES / kVec;
  if (!aligned) return launch(Int<1>{}, Int<kThreads>{}, Int<0>{});
  const long long nvec = d / kVec;
  const int warp_nv = pick_nv((nvec + 31) / 32, kMax);
  if (warp_nv > 0) {
    return with_nv<kMax>(warp_nv, [&](auto nv) {
      if constexpr (decltype(nv)::value > 0) {
        return launch(Int<kVec>{}, Int<32>{}, nv);
      } else {
        return cudaErrorInvalidValue;  // not reached: warp_nv > 0
      }
    });
  }
  return with_nv<kMax>(pick_nv((nvec + kThreads - 1) / kThreads, kMax),
                       [&](auto nv) { return launch(Int<kVec>{}, Int<kThreads>{}, nv); });
}

template <typename TX, typename TW, int VEC, int TPR, int NV>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t s) {
  constexpr int kRows = kThreads / TPR;
  const long long groups = (p.rows + kRows - 1) / kRows;
  const long long blocks = balanced_grid(groups, static_cast<long long>(kFwdBlocksPerSm) * sm_count());
  rms_norm_kernel<TX, TW, VEC, TPR, NV><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t fwd_t(const FwdParams& p, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  constexpr int kWVec = kVec * sizeof(TW) < 16 ? kVec * sizeof(TW) : 16;
  const bool aligned = p.d % kVec == 0 && p.ldx % kVec == 0 && aligned16(p.x) &&
                       aligned16(p.out) && reinterpret_cast<uintptr_t>(p.w) % kWVec == 0;
  return dispatch<TX, kFwdValues>(p.d, aligned, [&](auto vec, auto tpr, auto nv) {
    return launch_fwd<TX, TW, decltype(vec)::value, decltype(tpr)::value, decltype(nv)::value>(p, s);
  });
}

template <typename TX, typename TW, int VEC, int TPR, int NV>
cudaError_t launch_bwd(const BwdParams& p, int max_blocks, void* dw, cudaStream_t s) {
  constexpr int kRows = kThreads / TPR;
  const long long groups = (p.rows + kRows - 1) / kRows;
  const long long blocks = balanced_grid(groups, max_blocks);
  rms_norm_bwd_kernel<TX, TW, VEC, TPR, NV><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long col_blocks = (p.d + 31) / 32;
  rms_norm_dw_kernel<TW><<<static_cast<unsigned>(col_blocks), 32 * kDwWarps, 0, s>>>(
      p.partial, static_cast<TW*>(dw), static_cast<int>(blocks), p.d);
  return cudaGetLastError();
}

template <typename TX, typename TW>
cudaError_t bwd_t(const BwdParams& p, int max_blocks, void* dw, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  constexpr int kWVec = kVec * sizeof(TW) < 16 ? kVec * sizeof(TW) : 16;
  const bool aligned = p.d % kVec == 0 && p.ldx % kVec == 0 && p.ldg % kVec == 0 &&
                       aligned16(p.x) && aligned16(p.g) && aligned16(p.dx) &&
                       aligned16(p.partial) && reinterpret_cast<uintptr_t>(p.w) % kWVec == 0;
  return dispatch<TX, kBwdValues>(p.d, aligned, [&](auto vec, auto tpr, auto nv) {
    return launch_bwd<TX, TW, decltype(vec)::value, decltype(tpr)::value, decltype(nv)::value>(
        p, max_blocks, dw, s);
  });
}

// f(TX{}, TW{}) for the element types the dtype codes name
template <typename F>
cudaError_t with_types(int x_dtype, int w_dtype, F&& f) {
  auto with_w = [&](auto x) -> cudaError_t {
    switch (w_dtype) {
      case 0: return f(x, float{});
      case 1: return f(x, __nv_bfloat16{});
      case 2: return f(x, __half{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (x_dtype) {
    case 0: return with_w(float{});
    case 1: return with_w(__nv_bfloat16{});
    case 2: return with_w(__half{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16, for x and w independently.
// Each returns the cudaError_t of its launches.

extern "C" int paddle_rms_norm_fwd(const void* x, const void* w, void* out, int x_dtype,
                                   int w_dtype, long long rows, long long d, long long ldx,
                                   float eps, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || ldx < d) return static_cast<int>(cudaErrorInvalidValue);
  const FwdParams p{x, w, out, rows, d, ldx, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(x_dtype, w_dtype, [&](auto x, auto w) {
    return fwd_t<decltype(x), decltype(w)>(p, s);
  }));
}

// The backward's blocks an SM: the caller's partials hold
// min(rows, this x SMs) rows of d f32.
extern "C" int paddle_rms_norm_bwd_blocks_per_sm() { return kBwdBlocksPerSm; }

// g is in x's dtype. partial: max_blocks rows of d f32 (max_blocks <= rows),
// scratch that the call overwrites. Two launches, on `stream`.
extern "C" int paddle_rms_norm_bwd(const void* x, const void* w, const void* g, void* dx, void* dw,
                                   void* partial, int x_dtype, int w_dtype, long long rows,
                                   long long d, long long ldx, long long ldg, int max_blocks,
                                   float eps, void* stream) {
  if (rows < 1 || d < 1 || d > kMaxD || ldx < d || ldg < d || max_blocks < 1 ||
      max_blocks > rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BwdParams p{x, w, g, dx, static_cast<float*>(partial), rows, d, ldx, ldg, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_types(x_dtype, w_dtype, [&](auto x, auto w) {
    return bwd_t<decltype(x), decltype(w)>(p, max_blocks, dw, s);
  }));
}
