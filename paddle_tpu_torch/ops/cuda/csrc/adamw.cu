// Multi-tensor Adam/AdamW update for Hopper (sm_90a): one pass over many
// parameters in one launch, each element updated exactly as the plain
// per-tensor chain of paddle_tpu_torch/ops/cuda/adamw.py computes it.
//
// No Pallas counterpart. The JAX package writes Adam and AdamW
// (paddle_tpu/optimizer/optimizers.py: Adam._apply_one, AdamW._apply_one)
// in jnp, and its TrainStep compiles the whole update into one XLA program,
// where XLA fuses it. This kernel is that fusion: the plain version runs a
// dozen element-wise kernels per parameter, this one reads each element's
// p, g, m, v once and writes p, m, v once.
//
// What an element computes, bit for bit the plain version's torch ops (each
// op rounds once; the float intrinsics below forbid nvcc from contracting a
// multiply and an add into an FMA, which torch's separate kernels never do):
//   - decoupled decay (AdamW, has_decay): p <- T(p * decay), decay being the
//     device scalar 1 - lr*coeff the wrapper computed with torch ops;
//   - L2 decay (Adam's weight_decay, has_l2): g <- T(g + T(wd * p)), in the
//     parameter's type T, torch's two roundings;
//   - m <- m*b1 + (1-b1)*g; v <- v*b2 + ((1-b2)*g)*g, f32 moments;
//   - p <- T(p - (lr * (m / bc1)) / (sqrt(v / bc2) + eps)), bc1 = 1 - b1^t and
//     bc2 = 1 - b2^t device scalars from the wrapper's torch ops, T(x) rounding
//     to nearest even (float32: exact).
// Host constants (b1, b2, 1-b1, 1-b2, eps, wd) arrive as f32 rounded from the
// Python doubles, as torch rounds a Python scalar for an f32 op.
//
// Launch layout. Pointers and sizes travel in the launch parameters (a
// TensorList of up to kMaxTensors tensors, under the 4 KB parameter limit),
// in the style of apex's multi_tensor_apply: a pointer table in device memory
// would need a host copy every step, which a CUDA graph cannot capture
// cleanly, while launch parameters go into the graph as they stand. Both
// structs are __grid_constant__, so the kernel indexes them in the parameter
// space without a copy to local memory. Tensor i owns blocks
// [block_start[i], block_start[i+1]); a block finds its tensor by a scan of
// block_start and grid-strides over it in vectors of 4 elements (p and g 8
// bytes in bf16, 16 in f32; m and v 16) when all four base pointers allow it,
// one element at a time otherwise, and the last n % 4 elements one at a time.
//
// Bound on an H100 SXM (3.35 TB/s): about 20 operations per element against
// 22 bytes moved in bf16 (p read and written, g read, m and v read and
// written) or 28 in f32, far below the ~295 operations per byte at which
// compute would bind: bytes bind. gpt2_small's 124.4 M bf16 elements move
// 2.74 GB, 0.82 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;

// outside the unnamed namespace: the C entry point takes them, and a type
// of internal linkage would give it internal linkage too
struct TensorList {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  int block_start[kMaxTensors + 1];
  int count;
};

struct Scalars {
  const float* lr;     // device scalars
  const float* bc1;
  const float* bc2;
  const float* decay;  // 1 - lr*coeff, read when has_decay
  float beta1, beta2, one_minus_beta1, one_minus_beta2, eps, weight_decay;
  int has_decay, has_l2;
};

namespace {

struct Consts {
  float lr, bc1, bc2, decay;
  float beta1, beta2, omb1, omb2, eps, wd;
  int has_decay, has_l2;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ void update(T& p, T g, float& m, float& v, const Consts& c) {
  float pf = to_float(p);
  if (c.has_decay) pf = to_float(from_float<T>(__fmul_rn(pf, c.decay)));
  float gf = to_float(g);
  if (c.has_l2) {
    const float wdp = to_float(from_float<T>(__fmul_rn(c.wd, pf)));
    gf = to_float(from_float<T>(__fadd_rn(gf, wdp)));
  }
  m = __fadd_rn(__fmul_rn(m, c.beta1), __fmul_rn(c.omb1, gf));
  v = __fadd_rn(__fmul_rn(v, c.beta2), __fmul_rn(__fmul_rn(c.omb2, gf), gf));
  const float mhat = __fdiv_rn(m, c.bc1);
  const float vhat = __fdiv_rn(v, c.bc2);
  const float denom = __fadd_rn(__fsqrt_rn(vhat), c.eps);
  p = from_float<T>(__fsub_rn(pf, __fdiv_rn(__fmul_rn(c.lr, mhat), denom)));
}

template <typename T>
struct alignas(sizeof(T) * 4) Vec4 {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ TensorList tl,
                                                        const __grid_constant__ Scalars s) {
  const int b = blockIdx.x;
  int t = 0;
  while (t + 1 < tl.count && b >= tl.block_start[t + 1]) ++t;
  const long long n = tl.n[t];
  const long long first = static_cast<long long>(b - tl.block_start[t]) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(tl.block_start[t + 1] - tl.block_start[t]) * kThreads;

  Consts c;
  c.lr = *s.lr;
  c.bc1 = *s.bc1;
  c.bc2 = *s.bc2;
  c.decay = s.has_decay ? *s.decay : 1.f;
  c.beta1 = s.beta1;
  c.beta2 = s.beta2;
  c.omb1 = s.one_minus_beta1;
  c.omb2 = s.one_minus_beta2;
  c.eps = s.eps;
  c.wd = s.weight_decay;
  c.has_decay = s.has_decay;
  c.has_l2 = s.has_l2;

  T* p = static_cast<T*>(tl.p[t]);
  const T* g = static_cast<const T*>(tl.g[t]);
  float* m = tl.m[t];
  float* v = tl.v[t];
  const bool vec = (reinterpret_cast<uintptr_t>(p) % sizeof(Vec4<T>) == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % sizeof(Vec4<T>) == 0) &&
                   (reinterpret_cast<uintptr_t>(m) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const long long nvec = vec ? n / 4 : 0;
  for (long long i = first; i < nvec; i += stride) {
    Vec4<T> pv = reinterpret_cast<const Vec4<T>*>(p)[i];
    const Vec4<T> gv = reinterpret_cast<const Vec4<T>*>(g)[i];
    float4 mv = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    update(pv.v[0], gv.v[0], mv.x, vv.x, c);
    update(pv.v[1], gv.v[1], mv.y, vv.y, c);
    update(pv.v[2], gv.v[2], mv.z, vv.z, c);
    update(pv.v[3], gv.v[3], mv.w, vv.w, c);
    reinterpret_cast<Vec4<T>*>(p)[i] = pv;
    reinterpret_cast<float4*>(m)[i] = mv;
    reinterpret_cast<float4*>(v)[i] = vv;
  }
  for (long long i = nvec * 4 + first; i < n; i += stride) {
    T pe = p[i];
    float me = m[i], ve = v[i];
    update(pe, g[i], me, ve, c);
    p[i] = pe;
    m[i] = me;
    v[i] = ve;
  }
}

}  // namespace

extern "C" {

// The tensors one TensorList holds: the Python wrapper's struct must agree.
int paddle_adamw_max_tensors() { return kMaxTensors; }

// One launch over tl->count tensors of one type (0 float32, 1 bfloat16),
// tl->block_start[tl->count] blocks. Returns the launch's cudaError_t.
int paddle_adamw(const TensorList* tl, const Scalars* s, int dtype, void* stream) {
  const int blocks = tl->block_start[tl->count];
  if (tl->count < 1 || tl->count > kMaxTensors || blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    adamw_kernel<float><<<blocks, kThreads, 0, st>>>(*tl, *s);
  } else if (dtype == 1) {
    adamw_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(*tl, *s);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
