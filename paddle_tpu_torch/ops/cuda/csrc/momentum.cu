// Multi-tensor Momentum update for Hopper (sm_90a): one pass over many
// parameters in one launch, each element updated exactly as the plain
// per-tensor chain of paddle_tpu_torch/ops/cuda/momentum.py computes it.
//
// No Pallas counterpart. The JAX package writes Momentum
// (paddle_tpu/optimizer/optimizers.py: Momentum._apply_one) in jnp, and its
// TrainStep compiles the whole update into one XLA program, where XLA fuses
// it. This kernel is that fusion: the plain version runs about five
// element-wise kernels per parameter (161 parameters in resnet50), this one
// reads each element's p, g and v once and writes p and v once.
//
// What an element of tensor t computes, bit for bit the plain version's torch
// ops (each op rounds once; the float intrinsics below forbid nvcc from
// contracting a multiply and an add into an FMA, which torch's separate
// kernels never do). T is the parameter's type (f32, bf16 or fp16), G the
// gradient's (T, or f32 once a GradScaler has unscaled it):
//   - nothing at all when the device flag found_inf is set (GradScaler's
//     overflow skip: p and v keep their bits);
//   - L2 decay (bit t of l2_mask): g <- R(g + T(wd_t * p)), R rounding to the
//     promoted type of G and T, torch's two roundings;
//   - v <- v*mu + g, f32 velocity;
//   - update = g + mu*v (Nesterov) or v;
//   - p <- T(p - lr_t * update), lr_t = lr[slot[t]] (the LR scaled by the
//     tensor's group and optimize_attr factors, a device scalar from the
//     wrapper's torch ops), T(x) rounding to nearest even (float32: exact).
// Host constants (mu, wd_t) arrive as f32 rounded from the Python doubles, as
// torch rounds a Python scalar for an f32 op.
//
// Launch layout, as csrc/adamw.cu: pointers and sizes travel in
// __grid_constant__ launch parameters (a TensorList of up to kMaxTensors
// tensors, about 2.7 KB with the Scalars, under the 4 KB limit), which a CUDA
// graph captures as they stand. Tensor i owns blocks
// [block_start[i], block_start[i+1]); a block finds its tensor by a scan of
// block_start and grid-strides over it in vectors of 4 elements (p and g 8
// bytes in bf16, 16 in f32; v 16) when all base pointers allow it, one
// element at a time otherwise, and the last n % 4 elements one at a time.
//
// Bound on an H100 SXM (3.35 TB/s): about 5 operations per element against
// 14 bytes moved in bf16 (p read and written 4, g read 2, v read and written
// 8) or 20 in f32: bytes bind. resnet50's 25,557,032 bf16 elements move
// 357.8 MB, 0.1068 ms.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kMaxTensors = 64;

// outside the unnamed namespace: the C entry point takes them, and a type
// of internal linkage would give it internal linkage too
struct TensorList {
  void* p[kMaxTensors];
  const void* g[kMaxTensors];
  float* v[kMaxTensors];
  long long n[kMaxTensors];
  float wd[kMaxTensors];  // L2 coefficient, read where l2_mask has the bit
  int block_start[kMaxTensors + 1];
  unsigned long long l2_mask;  // bit t: L2 decay on tensor t
  unsigned char slot[kMaxTensors];  // tensor t's entry of the LR table
  int count;
};

struct Scalars {
  const float* lr;        // device table, one entry a slot
  const bool* found_inf;  // device flag, or null: skip everything when set
  float mu;
  int nesterov;
};

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

struct Consts {
  float lr, mu, wd;
  bool has_l2, nesterov;
};

template <typename T, typename G>
__device__ __forceinline__ void update(T& p, G g, float& v, const Consts& c) {
  const float pf = to_float(p);
  float gf = to_float(g);
  if (c.has_l2) {
    const float wdp = to_float(from_float<T>(__fmul_rn(c.wd, pf)));
    // the sum rounds to G when G is T, stays f32 when G is f32
    gf = to_float(from_float<G>(__fadd_rn(gf, wdp)));
  }
  v = __fadd_rn(__fmul_rn(c.mu, v), gf);
  const float upd = c.nesterov ? __fadd_rn(gf, __fmul_rn(c.mu, v)) : v;
  p = from_float<T>(__fsub_rn(pf, __fmul_rn(c.lr, upd)));
}

template <typename T>
struct alignas(sizeof(T) * 4) Vec4 {
  T v[4];
};

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads) momentum_kernel(const __grid_constant__ TensorList tl,
                                                           const __grid_constant__ Scalars s) {
  if (s.found_inf != nullptr && *s.found_inf) return;
  const int b = blockIdx.x;
  int t = 0;
  while (t + 1 < tl.count && b >= tl.block_start[t + 1]) ++t;
  const long long n = tl.n[t];
  const long long first = static_cast<long long>(b - tl.block_start[t]) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(tl.block_start[t + 1] - tl.block_start[t]) * kThreads;

  Consts c;
  c.lr = s.lr[tl.slot[t]];
  c.mu = s.mu;
  c.nesterov = s.nesterov != 0;
  c.has_l2 = (tl.l2_mask >> t) & 1ull;
  c.wd = tl.wd[t];

  T* p = static_cast<T*>(tl.p[t]);
  const G* g = static_cast<const G*>(tl.g[t]);
  float* v = tl.v[t];
  const bool vec = (reinterpret_cast<uintptr_t>(p) % sizeof(Vec4<T>) == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % sizeof(Vec4<G>) == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0);
  const long long nvec = vec ? n / 4 : 0;
  for (long long i = first; i < nvec; i += stride) {
    Vec4<T> pv = reinterpret_cast<const Vec4<T>*>(p)[i];
    const Vec4<G> gv = reinterpret_cast<const Vec4<G>*>(g)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    update(pv.v[0], gv.v[0], vv.x, c);
    update(pv.v[1], gv.v[1], vv.y, c);
    update(pv.v[2], gv.v[2], vv.z, c);
    update(pv.v[3], gv.v[3], vv.w, c);
    reinterpret_cast<Vec4<T>*>(p)[i] = pv;
    reinterpret_cast<float4*>(v)[i] = vv;
  }
  for (long long i = nvec * 4 + first; i < n; i += stride) {
    T pe = p[i];
    float ve = v[i];
    update(pe, g[i], ve, c);
    p[i] = pe;
    v[i] = ve;
  }
}

template <typename T, typename G>
int launch(const TensorList* tl, const Scalars* s, int blocks, cudaStream_t st) {
  momentum_kernel<T, G><<<blocks, kThreads, 0, st>>>(*tl, *s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tensors one TensorList holds: the Python wrapper's struct must agree.
int paddle_momentum_max_tensors() { return kMaxTensors; }

// The launch parameters' bytes, which must stay under 4096.
int paddle_momentum_param_bytes() { return static_cast<int>(sizeof(TensorList) + sizeof(Scalars)); }

// One launch over tl->count tensors whose parameters are of type dtype (0
// float32, 1 bfloat16, 2 float16) and whose gradients are of type gdtype
// (dtype, or 0 float32), tl->block_start[tl->count] blocks. Returns the
// launch's cudaError_t.
int paddle_momentum(const TensorList* tl, const Scalars* s, int dtype, int gdtype, void* stream) {
  const int blocks = tl->block_start[tl->count];
  if (tl->count < 1 || tl->count > kMaxTensors || blocks < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && gdtype == 0) return launch<float, float>(tl, s, blocks, st);
  if (dtype == 1 && gdtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(tl, s, blocks, st);
  if (dtype == 2 && gdtype == 2) return launch<__half, __half>(tl, s, blocks, st);
  if (dtype == 1 && gdtype == 0) return launch<__nv_bfloat16, float>(tl, s, blocks, st);
  if (dtype == 2 && gdtype == 0) return launch<__half, float>(tl, s, blocks, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
