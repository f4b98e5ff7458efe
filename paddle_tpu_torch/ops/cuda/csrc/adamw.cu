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
// What an element of tensor t computes, bit for bit the plain version's torch
// ops (each op rounds once; the float intrinsics below forbid nvcc from
// contracting a multiply and an add into an FMA, which torch's separate
// kernels never do). T is the parameter's type (f32, bf16 or fp16), G the
// gradient's (T, or f32 once a GradScaler has unscaled it):
//   - nothing at all when the device flag found_inf is set (GradScaler's
//     overflow skip: p, m, v and vmax keep their bits);
//   - decoupled decay (AdamW, bit t of decay_mask): p <- T(p * decay[slot[t]]),
//     the table entry being the device scalar 1 - lr_t*coeff_t the wrapper
//     computed with torch ops;
//   - L2 decay (Adam's weight_decay, bit t of l2_mask): g <- R(g + T(wd_t * p)),
//     R rounding to the promoted type of G and T, torch's two roundings;
//   - m <- m*b1 + (1-b1)*g; v <- v*b2 + ((1-b2)*g)*g, f32 moments;
//   - amsgrad: vmax <- max(vmax, v) (NaN propagating, as torch.maximum), and
//     vmax takes v's place below;
//   - p <- T(p - (lr_t * (m / bc1)) / (sqrt(v / bc2) + eps)), lr_t = lr[slot[t]]
//     (the LR scaled by the tensor's group, optimize_attr and lr_ratio, a
//     device scalar from the wrapper's torch ops), bc1 = 1 - b1^t and
//     bc2 = 1 - b2^t device scalars likewise, T(x) rounding to nearest even
//     (float32: exact).
// Host constants (b1, b2, 1-b1, 1-b2, eps, wd_t) arrive as f32 rounded from
// the Python doubles, as torch rounds a Python scalar for an f32 op.
//
// Launch layout. Pointers and sizes travel in the launch parameters (a
// TensorList of up to kMaxTensors tensors, about 3.7 KB with the Scalars,
// under the 4 KB parameter limit), in the style of apex's multi_tensor_apply: a pointer table in device memory
// would need a host copy every step, which a CUDA graph cannot capture
// cleanly, while launch parameters go into the graph as they stand. Both
// structs are __grid_constant__, so the kernel indexes them in the parameter
// space without a copy to local memory. Tensor i owns blocks
// [block_start[i], block_start[i+1]); a block finds its tensor by a scan of
// block_start and grid-strides over it in vectors of 4 elements (p and g 8
// bytes in bf16, 16 in f32; m, v and vmax 16) when all base pointers allow it,
// one element at a time otherwise, and the last n % 4 elements one at a time.
//
// Bound on an H100 SXM (3.35 TB/s): about 20 operations per element against
// 22 bytes moved in bf16 or fp16 (p read and written, g read, m and v read
// and written; amsgrad adds vmax's 8) or 28 in f32, far below the ~295
// operations per byte at which compute would bind: bytes bind. gpt2_small's 124.4 M bf16 elements move
// 2.74 GB, 0.82 ms.

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
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  float* vmax[kMaxTensors];  // amsgrad only
  long long n[kMaxTensors];
  float wd[kMaxTensors];     // L2 coefficient, read where l2_mask has the bit
  int block_start[kMaxTensors + 1];
  unsigned long long decay_mask;  // bit t: AdamW's decoupled decay on tensor t
  unsigned long long l2_mask;     // bit t: Adam's L2 decay on tensor t
  unsigned char slot[kMaxTensors];  // tensor t's entry of the lr/decay tables
  int count;
};

struct Scalars {
  const float* lr;     // device tables, one entry a slot
  const float* decay;  // 1 - lr_t*coeff_t, read where decay_mask has the bit
  const float* bc1;    // device scalars
  const float* bc2;
  const bool* found_inf;  // device flag, or null: skip everything when set
  float beta1, beta2, one_minus_beta1, one_minus_beta2, eps;
  int amsgrad;
};

namespace {

struct Consts {
  float lr, bc1, bc2, decay;
  float beta1, beta2, omb1, omb2, eps, wd;
  bool has_decay, has_l2, amsgrad;
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
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

template <typename T, typename G>
__device__ __forceinline__ void update(T& p, G g, float& m, float& v, float* vmax,
                                       const Consts& c) {
  float pf = to_float(p);
  if (c.has_decay) pf = to_float(from_float<T>(__fmul_rn(pf, c.decay)));
  float gf = to_float(g);
  if (c.has_l2) {
    const float wdp = to_float(from_float<T>(__fmul_rn(c.wd, pf)));
    // the sum rounds to G when G is T, stays f32 when G is f32
    gf = to_float(from_float<G>(__fadd_rn(gf, wdp)));
  }
  m = __fadd_rn(__fmul_rn(m, c.beta1), __fmul_rn(c.omb1, gf));
  v = __fadd_rn(__fmul_rn(v, c.beta2), __fmul_rn(__fmul_rn(c.omb2, gf), gf));
  float vv = v;
  if (c.amsgrad) vv = *vmax = max_nan(*vmax, v);
  const float mhat = __fdiv_rn(m, c.bc1);
  const float vhat = __fdiv_rn(vv, c.bc2);
  const float denom = __fadd_rn(__fsqrt_rn(vhat), c.eps);
  p = from_float<T>(__fsub_rn(pf, __fdiv_rn(__fmul_rn(c.lr, mhat), denom)));
}

template <typename T>
struct alignas(sizeof(T) * 4) Vec4 {
  T v[4];
};

template <typename T, typename G>
__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ TensorList tl,
                                                        const __grid_constant__ Scalars s) {
  if (s.found_inf != nullptr && *s.found_inf) return;
  const int b = blockIdx.x;
  int t = 0;
  while (t + 1 < tl.count && b >= tl.block_start[t + 1]) ++t;
  const long long n = tl.n[t];
  const long long first = static_cast<long long>(b - tl.block_start[t]) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(tl.block_start[t + 1] - tl.block_start[t]) * kThreads;

  Consts c;
  const int slot = tl.slot[t];
  c.lr = s.lr[slot];
  c.has_decay = (tl.decay_mask >> t) & 1ull;
  c.has_l2 = (tl.l2_mask >> t) & 1ull;
  c.decay = c.has_decay ? s.decay[slot] : 1.f;
  c.wd = tl.wd[t];
  c.bc1 = *s.bc1;
  c.bc2 = *s.bc2;
  c.beta1 = s.beta1;
  c.beta2 = s.beta2;
  c.omb1 = s.one_minus_beta1;
  c.omb2 = s.one_minus_beta2;
  c.eps = s.eps;
  c.amsgrad = s.amsgrad != 0;

  T* p = static_cast<T*>(tl.p[t]);
  const G* g = static_cast<const G*>(tl.g[t]);
  float* m = tl.m[t];
  float* v = tl.v[t];
  float* vmax = tl.vmax[t];
  const bool vec = (reinterpret_cast<uintptr_t>(p) % sizeof(Vec4<T>) == 0) &&
                   (reinterpret_cast<uintptr_t>(g) % sizeof(Vec4<G>) == 0) &&
                   (reinterpret_cast<uintptr_t>(m) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                   (!c.amsgrad || reinterpret_cast<uintptr_t>(vmax) % 16 == 0);
  const long long nvec = vec ? n / 4 : 0;
  for (long long i = first; i < nvec; i += stride) {
    Vec4<T> pv = reinterpret_cast<const Vec4<T>*>(p)[i];
    const Vec4<G> gv = reinterpret_cast<const Vec4<G>*>(g)[i];
    float4 mv = reinterpret_cast<const float4*>(m)[i];
    float4 vv = reinterpret_cast<const float4*>(v)[i];
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c.amsgrad) xv = reinterpret_cast<const float4*>(vmax)[i];
    update(pv.v[0], gv.v[0], mv.x, vv.x, &xv.x, c);
    update(pv.v[1], gv.v[1], mv.y, vv.y, &xv.y, c);
    update(pv.v[2], gv.v[2], mv.z, vv.z, &xv.z, c);
    update(pv.v[3], gv.v[3], mv.w, vv.w, &xv.w, c);
    reinterpret_cast<Vec4<T>*>(p)[i] = pv;
    reinterpret_cast<float4*>(m)[i] = mv;
    reinterpret_cast<float4*>(v)[i] = vv;
    if (c.amsgrad) reinterpret_cast<float4*>(vmax)[i] = xv;
  }
  for (long long i = nvec * 4 + first; i < n; i += stride) {
    T pe = p[i];
    float me = m[i], ve = v[i];
    float xe = c.amsgrad ? vmax[i] : 0.f;
    update(pe, g[i], me, ve, &xe, c);
    p[i] = pe;
    m[i] = me;
    v[i] = ve;
    if (c.amsgrad) vmax[i] = xe;
  }
}

template <typename T, typename G>
int launch(const TensorList* tl, const Scalars* s, int blocks, cudaStream_t st) {
  adamw_kernel<T, G><<<blocks, kThreads, 0, st>>>(*tl, *s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tensors one TensorList holds: the Python wrapper's struct must agree.
int paddle_adamw_max_tensors() { return kMaxTensors; }

// The launch parameters' bytes, which must stay under 4096.
int paddle_adamw_param_bytes() { return static_cast<int>(sizeof(TensorList) + sizeof(Scalars)); }

// One launch over tl->count tensors whose parameters are of type dtype (0
// float32, 1 bfloat16, 2 float16) and whose gradients are of type gdtype
// (dtype, or 0 float32), tl->block_start[tl->count] blocks. Returns the
// launch's cudaError_t.
int paddle_adamw(const TensorList* tl, const Scalars* s, int dtype, int gdtype, void* stream) {
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
