// Flash-attention backward for Hopper (sm_90a): the two-pass recompute
// backward over [batch, seq, heads, head_dim] tensors. K2 here serves
// float32 inputs only (the bfloat16 dQ pass is flash_attention_dq_sm90.cu,
// on the tensor cores); K3 serves both float32 and bfloat16.
//
// Replaces, in paddle_tpu/ops/pallas/flash_attention.py (both launched by
// _flash_bwd):
//   K2  _bwd_dq_kernel   -> dq_kernel:  dQ = scale * sum_k dS . K
//   K3  _bwd_dkv_kernel  -> dkv_kernel: dV = sum_q (P o keep/(1-p))^T . dO,
//                                       dK = scale * sum_q dS^T . Q
// with P = exp(q.k^T * scale - lse) recomputed per tile from the forward's
// row logsumexp, dP' = dO . V^T (times keep/(1-p) under dropout) and
// dS = P o (dP' - Delta), Delta = rowsum(dO o O) computed by the wrapper in
// f32 as [B, H, 1, Sq], beside lse. It computes the same function as the
// Pallas bodies, not the same blocks:
//   - layout [B, S, H, D] through per-tensor batch/seq/head strides (last dim
//     contiguous), so q, k and v may be strided slices of a packed qkv;
//     dO likewise; dq, dk, dv are written contiguous in the input dtype;
//   - causal is top-left, q_pos >= k_pos. K2 stops at the last k tile that
//     meets the diagonal; K3 starts at the first q tile that meets it,
//     floor(k0 / 64), and masks the rows of that tile above the diagonal.
//     Keys no query sees (Sk > Sq) get dK = dV = 0;
//   - any Sq, Sk: the ragged edge is masked (out-of-range rows and columns
//     have P = 0 exactly);
//   - dropout replays the forward's mask: the Pallas _dropout_mask hash at
//     each element's global position over the PALLAS tiles
//     (flash_attention_common.cuh). Dropout is a uniform runtime branch here;
//   - every product is an f32 FMA, every sum f32; outputs round once.
//
// Design. Both kernels reuse K1's scheme: 256 threads as a 16 x 16 grid,
// 64 x 64 tiles, operands in shared memory as f32 with rows padded by one
// float against bank conflicts.
//   K2: one block per (64-row q tile, head, batch); Q and dO stay in shared
//   memory, the K/V tiles stream past them. Thread (ty, tx) computes the
//   scores and dP of rows 4ty..4ty+3 against columns tx + 16j in one pass
//   over d (32 FMAs per 16 shared loads), writes dS to shared memory, then
//   accumulates dQ rows 4ty.. at columns tx + 16c in registers.
//   K3: one block per (64-key k tile, head, batch); K and V stay, the Q/dO
//   tiles stream. The same thread grid computes the transposed tiles (keys
//   as rows), so P^T and dS^T land in shared memory as rows, and dV and dK
//   accumulate in registers. No atomics: each output element has one owner,
//   so results do not change from run to run.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 CUDA
// cores, 3.35 TB/s HBM): at the GPT-2-small training shape B=8, S=1024,
// H=12, D=64, causal, K2 does 3 and K3 4 matmuls over the 525k kept (q, k)
// pairs of each of the 96 heads: 19.4 and 25.8 GFLOP. K2 moves q, k, v, dO,
// lse, Delta and dq once, 127 MB in f32 (64 MB in bf16); K3 the same inputs
// and dk, dv, 152 MB (77 MB). f32 is bound by operations on the CUDA cores
// (0.29 and 0.39 ms); bf16 by operations on the tensor cores (0.020 and
// 0.026 ms, bytes close behind), which these f32-FMA kernels do not use:
// wgmma and TMA are the way there.

#include "flash_attention_common.cuh"

namespace {

using namespace paddle_fa;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Sk, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal;
  float scale;
  DropoutArgs drop;
};

constexpr int PS = kBlockK + 1;  // padded row stride of the P / dS tiles

// Blocks per SM the register allocation must allow: two at D <= 64, where
// two blocks' shared memory fits in the SM's 227 KB; one at D = 128, where
// it does not. Two blocks cap a thread at 128 registers; at D = 64 that
// spills a few hundred bytes and still runs 10-18% faster than one block
// at 248 registers, whose 8 warps hide too little of the tile loads.
template <int D>
constexpr int min_blocks() {
  return D <= 64 ? 2 : 1;
}

template <int D>
constexpr int dq_smem_floats() {
  return 4 * kBlockQ * (D + 1) + kBlockQ * PS;
}

template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kBlockQ * (D + 1) + 2 * kBlockK * PS + 2 * kBlockQ;
}

// rows [r0, r0 + 64) of a [S, D] slice with row stride ld into shared memory
// as f32 at row stride QS; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long ld, int r0, int S,
                                          int tid) {
  constexpr int QS = D + 1;
#pragma unroll
  for (int t = 0; t < kBlockQ * D / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int r = e / D, c = e % D;
    dst[r * QS + c] = r0 + r < S ? to_float(src[(r0 + r) * ld + c]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>()) dq_kernel(const Params p) {
  constexpr int DC = D / 16;
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBlockQ * QS;  // dO
  float* sK = sO + kBlockQ * QS;
  float* sV = sK + kBlockK * QS;
  float* sS = sV + kBlockK * QS;  // dS

  // the heaviest causal q tiles (most k tiles) are scheduled first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_tile<T, D>(sQ, q, p.q_ss, q0, p.Sq, tid);
  load_tile<T, D>(sO, dout, p.o_ss, q0, p.Sq, tid);

  float lse_i[4], delta_i[4];
  uint32_t rkey[4];
  int rin[4];
  const bool drop = p.drop.on;
  const uint32_t head = drop ? head_key(static_cast<uint32_t>(*p.drop.seed), b, h) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    const bool in = qp < p.Sq;
    lse_i[i] = in ? p.lse[row0 + qp] : 0.f;
    delta_i[i] = in ? p.delta[row0 + qp] : 0.f;
    const int iq = drop ? qp / p.drop.block_q : 0;
    rkey[i] = row_key(head, iq);
    rin[i] = qp - iq * p.drop.block_q;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  int n_kt = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) n_kt = min(n_kt, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's sK, sV, sS reads are done
    load_tile<T, D>(sK, k, p.k_ss, k0, p.Sk, tid);
    load_tile<T, D>(sV, v, p.v_ss, k0, p.Sk, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(ty * 4 + i) * QS + d];
        ov[i] = sO[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(tx + 16 * j) * QS + d];
        vv[j] = sV[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

    int ik[4], cin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + tx + 16 * j;
      ik[j] = drop ? kp / p.drop.block_k : 0;
      cin[j] = kp - ik[j] * p.drop.block_k;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = qp < p.Sq && kp < p.Sk && (!p.causal || qp >= kp);
        const float pij = ok ? expf(s[i][j] * p.scale - lse_i[i]) : 0.f;
        float dpij = dp[i][j];
        if (drop)
          dpij = keep_bit(rkey[i], ik[j], rin[i], cin[j], p.drop.thresh) ? dpij / p.drop.keep_prob
                                                                         : 0.f;
        sS[(ty * 4 + i) * PS + tx + 16 * j] = pij * (dpij - delta_i[i]);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = sS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = sK[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= p.Sq) continue;
    T* row = static_cast<T*>(p.dq) + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c] * p.scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>()) dkv_kernel(const Params p) {
  constexpr int DC = D / 16;
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kBlockK * QS;
  float* sQ = sV + kBlockK * QS;
  float* sO = sQ + kBlockQ * QS;  // dO
  float* sP = sO + kBlockQ * QS;  // (P o keep/(1-p))^T, keys as rows
  float* sS = sP + kBlockK * PS;  // dS^T
  float* sL = sS + kBlockK * PS;  // lse of the q tile
  float* sD = sL + kBlockQ;       // Delta of the q tile

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const T* dout = static_cast<const T*>(p.dout) + b * p.o_sb + h * p.o_sh;
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_tile<T, D>(sK, k, p.k_ss, k0, p.Sk, tid);
  load_tile<T, D>(sV, v, p.v_ss, k0, p.Sk, tid);

  // dropout: each key's Pallas k tile and its column inside it
  const bool drop = p.drop.on;
  const uint32_t head = drop ? head_key(static_cast<uint32_t>(*p.drop.seed), b, h) : 0u;
  int ik[4], cin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    ik[i] = drop ? kp / p.drop.block_k : 0;
    cin[i] = kp - ik[i] * p.drop.block_k;
  }

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int n_qt = (p.Sq + kBlockQ - 1) / kBlockQ;
  // top-left causal: the first q tile with a row at or below this k tile's
  // first key
  const int qt0 = p.causal ? k0 / kBlockQ : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // the previous tile's sQ, sO, sP, sS reads are done
    load_tile<T, D>(sQ, q, p.q_ss, q0, p.Sq, tid);
    load_tile<T, D>(sO, dout, p.o_ss, q0, p.Sq, tid);
    if (tid < kBlockQ) {
      const int qp = q0 + tid;
      sL[tid] = qp < p.Sq ? p.lse[row0 + qp] : 0.f;
      sD[tid] = qp < p.Sq ? p.delta[row0 + qp] : 0.f;
    }
    __syncthreads();

    // transposed tiles: st[i][j] = K[key 4ty+i] . Q[query tx+16j]
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], ov[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(ty * 4 + i) * QS + d];
        vv[i] = sV[(ty * 4 + i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(tx + 16 * j) * QS + d];
        ov[j] = sO[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
          dpt[i][j] = fmaf(vv[i], ov[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int qp = q0 + tx + 16 * j;
      const float lse = sL[tx + 16 * j];
      const float delta = sD[tx + 16 * j];
      const int iq = drop ? qp / p.drop.block_q : 0;
      const uint32_t rkey = row_key(head, iq);
      const int rin = qp - iq * p.drop.block_q;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty * 4 + i;
        const bool ok = qp < p.Sq && kp < p.Sk && (!p.causal || qp >= kp);
        const float pij = ok ? expf(st[i][j] * p.scale - lse) : 0.f;
        float pav = pij, dpij = dpt[i][j];
        if (drop) {
          const bool keep = keep_bit(rkey, ik[i], rin, cin[i], p.drop.thresh);
          pav = keep ? pij / p.drop.keep_prob : 0.f;
          dpij = keep ? dpij / p.drop.keep_prob : 0.f;
        }
        sP[(ty * 4 + i) * PS + tx + 16 * j] = pav;
        sS[(ty * 4 + i) * PS + tx + 16 * j] = pij * (dpij - delta);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float pv[4], sv[4], ov[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(ty * 4 + i) * PS + qq];
        sv[i] = sS[(ty * 4 + i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        ov[c] = sO[qq * QS + tx + 16 * c];
        qv[c] = sQ[qq * QS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          adv[i][c] = fmaf(pv[i], ov[c], adv[i][c]);
          adk[i][c] = fmaf(sv[i], qv[c], adk[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= p.Sk) continue;
    const long long off = ((static_cast<long long>(b) * p.Sk + kp) * p.H + h) * D;
    T* krow = static_cast<T*>(p.dk) + off;
    T* vrow = static_cast<T*>(p.dv) + off;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      krow[tx + 16 * c] = from_float<T>(adk[i][c] * p.scale);
      vrow[tx + 16 * c] = from_float<T>(adv[i][c]);
    }
  }
}

template <typename T, int D>
cudaError_t launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int smem = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int smem = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kBlockK - 1) / kBlockK, p.H, p.B);
  dkv_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool kDq>
cudaError_t launch_pass(const Params& p, cudaStream_t stream) {
  if constexpr (kDq)
    return launch_dq<T, D>(p, stream);
  else
    return launch_dkv<T, D>(p, stream);
}

template <typename T, bool kDq>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_pass<T, 16, kDq>(p, stream);
    case 32: return launch_pass<T, 32, kDq>(p, stream);
    case 64: return launch_pass<T, 64, kDq>(p, stream);
    case 128: return launch_pass<T, 128, kDq>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int run(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, const void* seed, void* dq, void* dk, void* dv, int dtype, int B,
        int Sq, int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
        long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal, float scale,
        int dropout_on, float keep_prob, uint32_t thresh, int block_q, int block_k, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.q_sb = q_sb;
  p.q_ss = q_ss;
  p.q_sh = q_sh;
  p.k_sb = k_sb;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sb = v_sb;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.causal = causal;
  p.scale = scale;
  p.drop.seed = static_cast<const int*>(seed);
  p.drop.on = dropout_on;
  p.drop.keep_prob = keep_prob;
  p.drop.thresh = thresh;
  p.drop.block_q = block_q;
  p.drop.block_k = block_k;
  if (block_q < 1 || block_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bfloat16 dQ pass runs on the tensor cores (flash_attention_dq_sm90.cu)
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = launch_d<float, kDq>(p, D, s);
  } else if constexpr (!kDq) {
    if (dtype == 1) err = launch_d<__nv_bfloat16, false>(p, D, s);
  }
  return static_cast<int>(err);
}

}  // namespace

// Both entry points take the same arguments. dtype: 0 = float32,
// 1 = bfloat16 (K3 only: the bfloat16 dQ pass is paddle_flash_attention_
// bwd_dq_sm90). Strides are in elements (q, k, v, then dO). lse and delta
// are contiguous [B, H, 1, Sq] f32; dq is a contiguous [B, Sq, H, D] and
// dk, dv contiguous [B, Sk, H, D] tensors in the input dtype. seed is a (1,)
// int32 device tensor, read only when dropout_on; keep_prob, thresh,
// block_q and block_k describe the forward's mask. Each returns the
// cudaError_t of its launch (0 on success).
#define PADDLE_FA_BWD_ARGS                                                                      \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,               \
      const void *delta, const void *seed, void *dq, void *dk, void *dv, int dtype, int B,      \
      int Sq, int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,              \
      long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,            \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal, float scale,   \
      int dropout_on, float keep_prob, uint32_t thresh, int block_q, int block_k, void *stream
#define PADDLE_FA_BWD_PASS                                                                       \
  q, k, v, dout, lse, delta, seed, dq, dk, dv, dtype, B, Sq, Sk, H, D, q_sb, q_ss, q_sh, k_sb,   \
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, scale, dropout_on, keep_prob,      \
      thresh, block_q, block_k, stream

extern "C" int paddle_flash_attention_bwd_dq(PADDLE_FA_BWD_ARGS) {
  return run<true>(PADDLE_FA_BWD_PASS);
}

extern "C" int paddle_flash_attention_bwd_dkv(PADDLE_FA_BWD_ARGS) {
  return run<false>(PADDLE_FA_BWD_PASS);
}
