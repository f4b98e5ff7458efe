// Flash-attention forward for Hopper (sm_90a): online-softmax attention over
// [batch, seq, heads, head_dim] tensors, emitting O and the row logsumexp.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (launched by
// _flash_fwd). It computes the same function, not the same blocks:
//   - layout [B, S, H, D] read through batch/seq/head strides (the last dim
//     must be contiguous), so q/k/v may be the strided slices of a packed
//     qkv [B, S, H, 3, D] without a copy;
//   - causal is top-left, q_pos >= k_pos; k tiles wholly above the diagonal
//     are skipped, masked scores are -1e30 and their probabilities exactly 0;
//   - running max, running sum and accumulator are f32; O is written in the
//     input dtype (f32 or bf16), lse = m + log(max(l, 1e-30)) in f32 as
//     [B, H, 1, Sq];
//   - any Sq, Sk: the ragged edge of the last tile is masked;
//   - dropout inside the kernel, by the Pallas _dropout_mask hash at each
//     element's global position over the PALLAS tiles (flash_attention_common.cuh),
//     so the mask is the one K2, K3 and the JAX package replay. As in the
//     Pallas body, l sums the undropped probabilities and acc accumulates
//     p * keep / (1 - p_drop). Dropout is a template parameter: the
//     instantiation without it is the kernel as it was before dropout, so
//     its output is bitwise unchanged.
//
// Design. One thread block per (64-row q tile, head, batch); 256 threads as a
// 16 x 16 grid. Thread (ty, tx) owns q rows 4*ty..4*ty+3: in the score phase
// it computes their scores against k columns tx + 16*j (j < 4), in the output
// phase their accumulator columns tx + 16*c (c < D/16). The 16 threads of a
// row group are 16 lanes of one warp, so row max and row sum are xor-shuffle
// reductions, and the online-softmax state (m, l, acc) stays in registers.
// Q, the current K/V tile and the probability tile P live in shared memory as
// f32 (rows padded by one float against bank conflicts). Tile sizes and the
// k-tile order do not depend on the sequence length, so a real row r sees
// exactly columns <= r in the same order whatever the padding of the batch:
// the greedy decode path's batch invariance rests on this.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 67 TFLOP/s f32 CUDA
// cores, 3.35 TB/s HBM): at the GPT-2-small prefill shape B=1, S=1024, H=12,
// D=64, causal, the work is 4*D*S*(S+1)/2*H = 1.61 GFLOP and q, k, v, o move
// 12.6 MB in f32 or 6.3 MB in bf16. f32 is bound by operations on the CUDA
// cores (about 24 us); bf16 by memory (about 1.9 us). At the training shape
// B=8 the same holds eight times over: 0.19 ms f32, 0.015 ms bf16. Dropout
// adds about ten integer multiplies of the hash per score element, against
// the element's 2*D FMAs. This kernel does every
// product as an f32 FMA on the CUDA cores, so it cannot reach the bf16 bound:
// wgmma on the tensor cores and TMA loads are the way there. Its own limit is
// the shared-memory loads of the score and output phases (8 scalar loads per
// 16 FMAs). ptxas gives D = 64 238 registers, one block per SM; D = 128 hits
// 255 and spills a few hundred bytes whatever the unrolling.

#include "flash_attention_common.cuh"

namespace {

using namespace paddle_fa;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, Sq, Sk, H;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal;
  float scale;
  DropoutArgs drop;
};

template <int D>
constexpr int smem_floats() {
  return kBlockQ * (D + 1) + kBlockK * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1);
}

template <typename T, int D, bool kDropout>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Params p) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  constexpr int QS = D + 1;   // padded row strides in shared memory
  constexpr int PS = kBlockK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * QS;
  float* sV = sK + kBlockK * QS;
  float* sP = sV + kBlockK * D;

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;

  // K/V tiles go global -> registers -> shared memory: the next tile's
  // loads are issued before the current tile's compute, so their latency
  // hides behind it, and the unrolled loops keep every load of a tile in
  // flight at once.
  constexpr int kLoads = kBlockK * D / kThreads;
  T kreg[kLoads], vreg[kLoads];
  auto load_kv = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int e = tid + t * kThreads;
      const int ki = k0 + e / D, c = e % D;
      const bool in = ki < p.Sk;
      kreg[t] = in ? k[ki * p.k_ss + c] : from_float<T>(0.f);
      vreg[t] = in ? v[ki * p.v_ss + c] : from_float<T>(0.f);
    }
  };
  load_kv(0);

#pragma unroll
  for (int t = 0; t < kBlockQ * D / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int r = e / D, c = e % D;
    const int qi = q0 + r;
    sQ[r * QS + c] = qi < p.Sq ? to_float(q[qi * p.q_ss + c]) : 0.f;
  }

  // dropout: each row's key and its row inside its Pallas q tile
  uint32_t rkey[4];
  int rin[4];
  if constexpr (kDropout) {
    const uint32_t head = head_key(static_cast<uint32_t>(*p.drop.seed), b, h);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      const int iq = qp / p.drop.block_q;
      rkey[i] = row_key(head, iq);
      rin[i] = qp - iq * p.drop.block_q;
    }
  }

  float m_i[4], l_i[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (p.Sk + kBlockK - 1) / kBlockK;
  if (p.causal) n_kt = min(n_kt, (q0 + kBlockQ - 1) / kBlockK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's sK, sV, sP reads are done
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int e = tid + t * kThreads;
      const int r = e / D, c = e % D;
      sK[r * QS + c] = to_float(kreg[t]);
      sV[r * D + c] = to_float(vreg[t]);
    }
    __syncthreads();
    if (kt + 1 < n_kt) load_kv(k0 + kBlockK);

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // dropout: each column's Pallas k tile and its column inside it
    int ik[4], cin[4];
    if constexpr (kDropout) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ik[j] = kp / p.drop.block_k;
        cin[j] = kp - ik[j] * p.drop.block_k;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < p.Sk && (!p.causal || qp >= kp);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pj;
        if constexpr (kDropout) {
          sP[(ty * 4 + i) * PS + tx + 16 * j] =
              keep_bit(rkey[i], ik[j], rin[i], cin[j], p.drop.thresh) ? pj / p.drop.keep_prob : 0.f;
        } else {
          sP[(ty * 4 + i) * PS + tx + 16 * j] = pj;
        }
      }
      rs = row_sum16(rs);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= p.Sq) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
    T* orow = static_cast<T*>(p.o) + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_float<T>(acc[i][c] / den);
    if (tx == 0) p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] = m_i[i] + logf(den);
  }
}

template <typename T, int D, bool kDropout>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<T, D, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  fwd_kernel<T, D, kDropout><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, bool kDropout>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, kDropout>(p, stream);
    case 32: return launch<T, 32, kDropout>(p, stream);
    case 64: return launch<T, 64, kDropout>(p, stream);
    case 128: return launch<T, 128, kDropout>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_t(const Params& p, int d, cudaStream_t stream) {
  return p.drop.on ? launch_d<T, true>(p, d, stream) : launch_d<T, false>(p, d, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. o is a
// contiguous [B, Sq, H, D] tensor, lse a contiguous [B, H, 1, Sq] f32 tensor.
// seed is a (1,) int32 device tensor, read only when dropout_on; keep_prob,
// thresh, block_q and block_k describe the mask (flash_attention_common.cuh).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int paddle_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* seed, int dtype,
    int B, int Sq, int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, int dropout_on, float keep_prob, uint32_t thresh, int block_q,
    int block_k, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
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
  p.causal = causal;
  p.scale = scale;
  p.drop.seed = static_cast<const int*>(seed);
  p.drop.on = dropout_on;
  p.drop.keep_prob = keep_prob;
  p.drop.thresh = thresh;
  p.drop.block_q = block_q;
  p.drop.block_k = block_k;
  if (dropout_on && (block_q < 1 || block_k < 1)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0   ? launch_t<float>(p, D, s)
                    : dtype == 1 ? launch_t<__nv_bfloat16>(p, D, s)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
