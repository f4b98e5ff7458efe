// FlashMask attention for Hopper (sm_90a): attention under a column-interval
// mask over [batch, seq, heads, head_dim] tensors, the forward and the dQ
// pass of the two-pass recompute backward, for float32 only, on the CUDA
// cores. The bfloat16 kernels run on the tensor cores (K5
// flashmask_fwd_sm90.cu, K6 flashmask_dq_sm90.cu, K7 flashmask_dkv_sm90.cu);
// the float32 dK/dV pass (K7) runs on them in 3xTF32 (flashmask_dkv_tf32.cu).
//
// Replaces, in paddle_tpu/ops/pallas/flashmask.py:
//   K5  _fm_fwd_kernel     (launched by _fm_fwd)  -> flashmask_fwd_kernel: O, lse
//   K6  _fm_bwd_dq_kernel  (launched by _fm_bwd)  -> flashmask_dq_kernel:
//                                                    dQ = scale * sum_k dS . K
// with P = exp(q.k^T * scale - lse) recomputed per tile from the forward's row
// logsumexp, dP = dO . V^T and dS = P o (dP - Delta), Delta = rowsum(dO o O)
// computed by the wrapper in f32 as [B, H, 1, Sq], beside lse.
//
// The mask. startend_row_indices [B, Hm, Sk, ncol] int32 (contiguous, Hm = 1
// broadcast over the heads) gives, for each key column, the query rows it
// hides: causal with ncol 1, rows >= LTS; causal with ncol 2, rows in
// [LTS, LTE); non-causal with ncol 4, rows in [LTS, LTE) or [UTS, UTE). A
// block loads its k tile's [64, ncol] slab into shared memory as two
// intervals per column (a missing interval is empty, a missing end is open),
// and each score compares its row against its column's two intervals: no
// [Sq, Sk] mask exists in device memory. Causal adds rows < column (top-left,
// q_pos >= k_pos allowed), as in the Pallas kernels.
//
// It computes the same function as the Pallas bodies, not the same blocks:
//   - layout [B, S, H, D] through per-tensor batch/seq/head strides (last dim
//     contiguous); outputs written contiguous in the input dtype, lse in f32;
//   - disallowed scores are SELECTED away (?:), never multiplied by a 0/1
//     mask: a row whose first tiles are all masked keeps m = -1e30, where
//     exp(s - m) would be 1; in the backward a fully masked row has
//     lse ~ -1e30, where exp(s - lse) is inf and inf * 0 NaN. A fully masked
//     row gives O = 0, lse = -1e30 + log(1e-30), dQ = 0, as the Pallas
//     kernels do (the denominator is clamped at 1e-30);
//   - tiles are skipped only where that is exact: the causal bound stops
//     the k loop at the last k tile meeting the diagonal; besides, a k tile
//     whose every key column hides every row of the q tile is skipped by a
//     block-wide vote (__syncthreads_and) before its K/V loads. Its P is 0
//     everywhere, so it adds nothing to any sum, and the online softmax state
//     is unchanged by it (alpha = 1);
//   - any Sq, Sk: the ragged edge is masked;
//   - every product is an f32 FMA, every sum f32; no dropout (the Pallas
//     kernels have none).
//
// Design. 256 threads as a 16 x 16 grid, 64 x 64 tiles, operands in shared
// memory as f32 with rows padded by one float against bank conflicts, the
// sequential grid axis of the Pallas kernels as a loop inside the block.
//   K5: one block per (64-row q tile, head, batch), the heaviest causal q
//   tiles first; thread (ty, tx) owns rows 4ty..4ty+3, their scores against
//   columns tx + 16j and their accumulator columns tx + 16c; the online
//   softmax state stays in registers, reduced over 16 lanes by shuffles.
//   K6: K5's blocks; Q and dO stay in shared memory, K/V tiles stream; dQ
//   accumulates in registers. No atomics: every output element has one
//   owner.
//
// Bound on an H100 SXM (67 TFLOP/s f32 CUDA cores, 3.35 TB/s HBM), counted
// over the (q, k) pairs the mask allows, N: K5 does 2 matmuls (4 D N flops
// per head) and moves q, k, v, o, lse and the indices once; K6 3 matmuls and
// q, k, v, dO, dq, lse, Delta. At the long-context path shape of
// chip_smoke.py phase 14 (B=1, S=8192, 32 heads, D=128, causal documents,
// 10.5 M allowed pairs a head) both are bound by operations. The script
// computes each bound from the run's own mask. These kernels do every
// product as an f32 FMA on the CUDA cores, so their own limit is the
// shared-memory loads of the two matmul phases; wgmma and TMA are the way to
// the bound. The interval skip visits only the tiles with an allowed pair (a
// third of the causal tiles there), so the time follows N rather than the
// causal pair count. At D = 128 K5 and K6 spill registers (chip_smoke.py
// prints ptxas).

#include "flash_attention_common.cuh"

namespace {

using namespace paddle_fa;

constexpr int kOpen = 0x7fffffff;  // the end of an interval open to the last row
constexpr int PS = kBlockK + 1;    // padded row stride of the P / dS tiles

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;    // backward
  const int* idx;      // [B, Hm, Sk, ncol]
  const float* lse;    // backward: the forward's [B, H, 1, Sq]
  const float* delta;  // backward: [B, H, 1, Sq]
  void* o;             // forward outputs
  float* lse_out;
  void* dq;            // backward output
  int B, Sq, Sk, H, Hm, ncol;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int causal;
  float scale;
};

// Blocks per SM the register allocation of K6 must allow: two at
// D <= 64, where two blocks' shared memory fits in the SM's 227 KB.
template <int D>
constexpr int min_blocks() {
  return D <= 64 ? 2 : 1;
}

template <int D>
constexpr int fwd_smem_bytes() {
  return (kBlockQ * (D + 1) + 2 * kBlockK * (D + 1) + kBlockQ * PS) * 4 + 4 * kBlockK * 4;
}

template <int D>
constexpr int dq_smem_bytes() {
  return (4 * kBlockQ * (D + 1) + kBlockQ * PS) * 4 + 4 * kBlockK * 4;
}

// rows [r0, r0 + 64) of a [S, D] slice with row stride ld into shared memory
// as f32 at row stride D + 1; rows past S are zero
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

// the (b, head) slice of the indices; Hm = 1 broadcasts over the heads
__device__ __forceinline__ const int* head_indices(const Params& p, int b, int h) {
  return p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;
}

// Key columns [k0, k0 + 64) as two hidden row intervals each: sI[4c], sI[4c+1]
// is [start, end) of the first, sI[4c+2], sI[4c+3] of the second. Threads
// tid < 64 write column tid; columns past Sk get empty intervals (the ragged
// edge is masked by position).
__device__ __forceinline__ void load_intervals(int* sI, const int* idx, int ncol, int k0, int Sk,
                                               int tid) {
  if (tid >= kBlockK) return;
  const int kp = k0 + tid;
  int lts = 0, lte = 0, uts = 0, ute = 0;
  if (kp < Sk) {
    const int* col = idx + static_cast<long long>(kp) * ncol;
    lts = col[0];
    lte = ncol >= 2 ? col[1] : kOpen;
    if (ncol == 4) {
      uts = col[2];
      ute = col[3];
    }
  }
  sI[4 * tid] = lts;
  sI[4 * tid + 1] = lte;
  sI[4 * tid + 2] = uts;
  sI[4 * tid + 3] = ute;
}

__device__ __forceinline__ bool hidden(const int* iv, int r) {
  return (r >= iv[0] && r < iv[1]) || (r >= iv[2] && r < iv[3]);
}

// Whether the (q, k) pair is allowed: in range, not above the causal
// diagonal, not in one of the key column's two intervals.
__device__ __forceinline__ bool allowed(const Params& p, const int* iv, int qp, int kp) {
  return qp < p.Sq && kp < p.Sk && !(p.causal && qp < kp) && !hidden(iv, qp);
}

// Whether key column kp hides every row of [q0, q_last]: its first allowed
// row at or after q0, found by jumping past the causal interval [0, kp) and
// the two hidden intervals, lies past q_last. Each interval can be passed at
// most once, as the row only grows, so three rounds reach the fixed point.
__device__ __forceinline__ bool column_hidden(const Params& p, const int* iv, int kp, int q0,
                                              int q_last) {
  if (kp >= p.Sk) return true;
  int r = q0;
#pragma unroll
  for (int round = 0; round < 3; ++round) {
    if (p.causal && r < kp) r = kp;
    if (r >= iv[0] && r < iv[1]) r = iv[1];
    if (r >= iv[2] && r < iv[3]) r = iv[3];
  }
  return r > q_last;
}

// Block-wide vote: true when every key column of the tile held in sI hides
// every row of the q tile [q0, q0 + 64). A barrier: after it, sI is visible
// to all threads.
__device__ __forceinline__ bool tile_hidden(const Params& p, const int* sI, int k0, int q0,
                                            int tid) {
  const int q_last = min(q0 + kBlockQ, p.Sq) - 1;
  return __syncthreads_and(tid >= kBlockK ||
                           column_hidden(p, sI + 4 * tid, k0 + tid, q0, q_last));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flashmask_fwd_kernel(const Params p) {
  constexpr int DC = D / 16;  // accumulator columns per thread
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * QS;
  float* sV = sK + kBlockK * QS;
  float* sP = sV + kBlockK * QS;
  int* sI = reinterpret_cast<int*>(sP + kBlockQ * PS);

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
  const int* idx = head_indices(p, b, h);

  load_tile<T, D>(sQ, q, p.q_ss, q0, p.Sq, tid);

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
    __syncthreads();  // the previous tile's sK, sV, sP, sI reads are done
    load_intervals(sI, idx, p.ncol, k0, p.Sk, tid);
    if (tile_hidden(p, sI, k0, q0, tid)) continue;
    load_tile<T, D>(sK, k, p.k_ss, k0, p.Sk, tid);
    load_tile<T, D>(sV, v, p.v_ss, k0, p.Sk, tid);
    __syncthreads();

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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        ok[j] = allowed(p, sI + 4 * c, qp, k0 + c);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max16(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += pj;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = pj;
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
      for (int c = 0; c < DC; ++c) vv[c] = sV[kk * QS + tx + 16 * c];
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
    if (tx == 0) p.lse_out[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] = m_i[i] + logf(den);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>()) flashmask_dq_kernel(const Params p) {
  constexpr int DC = D / 16;
  constexpr int QS = D + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + kBlockQ * QS;  // dO
  float* sK = sO + kBlockQ * QS;
  float* sV = sK + kBlockK * QS;
  float* sS = sV + kBlockK * QS;  // dS
  int* sI = reinterpret_cast<int*>(sS + kBlockQ * PS);

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
  const int* idx = head_indices(p, b, h);
  const long long row0 = (static_cast<long long>(b) * p.H + h) * p.Sq;

  load_tile<T, D>(sQ, q, p.q_ss, q0, p.Sq, tid);
  load_tile<T, D>(sO, dout, p.o_ss, q0, p.Sq, tid);

  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    const bool in = qp < p.Sq;
    lse_i[i] = in ? p.lse[row0 + qp] : 0.f;
    delta_i[i] = in ? p.delta[row0 + qp] : 0.f;
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
    __syncthreads();  // the previous tile's sK, sV, sS, sI reads are done
    load_intervals(sI, idx, p.ncol, k0, p.Sk, tid);
    if (tile_hidden(p, sI, k0, q0, tid)) continue;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float pij =
            allowed(p, sI + 4 * c, qp, k0 + c) ? expf(s[i][j] * p.scale - lse_i[i]) : 0.f;
        sS[(ty * 4 + i) * PS + c] = pij * (dp[i][j] - delta_i[i]);
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

enum Pass { kFwd, kDq };

template <typename Kernel>
cudaError_t start(Kernel kernel, dim3 grid, int smem, const Params& p, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, Pass kPass>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 q_grid((p.Sq + kBlockQ - 1) / kBlockQ, p.H, p.B);
  if constexpr (kPass == kFwd) {
    return start(flashmask_fwd_kernel<T, D>, q_grid, fwd_smem_bytes<D>(), p, stream);
  } else {
    return start(flashmask_dq_kernel<T, D>, q_grid, dq_smem_bytes<D>(), p, stream);
  }
}

template <typename T, Pass kPass>
cudaError_t launch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16, kPass>(p, stream);
    case 32: return launch<T, 32, kPass>(p, stream);
    case 64: return launch<T, 64, kPass>(p, stream);
    case 128: return launch<T, 128, kPass>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <Pass kPass>
int run(Params& p, int dtype, int D, void* stream) {
  if (p.B < 1 || p.Sq < 1 || p.Sk < 1 || p.H < 1 || (p.Hm != 1 && p.Hm != p.H) ||
      (p.ncol != 1 && p.ncol != 2 && p.ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the bfloat16 kernels are paddle_flashmask_fwd_sm90 and
  // paddle_flashmask_bwd_dq_sm90 (flashmask_*_sm90.cu)
  if (dtype == 0) return static_cast<int>(launch_d<float, kPass>(p, D, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype must be 0 (float32: the bfloat16 forward is paddle_flashmask_fwd_
// sm90). Strides are in elements. idx is the
// contiguous [B, Hm, Sk, ncol] int32 tensor of start/end rows (Hm in {1, H},
// ncol in {1, 2, 4}). o is a contiguous [B, Sq, H, D] tensor in the input
// dtype, lse a contiguous [B, H, 1, Sq] f32 tensor. Returns the cudaError_t
// of the launch (0 on success).
extern "C" int paddle_flashmask_fwd(const void* q, const void* k, const void* v, const void* idx,
                                    void* o, void* lse, int dtype, int B, int Sq, int Sk, int H,
                                    int D, int Hm, int ncol, long long q_sb, long long q_ss,
                                    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                                    long long v_sb, long long v_ss, long long v_sh, int causal,
                                    float scale, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.idx = static_cast<const int*>(idx);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hm = Hm;
  p.ncol = ncol;
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
  return run<kFwd>(p, dtype, D, stream);
}

// The backward entry point takes the arguments of
// paddle_flashmask_bwd_dkv_tf32 (flashmask_dkv_tf32.cu) but its tiles:
// dtype 0 (float32), the strides of q, k, v, then dO; lse and delta
// contiguous [B, H, 1, Sq] f32; dq a contiguous [B, Sq, H, D] f32 tensor
// (dk and dv are not touched); idx as for the forward. Returns the
// cudaError_t of its launch.
extern "C" int paddle_flashmask_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       const void* idx, void* dq, void* dk, void* dv, int dtype,
                                       int B, int Sq, int Sk, int H, int D, int Hm, int ncol,
                                       long long q_sb, long long q_ss, long long q_sh,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       long long o_sb, long long o_ss, long long o_sh, int causal,
                                       float scale, void* stream) {
  (void)dk;
  (void)dv;
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.idx = static_cast<const int*>(idx);
  p.dq = dq;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.Hm = Hm;
  p.ncol = ncol;
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
  return run<kDq>(p, dtype, D, stream);
}
