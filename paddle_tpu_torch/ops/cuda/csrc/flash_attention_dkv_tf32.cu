// Flash-attention dK/dV pass on Hopper's tensor cores (sm_90a) in 3xTF32: K3
// for float32 inputs. bfloat16 runs on flash_attention_dkv_sm90.cu.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_bwd_dkv_kernel (:189,
// launched by _flash_bwd, :310, call :347): dV = sum_q (P o keep/(1-p))^T .
// dO and dK = scale * sum_q dS^T . Q, with P = exp(q.k^T * scale - lse)
// recomputed per tile from the forward's row logsumexp, dP' = dO . V^T
// (times keep/(1-p) under dropout) and dS = P o (dP' - Delta),
// Delta = rowsum(dO o O) computed by the wrapper in f32 as [B, H, 1, Sq]. It
// keeps the bf16 K3's contract: layout [B, S, H, D] through TMA tensor maps
// over per-tensor strides (a 16-byte aligned base and strides that are
// multiples of 16 bytes, which the wrapper guarantees by copying any other
// input), so GPT's packed-qkv slices are read in place; any Sq and Sk,
// out-of-range rows and columns with P = 0 exactly; top-left causal, a
// block starting at the first q tile that meets its diagonal; keys no query
// sees get dK = dV = 0, written; dropout replaying the forward's mask (the
// Pallas _dropout_mask hash over the PALLAS tiles, at each element's true
// (q, k) position, flash_attention_common.cuh); dk, dv contiguous
// [B, Sk, H, D] in f32, each element written by one thread (no atomics).
//
// Design: the block of dkv_tf32.cuh (128-key blocks, a warpgroup per 64
// keys, and 32-row q tiles at D <= 64; 64-key blocks whose two warpgroups
// split D, and 16-row q tiles at D = 128), 3xTF32 throughout. The heads
// vary fastest in the grid, and causal key block 0 sees the most q tiles,
// so every head's heaviest block is launched before any lighter one. Under
// dropout each tile's keep bits are hashed while S^T and dP^T are on the
// tensor cores, each element at its true q index.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM): at the GPT-2-small training shape B=8, S=1024,
// H=12, D=64, causal, four products over the 525k kept (q, k) pairs of each
// of 96 heads are 25.8 GFLOP, 0.156 ms; q, k, v, dO, dk, dv, lse and Delta
// move 152 MB, 0.045 ms: bound by operations. At B=1, S=512, H=32, D=128:
// 4.30 GFLOP, 0.026 ms. What this design leaves on the table: the split
// and transposes of every Q/dO tile by every block that reads it, three
// barriers a tile, the split not overlapping the products (one split set
// fits), and at D = 128 a single warpgroup on an SM and m64n16 products.

#include "dkv_tf32.cuh"
#include "flash_attention_common.cuh"

namespace {

using namespace dkv32;
using namespace paddle_fa;
using namespace sm90;

struct Params {
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  float* dk;
  float* dv;
  int B, Sq, Sk, H, D;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  DropoutArgs drop;
};

template <int DP, bool kDropout>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
    dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                    const Params p) {
  using L = Layout<DP>;
  constexpr int kN = L::kN;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  uint8_t* const sm = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * L::kM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + kN - 1) / kN;
  // top-left causal: the first q tile with a row at or below the first key
  const int qt0 = p.causal ? min(k0 / kN, n_qt) : 0;
  const int n_it = n_qt - qt0;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;

  if (tid == 0) init_barriers<DP>(base);
  __syncthreads();
  auto load = [&](int t) {
    load_qdo<DP>(base, &tq, &tdo, p.lse, p.delta, rows, p.Sq, (qt0 + t) * kN, h, b, t % kStages,
                 tid);
  };
  if (tid < 32 && n_it > 0) {
    if (tid == 0) load_kv<DP>(base, &tk, &tv, k0, h, b);
    for (int t = 0; t < min(kStages, n_it); ++t) load(t);
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + wg_key<DP>(wg);          // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);

  // dropout: each key's Pallas k tile and its column inside it
  uint32_t head = 0u;
  int ik[2] = {0, 0}, cin[2] = {0, 0};
  if constexpr (kDropout) {
    head = head_key(static_cast<uint32_t>(*p.drop.seed), b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kp = key0 + 8 * hh;
      ik[hh] = kp / p.drop.block_k;
      cin[hh] = kp - ik[hh] * p.drop.block_k;
    }
  }

  // dK and dV of this warpgroup's 64 keys x 64 columns, and a tile's sum
  float dk[32], dv[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = tmp[i] = 0.f;

  if (n_it > 0) {
    mbar_wait(base + L::kBar, 0);
    split_kv<DP>(sm, tid);
    for (int j = 0; j < n_it; ++j) {
      const int s = j % kStages;
      const int q0 = (qt0 + j) * kN;
      mbar_wait(bar_full<DP>(base, s), (j / kStages) & 1);
      split_qdo<DP>(sm + L::kStage + s * 2 * L::kQ, sm + L::kSet, tid);
      fence_proxy_async();
      __syncthreads();

      float sc[kN / 2], dp[kN / 2];
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) sc[i] = dp[i] = 0.f;
      fence_operand(sc);
      fence_operand(dp);
      wgmma_fence();
      issue_sdp<DP>(sc, dp, base, wg, s);
      // dropout: this tile's keep bits (bit 4i + 2hh + e of keep, as sc's
      // index), hashed at each element's true q while the products run
      uint32_t keep = 0u;
      if constexpr (kDropout) {
#pragma unroll
        for (int i = 0; i < kN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qp = q0 + 8 * i + col0 + e;
            const int iq = qp / p.drop.block_q;
            const uint32_t rkey = row_key(head, iq);
            const int rin = qp - iq * p.drop.block_q;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
              if (keep_bit(rkey, ik[hh], rin, cin[hh], p.drop.thresh))
                keep |= 1u << (4 * i + 2 * hh + e);
          }
      }
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      exchange_sdp<DP>(sc, dp, sm, wg, tid % 128);

      // P^T (dropped and rescaled) in place of S^T, dS^T in place of dP^T;
      // P is masked only in a tile that meets the ragged edge or the causal
      // diagonal
      const float* st = reinterpret_cast<const float*>(sm + L::kRows) + s * 2 * kN;
      const bool edge = q0 + kN > p.Sq || (p.causal && q0 < kw0 + 63);
#pragma unroll
      for (int i = 0; i < kN / 8; ++i) {
        const float2 lse2 = *reinterpret_cast<const float2*>(st + 8 * i + col0);
        const float2 dl = *reinterpret_cast<const float2*>(st + kN + 8 * i + col0);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qp = q0 + 8 * i + col0 + e;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * i + 2 * hh + e;
            float pj = ex2(fmaf(sc[x], p.scale_log2, -(e ? lse2.y : lse2.x) * kLog2e));
            if (edge && (qp >= p.Sq || (p.causal && qp < key0 + 8 * hh))) pj = 0.f;
            float pv = pj, dpj = dp[x];
            if constexpr (kDropout) {
              const bool kept = (keep >> x) & 1u;
              pv = kept ? pj / p.drop.keep_prob : 0.f;
              dpj = kept ? dpj / p.drop.keep_prob : 0.f;
            }
            sc[x] = pv;
            dp[x] = pj * (dpj - (e ? dl.y : dl.x));
          }
        }
      }
      add_products<DP>(dv, dk, tmp, sc, dp, base, wg);
      __syncthreads();  // stage s and the split set are free
      if (tid < 32 && j + kStages < n_it) load(j + kStages);
    }
  }
  store_dkv(p.dk, p.dv, dk, dv, b, h, key0, wg_col<DP>(wg) + col0, p.Sk, p.H, p.D, p.scale);
}

template <int DP, bool kDropout>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  using L = Layout<DP>;
  cudaError_t err = cudaFuncSetAttribute(dkv_tf32_kernel<DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sk + L::kM - 1) / L::kM, p.B);
  dkv_tf32_kernel<DP, kDropout>
      <<<grid, L::kThreads, L::kBytes, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_d(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch<64, kDropout>(maps, p, stream) : launch<128, kDropout>(maps, p, stream);
}

}  // namespace

// The backward passes' arguments, shared by the K2 and K3 entry points of
// both types (this one, paddle_flash_attention_bwd_dkv_sm90,
// paddle_flash_attention_bwd_dq_tf32 and _sm90): q, k, v, dO [B, S, H, D]
// with their batch, seq and head strides in elements (q, k, v, then dO);
// lse and delta contiguous [B, H, 1, Sq] f32; dq a contiguous
// [B, Sq, H, D] and dk, dv contiguous [B, Sk, H, D] tensors in the input
// dtype, each pass writing its own; seed a (1,) int32 device tensor, read
// only when dropout_on; keep_prob, thresh, block_q and block_k describe the
// forward's mask. Here dq is not touched, dtype must be 0 (float32), D one
// of 16, 32, 64, 128, and every stride of q, k, v, dO a multiple of 4
// elements with a 16-byte aligned base (TMA). Returns the cudaError_t of
// the launch (0 on success), or sm90::kErrTensorMap when a tensor map
// cannot be encoded.
extern "C" int paddle_flash_attention_bwd_dkv_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* seed, void* dq, void* dk, void* dv, int dtype, int B, int Sq,
    int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, float scale, int dropout_on,
    float keep_prob, uint32_t thresh, int block_q, int block_k, void* stream) {
  (void)dq;
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_q < 1 || block_k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int kn = D <= 64 ? Layout<64>::kN : Layout<128>::kN;
  const int km = D <= 64 ? Layout<64>::kM : Layout<128>::kM;
  CUtensorMap maps[4];
  if (!encode_bshd_f32(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kn) ||
      !encode_bshd_f32(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, km) ||
      !encode_bshd_f32(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, km) ||
      !encode_bshd_f32(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, kn))
    return kErrTensorMap;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.drop.seed = static_cast<const int*>(seed);
  p.drop.on = dropout_on;
  p.drop.keep_prob = keep_prob;
  p.drop.thresh = thresh;
  p.drop.block_q = block_q;
  p.drop.block_k = block_k;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dropout_on ? launch_d<true>(maps, p, s) : launch_d<false>(maps, p, s);
  return static_cast<int>(err);
}
