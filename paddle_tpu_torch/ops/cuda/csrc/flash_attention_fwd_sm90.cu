// Flash-attention forward on Hopper's tensor cores (sm_90a): K1 for bfloat16
// inputs. The float32 forward is flash_attention_fwd_tf32.cu (3xTF32).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:85,
// launched by _flash_fwd, :266). It keeps the f32 K1's contract:
//   - layout [B, S, H, D] read through batch/seq/head strides, so q/k/v may
//     be the strided slices of a packed qkv [B, S, H, 3, D]; here through TMA
//     tensor maps, which need a 16-byte aligned base and strides that are
//     multiples of 16 bytes (the wrapper copies any other input);
//   - causal is top-left, q_pos >= k_pos; k tiles wholly above a block's
//     diagonal are not loaded, masked probabilities are exactly 0;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D
//     when D < 64) with zeros, and the scores there are masked;
//   - dropout inside the kernel by the Pallas _dropout_mask hash at each
//     element's global position over the PALLAS tiles
//     (flash_attention_common.cuh): l sums the undropped probabilities,
//     O accumulates p * keep / (1 - p_drop);
//   - O in bf16 [B, Sq, H, D], lse = m + log(max(l, 1e-30)) f32 [B, H, 1, Sq];
//   - tile sizes and the k-tile order do not depend on S, and a fully
//     masked tile leaves a row's state unchanged (alpha = 1, p = 0), so a
//     causal row's result does not change by a bit when the batch is padded.
//
// Design. One block per (128-row q tile, head, batch), heaviest causal
// tiles first; 288 threads: two consumer warpgroups of 64 q rows each and
// one producer warp. The producer's elected thread brings the Q tile in
// once and the 64-row K and V tiles through a ring of kStages stages by TMA
// (sm90_common.cuh), each stage's arrival on a "full" mbarrier; the
// consumers release a stage on its "empty" mbarrier. Per K/V tile each
// consumer warpgroup
//   1. computes S = Q.K^T with wgmma (m64n64k16, Q and K K-major from shared
//      memory), bf16 in, f32 sums;
//   2. runs the online softmax on the accumulator registers: the row max
//      of the raw scores over a quad by two shuffles, then one FFMA and one
//      ex2 a score, p = 2^(s * scale * log2(e) - m * scale * log2(e));
//   3. rounds P (times keep / (1 - p) under dropout) to bf16 in registers,
//      which is the register A operand of the next product as it stands;
//   4. rescales O and adds P.V with wgmma (m64nDk16, V MN-major from shared
//      memory through the transpose bit).
// O is written from registers. D = 16 and 32 run as D = 64 with zero
// columns; D = 128 is two 64-column (128-byte) swizzle boxes.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor cores, 3.35 TB/s HBM):
// at the Llama training shape B=4, S=2048, H=12, D=64, causal, the two
// products over the 2.1M kept (q, k) pairs of each of the 48 heads are
// 25.8 GFLOP, 0.026 ms; q, k, v, o and lse move 50.7 MB, 0.015 ms: bound by
// operations. At the GPT-2-small training shape B=8, S=1024: 12.9 GFLOP,
// 0.013 ms, against the same 50.7 MB, 0.015 ms: bound by bytes, with
// operations close behind. The tensor cores and TMA are the way to either
// bound. What this design leaves on the table: the exp2 of every score, and
// the wait on each product inside a warpgroup, which other warpgroups fill:
// at D <= 64 without dropout two blocks share an SM, four warpgroups taking
// turns on the tensor cores. K2's order (the next tile's scores issued
// before this tile's softmax) measured slower here on an H100.

#include "flash_attention_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // q rows per block: two consumer warpgroups of 64
constexpr int kN = 64;   // keys per K/V tile
constexpr int kStages = 4;  // K/V tiles in flight: TMA runs up to 3 tiles ahead
constexpr int kConsumers = 256;
constexpr int kThreadsTC = kConsumers + 32;  // and one producer warp
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int B, Sq, Sk, H, D;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  DropoutArgs drop;
};

// shared memory in bytes from a 1024-byte aligned base: the Q tile, kStages
// K tiles, kStages V tiles, then the mbarriers (Q, kStages full, kStages
// empty)
template <int DP>
struct Layout {
  static constexpr int kBoxes = DP / 64;  // 64-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kK = kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

// Two blocks share an SM when a thread keeps to 96 registers: an SM
// sub-partition holds 16,384 registers and gets 5 of the two blocks' 18
// warps. D <= 64 without dropout fits there without spilling; the others
// would spill, and run one block per SM.
template <int DP, bool kDropout>
__global__ void __launch_bounds__(kThreadsTC, (DP <= 64 && !kDropout) ? 2 : 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t sq = base, sk = base + L::kK, sv = base + L::kV;
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp; one thread issues every load
    if (tid == kConsumers) {
      mbar_arrive_expect_tx(bar_q, L::kBoxes * L::kQBox);
      for (int c = 0; c < L::kBoxes; ++c)
        tma_load_4d(sq + c * L::kQBox, &tq, bar_q, 64 * c, h, q0, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
        const uint32_t full = bar_full + 8 * s;
        mbar_arrive_expect_tx(full, 2 * L::kKV);
        for (int c = 0; c < L::kBoxes; ++c) {
          tma_load_4d(sk + s * L::kKV + c * L::kKVBox, &tk, full, 64 * c, h, j * kN, b);
          tma_load_4d(sv + s * L::kKV + c * L::kKVBox, &tv, full, 64 * c, h, j * kN, b);
        }
      }
    }
    return;
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);

  // dropout: each row's key and its row inside its Pallas q tile
  uint32_t rkey[2] = {0u, 0u};
  int rin[2] = {0, 0};
  if constexpr (kDropout) {
    const uint32_t head = head_key(static_cast<uint32_t>(*p.drop.seed), b, h);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qp = row0 + 8 * hh;
      const int iq = qp / p.drop.block_q;
      rkey[hh] = row_key(head, iq);
      rin[hh] = qp - iq * p.drop.block_q;
    }
  }

  constexpr int kO = DP / 2;  // O accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // running max of the raw scores (-inf until a row sees a key) and this
  // thread's part of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 rows of Q

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % kStages;
    const int k0 = j * kN;
    const uint32_t kb = sk + s * L::kKV;
    const uint32_t vb = sv + s * L::kKV;
    mbar_wait(bar_full + 8 * s, (j / kStages) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_m64n64k16_ss(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                         desc_sw128(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(sc);

    // mask the ragged edge and the causal diagonal (only a tile that meets
    // them), row max
    const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * hh + e];
          if (edge) {
            const int kp = k0 + 8 * i + col0 + e;
            if (kp >= p.Sk || (p.causal && row0 + 8 * hh < kp)) x = -INFINITY;
          }
          mx[hh] = fmaxf(mx[hh], x);
        }
    // a tile that raises no row max leaves the row exactly as it was
    // (alpha = 1), so a wholly masked tile changes nothing
    float alpha[2], mscaled[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m_new = fmaxf(m[hh], quad_max(mx[hh]));
      alpha[hh] = m_new == m[hh] ? 1.f : ex2((m[hh] - m_new) * p.scale_log2);
      m[hh] = m_new;
      mscaled[hh] = m_new == -INFINITY ? 0.f : m_new * p.scale_log2;
      l[hh] *= alpha[hh];
    }

    // probabilities, exactly 0 where masked: l sums them undropped; P
    // (dropped and rescaled) in place
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * i + 2 * hh + e];
          const float pj = ex2(fmaf(x, p.scale_log2, -mscaled[hh]));
          l[hh] += pj;
          if constexpr (kDropout) {
            const int kp = k0 + 8 * i + col0 + e;
            const int ik = kp / p.drop.block_k;
            x = keep_bit(rkey[hh], ik, rin[hh], kp - ik * p.drop.block_k, p.drop.thresh)
                    ? pj / p.drop.keep_prob
                    : 0.f;
          } else {
            x = pj;
          }
        }

    uint32_t pa[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_a(pa[ks], sc, ks);
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs(acc, pa[ks], desc_sw128(vb + ks * 2048, L::kKVBox, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc);
    mbar_arrive(bar_empty + 8 * s);
  }

  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) den[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    __nv_bfloat16* orow = p.o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(acc[4 * i + 2 * hh] / den[hh], acc[4 * i + 2 * hh + 1] / den[hh]);
    }
    if (lane % 4 == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qp] =
          (m[hh] == -INFINITY ? kNegInf : m[hh] * p.scale) + logf(den[hh]);
  }
}

template <int DP, bool kDropout>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const Params& p, cudaStream_t stream) {
  constexpr int smem = Layout<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(fwd_sm90_kernel<DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kM - 1) / kM, p.H, p.B);
  fwd_sm90_kernel<DP, kDropout><<<grid, kThreadsTC, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                     const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch<64, kDropout>(tq, tk, tv, p, stream)
                   : launch<128, kDropout>(tq, tk, tv, p, stream);
}

}  // namespace

// The arguments of paddle_flash_attention_fwd_tf32
// (flash_attention_fwd_tf32.cu); dtype must be 1 (bfloat16), D one of 16,
// 32, 64, 128, and every stride a multiple of 8 elements with a 16-byte
// aligned base (TMA). Returns the cudaError_t of the launch (0 on success),
// or sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* seed, int dtype,
    int B, int Sq, int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, int dropout_on, float keep_prob, uint32_t thresh, int block_q,
    int block_k, void* stream) {
  if (dtype != 1 || (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dropout_on && (block_q < 1 || block_k < 1)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, kM) ||
      !encode_bshd(&tk, k, B, Sk, H, D, k_sb, k_ss, k_sh, kN) ||
      !encode_bshd(&tv, v, B, Sk, H, D, v_sb, v_ss, v_sh, kN))
    return kErrTensorMap;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
  const cudaError_t err = dropout_on ? launch_d<true>(tq, tk, tv, p, s)
                                     : launch_d<false>(tq, tk, tv, p, s);
  return static_cast<int>(err);
}
