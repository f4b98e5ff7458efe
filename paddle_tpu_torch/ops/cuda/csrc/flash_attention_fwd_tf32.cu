// Flash-attention forward on Hopper's tensor cores (sm_90a) in 3xTF32: K1
// for float32 inputs, the serving prefill kernel. bfloat16 runs on
// flash_attention_fwd_sm90.cu.
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py::_fwd_kernel (:85,
// launched by _flash_fwd, :266), computing what it computes:
//   - layout [B, S, H, D] read through batch/seq/head strides, so q/k/v may
//     be the strided slices of a packed qkv [B, S, H, 3, D]; here through TMA
//     tensor maps, which need a 16-byte aligned base and strides that are
//     multiples of 16 bytes (the wrapper copies any other input);
//   - causal is top-left, q_pos >= k_pos; k tiles wholly above a block's
//     diagonal are not loaded, masked probabilities are exactly 0;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D)
//     with zeros, and the scores there are masked;
//   - dropout inside the kernel by the Pallas _dropout_mask hash at each
//     element's global position over the PALLAS tiles
//     (flash_attention_common.cuh): l sums the undropped probabilities,
//     O accumulates p * keep / (1 - p_drop);
//   - O in f32 [B, Sq, H, D], lse = m + log(max(l, 1e-30)) f32 [B, H, 1, Sq];
//   - tile sizes and the k-tile order depend on D alone, never on S, and a
//     fully masked tile leaves a row's state unchanged (alpha = 1, p = 0),
//     so a real row r sees exactly the columns <= r in the same order
//     whatever the batch's padding: the greedy serving path's batch
//     invariance rests on this.
//
// Arithmetic. Every product a.b runs on the tensor cores as three TF32
// products, a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, with hi = tf32(x) and
// lo = tf32(x - hi) (sm90_tf32.cuh), summed in f32: S = Q.K^T to about
// 2^-21 of |q||k|, where one TF32 product would keep 2^-11, outside the
// f32 path's 1e-4 gate. P is split in registers after the online softmax
// (exp2, as the bf16 K1), and O accumulates in f32.
//
// Design. One block per (128-row q tile, head, batch); the heads vary
// fastest in the grid, so every head's heaviest causal tile is launched
// before any lighter one, which balances the SMs' load better than
// heaviest first within each head alone; 256 threads, two warpgroups of
// 64 q rows, no producer warp
// (ptxas holds a block of 288 threads to 168 registers a thread). Thread 0
// brings Q in once and the K/V tiles through a ring of kStages stages by
// TMA (sm90_common.cuh), issuing tile j + kStages once tile j is done. Q is
// split into hi and lo tiles once. Per K/V tile:
//   1. all 256 threads split the tile: K's hi in place and K's lo over the
//      stage's V tile (each thread reads the V elements it overwrites), V
//      written transposed in hi and lo parts into a V^T set outside the
//      ring, since TF32 wgmma takes K-major operands only and V is the B
//      operand of P.V; fence.proxy.async and a barrier hand the tiles to
//      wgmma;
//   2. each warpgroup computes S = Q.K^T with wgmma (m64nNk8, SS); under
//      dropout the tile's keep bits are hashed while the products run;
//   3. runs the online softmax on the accumulator registers as the bf16 K1
//      does: the row max over a quad by two shuffles, then one FFMA and one
//      ex2 a score, dropout's rescale of the kept ones;
//   4. splits P (times keep / (1 - p)) into hi and lo A registers, which
//      are the accumulator's registers as they stand because V^T stores its
//      keys in the matching order (sm90_tf32.cuh), rescales O and adds P.V
//      with wgmma (m64nDk8, RS).
// With two V^T sets (D <= 64), step 1 of tile j + 1 runs while step 4's
// products of tile j are on the tensor cores, and one barrier a tile hands
// over both; with one set (D = 128) it waits for them. O is written from
// registers. D = 16 and 32 run as D = 64 with zero columns.
//
// Shared memory (227 KB a block). D <= 64: 64-key tiles; Q hi + lo 64 KB,
// three stages of K + V 96 KB, two V^T sets of hi + lo 64 KB: 224 KB.
// D = 128 would need more than double that, so it takes 32-key tiles and
// one V^T set: Q hi + lo 128 KB, two stages of K + V 64 KB, V^T hi + lo
// 32 KB: 224 KB.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM): at the GPT-2-small training shape B=8, S=1024,
// H=12, D=64, causal, two products over the 525k kept (q, k) pairs of each
// of the 96 heads are 12.9 GFLOP, 0.078 ms; q, k, v, o and lse move 101 MB
// in f32, 0.030 ms: bound by operations. At the serving prefill shape B=1,
// S=1024: 1.61 GFLOP, 0.0098 ms. What this design leaves on the table: the
// split of every K/V tile by every block that reads it, a barrier a tile
// that stops both warpgroups together, and the exp2 of every score; one
// block runs on an SM.

#include "flash_attention_common.cuh"
#include "sm90_tf32.cuh"

namespace {

using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // q rows per block: two warpgroups of 64
constexpr int kThreadsTC = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  float* o;
  float* lse;
  int B, Sq, Sk, H, D;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
  DropoutArgs drop;
};

// shared memory in bytes from a 1024-byte aligned base: Q hi, Q lo, then
// kStages stages of a K tile and a V tile (K's lo once V is transposed),
// then kSets sets of V^T hi and lo, then the mbarriers (Q, kStages full)
template <int DP>
struct Layout {
  static constexpr int kN = DP <= 64 ? 64 : 32;  // keys per K/V tile
  static constexpr int kStages = DP <= 64 ? 3 : 2;  // K/V tiles in flight
  static constexpr int kSets = DP <= 64 ? 2 : 1;    // V^T tiles
  static constexpr int kBoxes = DP / 32;         // 32-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kTBox = DP * 128;  // 32 keys of V^T
  static constexpr int kT = (kN / 32) * kTBox;
  static constexpr int kStage = 2 * kQ;  // stage s at kStage + 2 s kKV
  static constexpr int kVt = kStage + kStages * 2 * kKV;
  static constexpr int kBar = kVt + kSets * 2 * kT;
  static constexpr int kBytes = kBar + 8 * (1 + kStages) + 1024;  // + alignment slack
};

// Step 1 of the note: the K tile at k becomes K's hi, the V tile at v K's
// lo; V goes transposed into vt_hi and vt_lo. A unit is 8 keys x 2 columns.
template <int DP>
__device__ __forceinline__ void split_kv(uint8_t* k, uint8_t* v, uint8_t* vt_hi, uint8_t* vt_lo,
                                         int tid) {
  constexpr int kN = Layout<DP>::kN;
  constexpr int kUnits = (kN / 8) * (DP / 2);
  for (int u = tid; u < kUnits; u += kThreadsTC) {
    const int g = u / (DP / 2), n0 = 2 * (u % (DP / 2));
    float2 vv[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t off = tile_offset(8 * g + r, n0, kN);
      const float2 kx = *reinterpret_cast<const float2*>(k + off);
      vv[r] = *reinterpret_cast<const float2*>(v + off);
      store_split2(k, v, off, kx);
    }
    store_transposed(vt_hi, vt_lo, g, n0, vv, DP);
  }
}

template <int DP, bool kDropout>
__global__ void __launch_bounds__(kThreadsTC, 1)
    fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Layout<DP>;
  constexpr int kN = L::kN;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  uint8_t* const sm = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;

  // heads vary fastest, so every head's heaviest causal tile runs first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);

  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const uint32_t full = bar_full + 8 * s;
    const uint32_t kb = base + L::kStage + s * 2 * L::kKV;
    mbar_arrive_expect_tx(full, 2 * L::kKV);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load_4d(kb + c * L::kKVBox, &tk, full, 32 * c, h, j * kN, b);
      tma_load_4d(kb + L::kKV + c * L::kKVBox, &tv, full, 32 * c, h, j * kN, b);
    }
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_full + 8 * s, 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(bar_q, L::kQ);
    for (int c = 0; c < L::kBoxes; ++c)
      tma_load_4d(base + c * L::kQBox, &tq, bar_q, 32 * c, h, q0, b);
    for (int j = 0; j < min(kStages, n_kt); ++j) load_kv(j);
  }
  __syncthreads();

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

  // step 1 of the note for tile j, into its stage and V^T set
  auto split_tile = [&](int j) {
    const int kb_off = L::kStage + (j % kStages) * 2 * L::kKV;
    const int vt_off = L::kVt + (j % L::kSets) * 2 * L::kT;
    mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);
    split_kv<DP>(sm + kb_off, sm + kb_off + L::kKV, sm + vt_off, sm + vt_off + L::kT, tid);
  };
  mbar_wait(bar_q, 0);
  split_in_place(sm, sm + L::kQ, L::kQ, tid, kThreadsTC);
  split_tile(0);
  fence_proxy_async();
  __syncthreads();
  const uint32_t q_hi = base + wg * 64 * 128;  // this warpgroup's 64 rows of Q
  const uint32_t q_lo = q_hi + L::kQ;

  constexpr int kO = DP / 2;  // O accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;
  // running max of the raw scores (-inf until a row sees a key) and this
  // thread's part of the row sum
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  for (int j = 0; j < n_kt; ++j) {
    const int k0 = j * kN;
    const uint32_t k_hi = base + L::kStage + (j % kStages) * 2 * L::kKV, k_lo = k_hi + L::kKV;
    const uint32_t vt_hi = base + L::kVt + (j % L::kSets) * 2 * L::kT, vt_lo = vt_hi + L::kT;
    float sc[kN / 2];
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) sc[i] = 0.f;
    fence_operand(sc);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part) {  // Q_lo.K_hi, Q_hi.K_lo, Q_hi.K_hi
      const uint32_t qa = part == 0 ? q_lo : q_hi;
      const uint32_t kt = part == 1 ? k_lo : k_hi;
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk)
        wgmma_tf32_ss(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                      desc_sw128(kt + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024),
                      part > 0 || kk > 0);
    }
    wgmma_commit();
    // dropout: this tile's keep bits (bit 4i + 2hh + e of keep, as sc's
    // index), hashed while S is on the tensor cores
    uint32_t keep = 0u;
    if constexpr (kDropout) {
#pragma unroll
      for (int i = 0; i < kN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kp = k0 + 8 * i + col0 + e;
          const int ik = kp / p.drop.block_k;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (keep_bit(rkey[hh], ik, rin[hh], kp - ik * p.drop.block_k, p.drop.thresh))
              keep |= 1u << (4 * i + 2 * hh + e);
        }
    }
    wgmma_wait<0>();
    fence_operand(sc);
    // mask the ragged edge and the causal diagonal (only a tile that meets
    // them), row max
    const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < kN / 8; ++i)
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
    for (int i = 0; i < kN / 8; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * i + 2 * hh + e;
          float& x = sc[idx];
          const float pj = ex2(fmaf(x, p.scale_log2, -mscaled[hh]));
          l[hh] += pj;
          if constexpr (kDropout)
            x = (keep >> idx) & 1u ? pj / p.drop.keep_prob : 0.f;
          else
            x = pj;
        }

    uint32_t pa_hi[kN / 8][4], pa_lo[kN / 8][4];
#pragma unroll
    for (int ks = 0; ks < kN / 8; ++ks) pack_a_tf32(pa_hi[ks], pa_lo[ks], sc, ks);
#pragma unroll
    for (int i = 0; i < kO; ++i) acc[i] *= alpha[(i >> 1) & 1];
    fence_operand(acc);
    wgmma_fence();
#pragma unroll
    for (int part = 0; part < 3; ++part)  // P_lo.V_hi, P_hi.V_lo, P_hi.V_hi
#pragma unroll
      for (int ks = 0; ks < kN / 8; ++ks)
        wgmma_tf32_rs(acc, part == 0 ? pa_lo[ks] : pa_hi[ks],
                      desc_sw128((part == 1 ? vt_lo : vt_hi) + (ks / 4) * L::kTBox + (ks % 4) * 32,
                                 16, 1024));
    wgmma_commit();
    const bool more = j + 1 < n_kt;
    if constexpr (L::kSets == 2) {
      // the next tile's split runs while P.V is on the tensor cores
      if (more) split_tile(j + 1);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_operand(acc);
    __syncthreads();  // tile j's stage and V^T set are free
    if (tid == 0 && j + kStages < n_kt) load_kv(j + kStages);
    if constexpr (L::kSets == 1) {
      if (more) {
        split_tile(j + 1);
        fence_proxy_async();
        __syncthreads();
      }
    }
  }

  float den[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) den[hh] = fmaxf(quad_sum(l[hh]), 1e-30f);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    float* orow = p.o + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[4 * i + 2 * hh] / den[hh], acc[4 * i + 2 * hh + 1] / den[hh]);
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
  cudaError_t err = cudaFuncSetAttribute(fwd_tf32_kernel<DP, kDropout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sq + kM - 1) / kM, p.B);
  fwd_tf32_kernel<DP, kDropout><<<grid, kThreadsTC, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

template <bool kDropout>
cudaError_t launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                     const Params& p, cudaStream_t stream) {
  return p.D <= 64 ? launch<64, kDropout>(tq, tk, tv, p, stream)
                   : launch<128, kDropout>(tq, tk, tv, p, stream);
}

}  // namespace

// The arguments of paddle_flash_attention_fwd_sm90; dtype must be 0
// (float32), D one of 16, 32, 64, 128, and every stride a multiple of 4
// elements with a 16-byte aligned base (TMA). o is a contiguous
// [B, Sq, H, D] f32 tensor, lse a contiguous [B, H, 1, Sq] f32 tensor.
// Returns the cudaError_t of the launch (0 on success), or
// sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flash_attention_fwd_tf32(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* seed, int dtype,
    int B, int Sq, int Sk, int H, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int causal, float scale, int dropout_on, float keep_prob, uint32_t thresh, int block_q,
    int block_k, void* stream) {
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dropout_on && (block_q < 1 || block_k < 1)) return static_cast<int>(cudaErrorInvalidValue);
  const int kn = D <= 64 ? Layout<64>::kN : Layout<128>::kN;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd_f32(&tq, q, B, Sq, H, D, q_sb, q_ss, q_sh, kM) ||
      !encode_bshd_f32(&tk, k, B, Sk, H, D, k_sb, k_ss, k_sh, kn) ||
      !encode_bshd_f32(&tv, v, B, Sk, H, D, v_sb, v_ss, v_sh, kn))
    return kErrTensorMap;
  Params p;
  p.o = static_cast<float*>(o);
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
