// FlashMask dK/dV pass on Hopper's tensor cores (sm_90a) in 3xTF32: K7 for
// float32 inputs. bfloat16 runs on flashmask_dkv_sm90.cu.
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_bwd_dkv_kernel (:145,
// launched by _fm_bwd, :251, call :286): dV = sum_q P^T . dO and
// dK = scale * sum_q dS^T . Q, with P = exp(q.k^T * scale - lse)
// recomputed per tile from the forward's row logsumexp and set to 0 where
// the column-interval mask hides the pair (flashmask_sm90_common.cuh),
// dP = dO . V^T and dS = P o (dP - Delta), Delta = rowsum(dO o O) computed
// by the wrapper in f32 as [B, H, 1, Sq]. It keeps the bf16 K7's contract:
//   - layout [B, S, H, D] through TMA tensor maps over per-tensor strides
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden pairs get P SELECTED to 0 (a row that sees no key has
//     lse = -1e30 + log(1e-30), where 2^(s - lse) is inf), so they add
//     nothing to dK or dV;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D)
//     with zeros, and the pairs there are masked; keys no query sees get
//     dK = dV = 0, written;
//   - dk, dv contiguous [B, Sk, H, D] in f32, each element written by one
//     thread (no atomics); no dropout (the Pallas kernel has none).
//
// Design: the block of dkv_tf32.cuh (128-key blocks, a warpgroup per 64
// keys, and 32-row q tiles at D <= 64; 64-key blocks whose two warpgroups
// split D, and 16-row q tiles at D = 128), 3xTF32 throughout, walking a
// list of the q tiles the mask leaves live, as the bf16 K7 does. Before the
// loop each thread takes one of the block's key columns, reads its
// intervals once and votes on every q tile from the causal first one (a
// ballot per warp, as the tile is warp-uniform); one warp compacts the
// live tiles, in order, into a list (flashmask_sm90_common.cuh), written
// over the flags it reads. The loads and the products walk that list. The
// list takes 4 bytes a q tile beside the block's 208 KB, room for 4470
// tiles at D <= 64 and 4534 at D = 128; a block with more q tiles votes,
// lists and walks them in rounds of that many, the ring going on across
// rounds. In S^T the keys sit on the accumulator's rows, so each thread
// keeps its two keys' intervals in registers for the whole block, and
// tests its elements against them, at their true q index, only in a
// partial tile (one where some column's interval meets the tile's rows);
// the ragged edge and the causal diagonal only in a tile that meets them.
// The heads vary fastest in the grid.
//
// Bound on an H100 SXM (495 TFLOP/s TF32 dense, so 165 TFLOP/s for three
// products; 3.35 TB/s HBM), counted over the (q, k) pairs the mask allows,
// N: four products, 8 D N flops a head, against q, k, v, dO, dk, dv, lse,
// Delta and the indices read or written once. At the FlashMask path of
// chip_smoke.py (B=1, S=8192, 32 heads, D=128, causal documents, 10.5M
// allowed pairs a head) that is 343.5 GFLOP, 2.08 ms, against 0.20 ms of
// bytes: bound by operations. A block computes a whole q tile wherever one
// of its keys is seen from it; what the design leaves on the table is
// dkv_tf32.cuh's.

#include "dkv_tf32.cuh"
#include "flashmask_sm90_common.cuh"

namespace {

using namespace dkv32;
using namespace fm90;
using namespace sm90;

struct Params {
  const int* idx;      // [B, Hm, Sk, ncol]
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  float* dk;
  float* dv;
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int round;  // q tiles a block votes on, lists and walks at a time
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// the block's shared memory: the Layout, then the live-tile count, then a
// flag, later a list entry, for each q tile of a round
template <int DP>
int smem_bytes(int round) {
  return Layout<DP>::kBytes + 16 + 4 * round;
}

template <int DP>
__global__ void __launch_bounds__(Layout<DP>::kThreads, 1)
    flashmask_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = Layout<DP>;
  constexpr int kN = L::kN;
  constexpr int kM = L::kM;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem[];
  uint8_t* const sm = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  int* const n_live = reinterpret_cast<int*>(sm + L::kEnd);
  int* const list = n_live + 4;  // flags (bit 0: live, bit 1: partial), then the list

  const int h = blockIdx.x;
  const int k0 = blockIdx.y * kM;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + kN - 1) / kN;
  // top-left causal: the first q tile with a row at or below the first key
  const int qt0 = p.causal ? min(k0 / kN, n_qt) : 0;
  const int n_it = n_qt - qt0;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
  const int* idx = p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;

  if (tid == 0) init_barriers<DP>(base);

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + wg_key<DP>(wg);          // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);
  // this thread's keys' hidden rows, for the whole block
  const int4 kiv[2] = {column(idx, p.ncol, key0, p.Sk), column(idx, p.ncol, key0 + 8, p.Sk)};

  // dK and dV of this warpgroup's 64 keys x 64 columns, and a tile's sum
  float dk[32], dv[32], tmp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = tmp[i] = 0.f;

  // list entries walked in earlier rounds: where the ring stands
  int done = 0;
  bool kv_ready = false;
  for (int r0 = 0; r0 < n_it; r0 += p.round) {
    const int n_r = min(p.round, n_it - r0);
    for (int t = tid; t < n_r; t += L::kThreads) list[t] = 0;
    __syncthreads();

    // the live and partial q tiles: thread tid votes for key column
    // k0 + tid % kM on the round's tiles tid / kM, stepping by
    // kThreads / kM (the tile is warp-uniform, so the vote is a ballot)
    {
      const int kp = k0 + tid % kM;
      const int4 iv = column(idx, p.ncol, kp, p.Sk);
      for (int t = tid / kM; t < n_r; t += L::kThreads / kM) {
        const int q0 = (qt0 + r0 + t) * kN;
        const int q_last = min(q0 + kN, p.Sq) - 1;
        const bool live = kp < p.Sk && first_allowed(iv, kp, q0, p.causal) <= q_last;
        const unsigned lv = __ballot_sync(0xffffffffu, live);
        const unsigned pt = __ballot_sync(0xffffffffu, meets(iv, q0, q_last));
        if (tid % 32 == 0 && (lv | pt)) atomicOr(&list[t], (lv ? 1 : 0) | (pt ? 2 : 0));
      }
    }
    __syncthreads();
    // in place: each round of the warp reads its 32 flags before it writes
    // list entries, which land at or before them
    if (tid < 32) compact_live(list, n_r, qt0 + r0, list, n_live, p.tiles, tid);
    __syncthreads();
    const int nl = *n_live;

    // list entry t into stage (done + t) % kStages
    auto load = [&](int t) {
      load_qdo<DP>(base, &tq, &tdo, p.lse, p.delta, rows, p.Sq, (list[t] & kTile) * kN, h, b,
                   (done + t) % kStages, tid);
    };
    if (tid < 32 && nl > 0) {
      if (tid == 0 && !kv_ready) load_kv<DP>(base, &tk, &tv, k0, h, b);
      for (int t = 0; t < min(kStages, nl); ++t) load(t);
    }
    if (nl > 0 && !kv_ready) {
      mbar_wait(base + L::kBar, 0);
      split_kv<DP>(sm, tid);
      kv_ready = true;
    }
    for (int j = 0; j < nl; ++j) {
      const int s = (done + j) % kStages;
      const int entry = list[j];
      const int q0 = (entry & kTile) * kN;
      const bool partial = entry & kPartial;
      mbar_wait(bar_full<DP>(base, s), ((done + j) / kStages) & 1);
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
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      exchange_sdp<DP>(sc, dp, sm, wg, tid % 128);

      // P^T in place of S^T, dS^T in place of dP^T; P selected to 0 where
      // hidden
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
            if ((edge && (qp >= p.Sq || (p.causal && qp < key0 + 8 * hh))) ||
                (partial && hidden(kiv[hh], qp)))
              pj = 0.f;
            sc[x] = pj;
            dp[x] = pj * (dp[x] - (e ? dl.y : dl.x));
          }
        }
      }
      add_products<DP>(dv, dk, tmp, sc, dp, base, wg);
      __syncthreads();  // the stage and the split set are free
      if (tid < 32 && j + kStages < nl) load(j + kStages);
    }
    done += nl;
  }
  store_dkv(p.dk, p.dv, dk, dv, b, h, key0, wg_col<DP>(wg) + col0, p.Sk, p.H, p.D, p.scale);
}

template <int DP>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  using L = Layout<DP>;
  const int smem = smem_bytes<DP>(p.round);
  cudaError_t err = cudaFuncSetAttribute(flashmask_dkv_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.H, (p.Sk + L::kM - 1) / L::kM, p.B);
  flashmask_dkv_tf32_kernel<DP>
      <<<grid, L::kThreads, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of paddle_flashmask_bwd_dkv_sm90 (flashmask_dkv_sm90.cu),
// tiles included; dq is not touched. dtype must be 0 (float32), D one of
// 16, 32, 64, 128, and every stride of q, k, v, dO a multiple of 4 elements
// with a 16-byte aligned base (TMA). dk and dv are contiguous [B, Sk, H, D]
// f32 tensors. Returns the cudaError_t of the launch (0 on success), or
// sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flashmask_bwd_dkv_tf32(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* idx, void* dq, void* dk, void* dv, void* tiles, int dtype,
    int B, int Sq, int Sk, int H, int D, int Hm, int ncol, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    float scale, void* stream) {
  (void)dq;
  if (dtype != 0 || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kn = D <= 64 ? Layout<64>::kN : Layout<128>::kN;
  const int km = D <= 64 ? Layout<64>::kM : Layout<128>::kM;
  CUtensorMap maps[4];
  if (!encode_bshd_f32(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kn) ||
      !encode_bshd_f32(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, km) ||
      !encode_bshd_f32(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, km) ||
      !encode_bshd_f32(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, kn))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.tiles = static_cast<int*>(tiles);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.D = D;
  p.Hm = Hm;
  p.ncol = ncol;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  // as many q tiles a round as the list has room for (232448 bytes a block)
  const int fixed = D <= 64 ? smem_bytes<64>(0) : smem_bytes<128>(0);
  p.round = min((Sq + kn - 1) / kn, (232448 - fixed) / 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = D <= 64 ? launch<64>(maps, p, s) : launch<128>(maps, p, s);
  return static_cast<int>(err);
}
