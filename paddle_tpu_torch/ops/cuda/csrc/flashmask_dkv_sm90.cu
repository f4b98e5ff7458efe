// FlashMask dK/dV pass on Hopper's tensor cores (sm_90a): K7 for bfloat16
// and float16 inputs (one instantiation each over the element type T). The float32 dK/dV pass runs in 3xTF32
// (flashmask_dkv_tf32.cu).
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_bwd_dkv_kernel (:145,
// launched by _fm_bwd, :251, call :286): dV = sum_q P^T . dO and
// dK = scale * sum_q dS^T . Q, with P = exp(q.k^T * scale - lse)
// recomputed per tile from the forward's row logsumexp and set to 0 where
// the column-interval mask hides the pair (flashmask_sm90_common.cuh),
// dP = dO . V^T and dS = P o (dP - Delta), Delta = rowsum(dO o O) computed
// by the wrapper in f32 as [B, H, 1, Sq]. It keeps the f32 K7's contract:
//   - layout [B, S, H, D] through per-tensor strides, here TMA tensor maps
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden pairs get P SELECTED to 0 (a row that sees no key has
//     lse = -1e30 + log(1e-30), where 2^(s - lse) is inf), so they add
//     nothing to dK or dV;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D
//     when D < 64) with zeros, and the pairs there are masked; keys no
//     query sees get dK = dV = 0, written;
//   - dk, dv contiguous [B, Sk, H, D] in T, each element written by one
//     thread (no atomics, so results do not change from run to run); no
//     dropout (the Pallas kernel has none).
//
// Design: flash_attention_dkv_sm90.cu's block with a live list over the
// q tiles. One block per (128-key tile, head, batch); causal block 0 sees
// the most q tiles, so the natural order runs the heaviest first. Two
// warpgroups own 64 keys each. The mask runs along the other axis here: a
// 64-row q tile is live for the block where one of its 128 key columns
// lets one of the tile's rows through, and partial where one of their
// intervals meets the tile's rows. Before the loop each thread takes one
// of the block's columns, reads its intervals once and votes on every
// q tile from the causal first one (half the q tiles for each half of the
// threads); one warp compacts the live tiles into a list. K and V come in
// once; the listed 64-row Q and dO tiles stream through a ring of kStages
// stages by TMA, each with its rows' lse and Delta by cp.async, all landing
// on the stage's mbarrier (sm90_common.cuh). The first warp issues the
// loads kStages - 2 tiles ahead while its own products run (256 threads,
// no producer warp: ptxas holds a block of 288 threads to 168 registers a
// thread, and the accumulators alone take 128 at D = 64). In S^T the keys
// sit on the accumulator's rows, so each thread keeps its two keys'
// intervals in registers for the whole block, and the partial test reads
// no shared memory. Per listed Q/dO tile each warpgroup
//   1. computes S^T = K.Q^T and dP^T = V.dO^T with wgmma (m64n64k16, all
//      four operands K-major from shared memory);
//   2. forms P^T = 2^(S^T * scale * log2(e) - lse * log2(e)), selected to 0
//      where hidden, and dS^T = P^T o (dP^T - Delta) in the accumulator
//      registers, lse and Delta per column from the stage; a thread tests
//      its elements against its keys' intervals only in a partial tile, and
//      against the ragged edge and the causal diagonal only in a tile that
//      meets them;
//   3. adds P^T.dO to dV and dS^T.Q to dK with wgmma (m64nDk16), P^T and
//      dS^T as the register A operand in two T parts each, hi + lo (two
//      products each): rounded once they leave dK and dV less than 4x inside
//      the bf16 gate on FlashMask's layouts
//      (tests/test_torch_flashmask_bwd_tc_numerics.py), as in K3. dO and Q
//      are read MN-major through the transpose bit.
// dK is scaled once, and both are written from registers.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 or fp16 tensor cores, 3.35 TB/s HBM),
// counted over the (q, k) pairs the mask allows, N: four products, 8 D N
// flops a head, against q, k, v, dO, dk, dv, lse, Delta and the indices
// read or written once. At the FlashMask path of chip_smoke.py (B=1,
// S=8192, 32 heads, D=128, causal documents, 10.5M allowed pairs a head)
// that is 0.35 ms of operations against 0.10 ms of bytes: bound by
// operations. The split makes the four products six, and a block computes
// a 64-row q tile wherever one of its 128 keys is seen from it.

#include "flash_attention_common.cuh"
#include "flashmask_sm90_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fm90;
using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // keys per block: two warpgroups of 64
constexpr int kN = 64;   // q rows per Q/dO tile
constexpr int kThreadsTC = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const int* idx;      // [B, Hm, Sk, ncol]
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  void* dk;  // T
  void* dv;  // T
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// shared memory in bytes from a 1024-byte aligned base: the K and V tiles,
// kStages Q tiles, kStages dO tiles, kStages (lse, Delta) rows of
// 64 floats each, the mbarriers (K and V, kStages full, kStages empty),
// then the live-tile count, a flag and a list entry for each q tile
// (kFixed + 8 bytes a q tile in all). kFixed is 132 KB at D <= 64,
// 195 KB at D = 128
template <int DP>
struct Layout {
  static constexpr int kStages = DP <= 64 ? 6 : 4;
  static constexpr int kBoxes = DP / 64;  // 64-column boxes in a row
  static constexpr int kKBox = kM * 128;
  static constexpr int kQBox = kN * 128;
  static constexpr int kQ = kBoxes * kQBox;  // one Q (or dO) tile
  static constexpr int kV = kBoxes * kKBox;
  static constexpr int kQs = 2 * kBoxes * kKBox;
  static constexpr int kOs = kQs + kStages * kQ;
  static constexpr int kRows = kOs + kStages * kQ;
  static constexpr int kBar = kRows + kStages * 2 * kN * 4;
  static constexpr int kList = kBar + 8 * (1 + 2 * kStages) + 16;
  static constexpr int kFixed = kList + 16 + 1024;  // + alignment slack
  static int bytes(int n_qt) { return kFixed + 8 * n_qt; }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flashmask_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo, const Params p) {
  using L = Layout<DP>;
  constexpr int kStages = L::kStages;
  // tiles loaded ahead: two fewer than the stages, so one warpgroup may run
  // up to two tiles ahead of the other before the loads wait on it
  constexpr int kAhead = kStages - 2;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  uint8_t* gbase = smem + (base - smem_u32(smem));
  const uint32_t sk = base, sv = base + L::kV, sq = base + L::kQs, so = base + L::kOs;
  // per stage: lse of the tile's 64 q rows, then their Delta
  float* srows = reinterpret_cast<float*>(gbase + L::kRows);
  const uint32_t bar_kv = base + L::kBar;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  int* n_live = reinterpret_cast<int*>(gbase + L::kList);
  int* flags = n_live + 4;  // bit 0: live, bit 1: partial
  int* list = flags + (p.Sq + kN - 1) / kN;

  const int k0 = blockIdx.x * kM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_qt = (p.Sq + kN - 1) / kN;
  // top-left causal: the first q tile with a row at or below the first key
  const int qt0 = p.causal ? min(k0 / kN, n_qt) : 0;
  const int n_it = n_qt - qt0;
  const int* idx = p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA transaction's arrival, then one from each lane of the first
      // warp when its cp.async copies of the stage's rows have landed
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, kThreadsTC);
    }
    fence_barrier_init();
  }
  for (int t = tid; t < n_it; t += kThreadsTC) flags[t] = 0;
  __syncthreads();

  // the live and partial q tiles: thread tid votes for key column
  // k0 + tid % 128 on the tiles qt0 + tid / 128, + 2, + 4, ... (the tile is
  // warp-uniform, so the vote is a ballot)
  {
    const int kp = k0 + tid % kM;
    const int4 iv = column(idx, p.ncol, kp, p.Sk);
    for (int t = tid / kM; t < n_it; t += kThreadsTC / kM) {
      const int q0 = (qt0 + t) * kN;
      const int q_last = min(q0 + kN, p.Sq) - 1;
      const bool live = kp < p.Sk && first_allowed(iv, kp, q0, p.causal) <= q_last;
      const unsigned lv = __ballot_sync(0xffffffffu, live);
      const unsigned pt = __ballot_sync(0xffffffffu, meets(iv, q0, q_last));
      if (tid % 32 == 0 && (lv | pt)) atomicOr(&flags[t], (lv ? 1 : 0) | (pt ? 2 : 0));
    }
  }
  __syncthreads();
  if (tid < 32) compact_live(flags, n_it, qt0, list, n_live, p.tiles, tid);
  __syncthreads();
  const int nl = *n_live;

  // the first warp's loads of list entry t into stage t % kStages, once both
  // warpgroups have released that stage's entry t - kStages
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;
  auto load = [&](int t) {
    const int s = t % kStages;
    const int q0 = (list[t] & kTile) * kN;
    if (t >= kStages) mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
    const uint32_t full = bar_full + 8 * s;
    if (tid == 0) {
      mbar_arrive_expect_tx(full, 2 * L::kQ);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(sq + s * L::kQ + c * L::kQBox, &tq, full, 64 * c, h, q0, b);
        tma_load_4d(so + s * L::kQ + c * L::kQBox, &tdo, full, 64 * c, h, q0, b);
      }
    }
    // zeros past Sq, where Q and dO are zero-filled and P is masked
    const uint32_t st = smem_u32(srows + s * 2 * kN);
    for (int r = tid; r < kN; r += 32) {
      const int qp = q0 + r;
      const long long at = qp < p.Sq ? rows + qp : 0;
      cp_async_4(st + 4 * r, p.lse + at, qp < p.Sq);
      cp_async_4(st + 4 * (kN + r), p.delta + at, qp < p.Sq);
    }
    cp_async_mbar_arrive(full);
  };
  if (tid < 32 && nl > 0) {
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::kBoxes * L::kKBox);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(sk + c * L::kKBox, &tk, bar_kv, 64 * c, h, k0, b);
        tma_load_4d(sv + c * L::kKBox, &tv, bar_kv, 64 * c, h, k0, b);
      }
    }
    for (int t = 0; t < min(kAhead, nl); ++t) load(t);
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + 64 * wg;                // this warpgroup's first key
  const int key0 = kw0 + 16 * warp + lane / 4;  // this thread's keys: key0, key0 + 8
  const int col0 = 2 * (lane % 4);

  constexpr int kO = DP / 2;  // dK and dV accumulator registers (m64 x DP each)
  float dk[kO], dv[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) dk[i] = dv[i] = 0.f;

  if (nl > 0) {
    // this thread's keys' hidden rows, for the whole block
    const int4 kiv[2] = {column(idx, p.ncol, key0, p.Sk), column(idx, p.ncol, key0 + 8, p.Sk)};
    mbar_wait(bar_kv, 0);
    const uint32_t ka = sk + wg * 64 * 128;  // this warpgroup's 64 keys of K and V
    const uint32_t va = sv + wg * 64 * 128;

    float sc[32], dp[32];
    auto issue_sdp = [&](int j) {
      const uint32_t qb = sq + (j % kStages) * L::kQ;
      const uint32_t ob = so + (j % kStages) * L::kQ;
      // the first k slice overwrites sc and dp, so they are dead between
      // tiles and their registers free for the products' A operands
      auto product = [&](float (&d)[32], uint32_t a_tile, uint32_t b_tile) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint64_t da = desc_sw128(a_tile + (kk / 4) * L::kKBox + (kk % 4) * 32, 16, 1024);
          const uint64_t db = desc_sw128(b_tile + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024);
          if (kk == 0)
            wgmma_m64n64k16_ss_set<T>(d, da, db);
          else
            wgmma_m64n64k16_ss<T>(d, da, db, 1);
        }
      };
      product(sc, ka, qb);
      product(dp, va, ob);
      wgmma_commit();
    };
    // P^T in place of S^T, dS^T in place of dP^T; P selected to 0 where
    // hidden
    auto form = [&](int j) {
      const int entry = list[j];
      const int q0 = (entry & kTile) * kN;
      const bool partial = entry & kPartial;
      const float* st = srows + (j % kStages) * 2 * kN;
      const bool edge = q0 + kN > p.Sq || (p.causal && q0 < kw0 + 63);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
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
    };
    // acc += x.B over the tile's 64 q rows: x as the register A operand in
    // two T parts (hi + lo), B (dO or Q) MN-major
    auto add_product = [&](float (&acc)[kO], const float (&x)[32], uint32_t b_tile) {
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) pack_a_split<T>(hi[ks], lo[ks], x, ks);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<T>(acc, hi[ks], desc_sw128(b_tile + ks * 2048, L::kQBox, 1024));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<T>(acc, lo[ks], desc_sw128(b_tile + ks * 2048, L::kQBox, 1024));
      wgmma_commit();
    };

    for (int j = 0; j < nl; ++j) {
      const int s = j % kStages;
      mbar_wait(bar_full + 8 * s, (j / kStages) & 1);
      wgmma_fence();
      issue_sdp(j);
      // the first warp refills the ring while the products run
      if (tid < 32 && j + kAhead < nl) load(j + kAhead);
      wgmma_wait<0>();
      fence_operand(sc);
      fence_operand(dp);
      form(j);
      fence_operand(dv);
      fence_operand(dk);
      // dS^T is packed while P^T.dO runs
      add_product(dv, sc, so + s * L::kQ);
      add_product(dk, dp, sq + s * L::kQ);
      wgmma_wait<0>();
      fence_operand(dv);
      fence_operand(dk);
      mbar_arrive(bar_empty + 8 * s);
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int kp = key0 + 8 * hh;
    if (kp >= p.Sk) continue;
    const long long off = ((static_cast<long long>(b) * p.Sk + kp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D) {
        *reinterpret_cast<typename Elem<T>::T2*>(static_cast<T*>(p.dk) + off + c) = Elem<T>::pack2(
            dk[4 * i + 2 * hh] * p.scale, dk[4 * i + 2 * hh + 1] * p.scale);
        *reinterpret_cast<typename Elem<T>::T2*>(static_cast<T*>(p.dv) + off + c) =
            Elem<T>::pack2(dv[4 * i + 2 * hh], dv[4 * i + 2 * hh + 1]);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  const int smem = Layout<DP>::bytes((p.Sq + kN - 1) / kN);
  if (smem > 232448) return cudaErrorInvalidValue;  // Sq past ~300k rows
  cudaError_t err = cudaFuncSetAttribute(flashmask_dkv_sm90_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sk + kM - 1) / kM, p.H, p.B);
  flashmask_dkv_sm90_kernel<T, DP>
      <<<grid, kThreadsTC, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// The arguments of paddle_flashmask_bwd_dq_sm90 (flashmask_dq_sm90.cu),
// with dk and dv contiguous [B, Sk, H, D] tensors of q's type (dq is not touched);
// tiles null, or a zeroed int32 pair on the device to which each block adds
// its live q tiles and its q tiles within the causal bound. dtype must be
// 1 (bfloat16) or 2 (float16), D one of 16, 32, 64, 128, and every stride of q, k, v, dO a
// multiple of 8 elements with a 16-byte aligned base (TMA). Returns the
// cudaError_t of the launch (0 on success), or sm90::kErrTensorMap when a
// tensor map cannot be encoded.
extern "C" int paddle_flashmask_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* idx, void* dq, void* dk, void* dv, void* tiles, int dtype,
    int B, int Sq, int Sk, int H, int D, int Hm, int ncol, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    float scale, void* stream) {
  (void)dq;
  if ((dtype != 1 && dtype != 2) || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType ty = dtype == 2 ? Elem<__half>::kTma : Elem<__nv_bfloat16>::kTma;
  CUtensorMap maps[4];
  if (!encode_bshd(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kN, ty) ||
      !encode_bshd(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, kM, ty) ||
      !encode_bshd(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, kM, ty) ||
      !encode_bshd(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, kN, ty))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 2 ? (D <= 64 ? launch<__half, 64>(maps, p, s) : launch<__half, 128>(maps, p, s))
                 : (D <= 64 ? launch<__nv_bfloat16, 64>(maps, p, s)
                            : launch<__nv_bfloat16, 128>(maps, p, s));
  return static_cast<int>(err);
}
