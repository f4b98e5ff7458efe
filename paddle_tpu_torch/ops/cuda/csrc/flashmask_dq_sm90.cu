// FlashMask dQ pass on Hopper's tensor cores (sm_90a): K6 for bfloat16 and
// float16 (one instantiation each over the element type T)
// inputs. The float32 K6 is flashmask_dq_tf32.cu.
//
// Replaces paddle_tpu/ops/pallas/flashmask.py::_fm_bwd_dq_kernel (:103,
// launched by _fm_bwd, :251, call :269): dQ = scale * sum_k dS . K, with
// P = exp(q.k^T * scale - lse) recomputed per tile from the forward's row
// logsumexp and set to 0 where the column-interval mask hides the pair
// (flashmask_sm90_common.cuh), dP = dO . V^T and dS = P o (dP - Delta),
// Delta = rowsum(dO o O) computed by the wrapper in f32 as [B, H, 1, Sq].
// Its contract:
//   - layout [B, S, H, D] through per-tensor strides, here TMA tensor maps
//     (a 16-byte aligned base and strides that are multiples of 16 bytes,
//     which the wrapper guarantees by copying any other input);
//   - hidden pairs get P SELECTED to 0, never multiplied by a 0/1 mask: a
//     row that sees no key has lse = -1e30 + log(1e-30), where
//     2^(s - lse) is inf and inf * 0 NaN. Such a row gets dQ = 0 exactly,
//     as the Pallas kernel gives;
//   - any Sq, Sk: TMA fills the rows past the end (and the columns past D
//     when D < 64) with zeros, and the pairs there are masked;
//   - dq contiguous [B, Sq, H, D] in T; no dropout (the Pallas kernel
//     has none).
//
// Design: flash_attention_dq_sm90.cu's block with flashmask_fwd_sm90.cu's
// live-tile list. One block per (128-row q tile, head, batch), heaviest
// causal tiles first; two warpgroups of 64 rows. Before the loop all 256
// threads mark the live and partial 64-key tiles up to the causal bound
// and one warp compacts the live ones into a list. Q and dO come in once;
// the live K and V tiles stream through a ring of kStages stages by TMA,
// each with its 64 columns' intervals by cp.async, all landing on the
// stage's mbarrier (sm90_common.cuh). There is no producer warp: ptxas
// holds a block of 288 threads to 168 registers a thread, and K2's loop
// spills at D = 128 there (148 B); a block of 256 may keep 255. The first
// warp issues the loads kStages - 2 tiles ahead while its own products
// run, as flash_attention_dkv_sm90.cu does. Per live tile each warpgroup
//   1. computes S = Q.K^T and dP = dO.V^T with wgmma (m64n64k16, all four
//      operands K-major from shared memory), T in, f32 sums;
//   2. forms P = 2^(S * scale * log2(e) - lse * log2(e)), selected to 0
//      where hidden, and dS = P o (dP - Delta) in the accumulator registers;
//      a thread tests its elements against their columns' intervals only
//      in a partial tile, and against the ragged edge and the causal
//      diagonal only in a tile that meets them;
//   3. adds dS.K to dQ with wgmma (m64nDk16, the same K tile read MN-major
//      through the transpose bit), dS as the register A operand in two
//      T parts, hi + lo (two products): rounded once, as K2 rounds dS,
//      it leaves dQ less than 4x inside the bf16 gate on FlashMask's
//      layouts, where short documents make P large
//      (tests/test_torch_flashmask_bwd_tc_numerics.py).
// Step 1 of tile j + 1 and step 3 of tile j are issued together, and step 2
// of tile j + 1 runs while dS.K of tile j is on the tensor cores (FA3's
// order inside a warpgroup, as in K2). dq is scaled once and written from
// registers; a block with no live tile writes dQ = 0.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 or fp16 tensor cores, 3.35 TB/s HBM),
// counted over the (q, k) pairs the mask allows, N: three products, 6 D N
// flops a head, against q, k, v, dO, dq, lse, Delta and the indices read or
// written once. At the FlashMask path of chip_smoke.py (B=1, S=8192, 32
// heads, D=128, causal documents, 10.5M allowed pairs a head) that is
// 0.26 ms of operations against 0.09 ms of bytes: bound by operations. The
// split makes the three products four, and a 128-row block computes a
// 64-key tile wherever one of its rows sees it.

#include "flash_attention_common.cuh"
#include "flashmask_sm90_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace fm90;
using namespace paddle_fa;
using namespace sm90;

constexpr int kM = 128;  // q rows per block: two warpgroups of 64
constexpr int kN = 64;   // keys per K/V tile
constexpr int kThreadsTC = 256;  // two warpgroups
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const int* idx;      // [B, Hm, Sk, ncol]
  const float* lse;    // [B, H, 1, Sq]
  const float* delta;  // [B, H, 1, Sq]
  void* dq;  // T
  int* tiles;  // null, or (live tiles, tiles within the causal bound) summed over blocks
  int B, Sq, Sk, H, D, Hm, ncol;
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// shared memory in bytes from a 1024-byte aligned base: the Q and dO
// tiles, kStages K tiles, kStages V tiles, kStages interval slabs (64
// columns x int4), the mbarriers (Q and dO, kStages full, kStages empty),
// then the live-tile count, a flag and a list entry for each k tile
// (kFixed + 8 bytes a k tile in all). kFixed is 135 KB at D <= 64,
// 197 KB at D = 128
template <int DP>
struct Layout {
  static constexpr int kStages = DP <= 64 ? 6 : 4;
  static constexpr int kBoxes = DP / 64;  // 64-column boxes in a row
  static constexpr int kQBox = kM * 128;
  static constexpr int kKVBox = kN * 128;
  static constexpr int kKV = kBoxes * kKVBox;
  static constexpr int kO = kBoxes * kQBox;  // dO
  static constexpr int kK = 2 * kBoxes * kQBox;
  static constexpr int kV = kK + kStages * kKV;
  static constexpr int kI = kV + kStages * kKV;
  static constexpr int kBar = kI + kStages * kN * 16;
  static constexpr int kList = kBar + 8 * (1 + 2 * kStages) + 16;
  static constexpr int kFixed = kList + 16 + 1024;  // + alignment slack
  static int bytes(int n_kt) { return kFixed + 8 * n_kt; }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreadsTC, 1)
    flashmask_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
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
  const uint32_t sq = base, so = base + L::kO, sk = base + L::kK, sv = base + L::kV;
  const uint32_t si = base + L::kI;
  int4* sI = reinterpret_cast<int4*>(gbase + L::kI);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * kStages;
  int* n_live = reinterpret_cast<int*>(gbase + L::kList);
  int* flags = n_live + 4;  // bit 0: live, bit 1: partial
  int* list = flags + (p.Sk + kN - 1) / kN;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;  // heaviest causal tiles first
  const int q_last = min(q0 + kM, p.Sq) - 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  int n_kt = (p.Sk + kN - 1) / kN;
  if (p.causal) n_kt = min(n_kt, (q0 + kM - 1) / kN + 1);
  const int* idx = p.idx + (static_cast<long long>(b) * p.Hm + (p.Hm > 1 ? h : 0)) * p.Sk * p.ncol;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      // the TMA transaction's arrival, then one from each lane of the first
      // warp when its cp.async copies of the stage's intervals have landed
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, kThreadsTC);
    }
    fence_barrier_init();
  }
  for (int t = tid; t < n_kt; t += kThreadsTC) flags[t] = 0;
  // the components of a column's intervals that its ncol indices do not
  // give (an ncol-1 column's open end, an ncol-2 column's empty second
  // interval); the loads copy the others
  for (int c = tid; c < kStages * kN; c += kThreadsTC) sI[c] = make_int4(0, kOpen, 0, 0);
  __syncthreads();
  mark_k_tiles<kThreadsTC>(idx, p.ncol, p.Sk, q0, q_last, p.causal, n_kt, flags, tid);
  __syncthreads();
  if (tid < 32) compact_live(flags, n_kt, 0, list, n_live, p.tiles, tid);
  __syncthreads();
  const int nl = *n_live;

  // the first warp's loads of list entry j into stage j % kStages, once both
  // warpgroups have released that stage's entry j - kStages: K and V by
  // TMA, the 64 columns' ncol indices by cp.async (zeros past Sk)
  const int lg_ncol = p.ncol >> 1;  // ncol 1, 2, 4 -> 0, 1, 2
  auto load = [&](int j) {
    const int s = j % kStages;
    const int k0 = (list[j] & kTile) * kN;
    if (j >= kStages) mbar_wait(bar_empty + 8 * s, (j / kStages - 1) & 1);
    const uint32_t full = bar_full + 8 * s;
    if (tid == 0) {
      mbar_arrive_expect_tx(full, 2 * L::kKV);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(sk + s * L::kKV + c * L::kKVBox, &tk, full, 64 * c, h, k0, b);
        tma_load_4d(sv + s * L::kKV + c * L::kKVBox, &tv, full, 64 * c, h, k0, b);
      }
    }
    for (int e = tid; e < kN * p.ncol; e += 32) {
      const int c = e >> lg_ncol, part = e - (c << lg_ncol);
      const int kp = k0 + c;
      const long long at = kp < p.Sk ? static_cast<long long>(kp) * p.ncol + part : 0;
      cp_async_4(si + (s * kN + c) * 16 + 4 * part, idx + at, kp < p.Sk);
    }
    cp_async_mbar_arrive(full);
  };
  if (tid < 32 && nl > 0) {
    if (tid == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::kBoxes * L::kQBox);
      for (int c = 0; c < L::kBoxes; ++c) {
        tma_load_4d(sq + c * L::kQBox, &tq, bar_q, 64 * c, h, q0, b);
        tma_load_4d(so + c * L::kQBox, &tdo, bar_q, 64 * c, h, q0, b);
      }
    }
    for (int j = 0; j < min(kAhead, nl); ++j) load(j);
  }

  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
  const int col0 = 2 * (lane % 4);
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.Sq;

  // lse * log2(e) and Delta of this thread's rows; 0 past Sq, where Q and dO
  // are zero-filled and every pair is masked
  float lse2[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    lse2[hh] = qp < p.Sq ? p.lse[rows + qp] * kLog2e : 0.f;
    delta[hh] = qp < p.Sq ? p.delta[rows + qp] : 0.f;
  }

  constexpr int kO = DP / 2;  // dQ accumulator registers (m64 x DP)
  float acc[kO];
#pragma unroll
  for (int i = 0; i < kO; ++i) acc[i] = 0.f;

  if (nl > 0) {
    mbar_wait(bar_q, 0);
    const uint32_t qa = sq + wg * 64 * 128;  // this warpgroup's 64 rows of Q and dO
    const uint32_t oa = so + wg * 64 * 128;

    // FA3's order inside a warpgroup: while the products of tile j + 1's S
    // and dP and of tile j's dS.K run, dS of tile j + 1 is formed; acc and
    // the A registers are touched only when no product is in flight
    float sc[32], dp[32];
    uint32_t hi[4][4], lo[4][4];
    auto issue_sdp = [&](int j) {
      const uint32_t kb = sk + (j % kStages) * L::kKV;
      const uint32_t vb = sv + (j % kStages) * L::kKV;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss<T>(sc, desc_sw128(qa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                           desc_sw128(kb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_m64n64k16_ss<T>(dp, desc_sw128(oa + (kk / 4) * L::kQBox + (kk % 4) * 32, 16, 1024),
                           desc_sw128(vb + (kk / 4) * L::kKVBox + (kk % 4) * 32, 16, 1024), kk > 0);
      wgmma_commit();
    };
    // dS = P o (dP - Delta) in place of S, P selected to 0 where hidden
    auto form_ds = [&](int j) {
      const int entry = list[j];
      const int k0 = (entry & kTile) * kN;
      const bool partial = entry & kPartial;
      const int4* iv = sI + (j % kStages) * kN;
      const bool edge = k0 + kN > p.Sk || (p.causal && k0 + kN - 1 > q0 + 64 * wg);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * i + col0 + e;
          const int kp = k0 + c;
          int4 civ = make_int4(0, 0, 0, 0);
          if (partial) civ = iv[c];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int x = 4 * i + 2 * hh + e;
            const int r = row0 + 8 * hh;
            float pj = ex2(fmaf(sc[x], p.scale_log2, -lse2[hh]));
            if ((edge && (kp >= p.Sk || (p.causal && r < kp))) || (partial && hidden(civ, r)))
              pj = 0.f;
            sc[x] = pj * (dp[x] - delta[hh]);
          }
        }
    };

    mbar_wait(bar_full, 0);
    fence_operand(sc);
    fence_operand(dp);
    wgmma_fence();
    issue_sdp(0);
    wgmma_wait<0>();
    fence_operand(sc);
    fence_operand(dp);
    form_ds(0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) pack_a_split<T>(hi[ks], lo[ks], sc, ks);
    for (int j = 0; j < nl; ++j) {
      const bool more = j + 1 < nl;
      if (more) mbar_wait(bar_full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
      fence_operand(acc);
      fence_operand(sc);
      fence_operand(dp);
      wgmma_fence();
      if (more) issue_sdp(j + 1);
      const uint32_t kb = sk + (j % kStages) * L::kKV;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<T>(acc, hi[ks], desc_sw128(kb + ks * 2048, L::kKVBox, 1024));
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_rs<T>(acc, lo[ks], desc_sw128(kb + ks * 2048, L::kKVBox, 1024));
      wgmma_commit();
      // the first warp refills the ring while the products run
      if (tid < 32 && j + kAhead < nl) load(j + kAhead);
      if (more) {
        wgmma_wait<1>();
        fence_operand(sc);
        fence_operand(dp);
        form_ds(j + 1);
      }
      wgmma_wait<0>();
      fence_operand(acc);
      mbar_arrive(bar_empty + 8 * (j % kStages));
      if (more) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) pack_a_split<T>(hi[ks], lo[ks], sc, ks);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qp = row0 + 8 * hh;
    if (qp >= p.Sq) continue;
    T* row = static_cast<T*>(p.dq) + ((static_cast<long long>(b) * p.Sq + qp) * p.H + h) * p.D;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int c = 8 * i + col0;
      if (c < p.D)
        *reinterpret_cast<typename Elem<T>::T2*>(row + c) = Elem<T>::pack2(
            acc[4 * i + 2 * hh] * p.scale, acc[4 * i + 2 * hh + 1] * p.scale);
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const CUtensorMap (&maps)[4], const Params& p, cudaStream_t stream) {
  const int smem = Layout<DP>::bytes((p.Sk + kN - 1) / kN);
  if (smem > 232448) return cudaErrorInvalidValue;  // Sk past ~300k keys
  cudaError_t err = cudaFuncSetAttribute(flashmask_dq_sm90_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + kM - 1) / kM, p.H, p.B);
  flashmask_dq_sm90_kernel<T, DP>
      <<<grid, kThreadsTC, smem, stream>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements, those of q, k, v, then dO; lse and delta are
// contiguous [B, H, 1, Sq] f32 tensors, dq a contiguous [B, Sq, H, D] T
// tensor (dk and dv are not touched), idx as for
// paddle_flashmask_fwd_sm90; tiles null, or a zeroed int32 pair on the
// device to which each block adds its live k tiles and its k tiles within
// the causal bound. dtype must be 1 (bfloat16) or 2 (float16), D one of 16, 32, 64, 128, and
// every stride of q, k, v, dO a multiple of 8 elements with a 16-byte
// aligned base (TMA). Returns the cudaError_t of the launch (0 on
// success), or sm90::kErrTensorMap when a tensor map cannot be encoded.
extern "C" int paddle_flashmask_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* idx, void* dq, void* dk, void* dv, void* tiles, int dtype,
    int B, int Sq, int Sk, int H, int D, int Hm, int ncol, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    float scale, void* stream) {
  (void)dk;
  (void)dv;
  if ((dtype != 1 && dtype != 2) || (D != 16 && D != 32 && D != 64 && D != 128) || B < 1 || Sq < 1 || Sk < 1 ||
      H < 1 || (Hm != 1 && Hm != H) || (ncol != 1 && ncol != 2 && ncol != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const CUtensorMapDataType ty = dtype == 2 ? Elem<__half>::kTma : Elem<__nv_bfloat16>::kTma;
  CUtensorMap maps[4];
  if (!encode_bshd(&maps[0], q, B, Sq, H, D, q_sb, q_ss, q_sh, kM, ty) ||
      !encode_bshd(&maps[1], k, B, Sk, H, D, k_sb, k_ss, k_sh, kN, ty) ||
      !encode_bshd(&maps[2], v, B, Sk, H, D, v_sb, v_ss, v_sh, kN, ty) ||
      !encode_bshd(&maps[3], dout, B, Sq, H, D, o_sb, o_ss, o_sh, kM, ty))
    return kErrTensorMap;
  Params p;
  p.idx = static_cast<const int*>(idx);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
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
