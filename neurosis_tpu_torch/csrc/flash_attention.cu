// Flash attention forward and backward for Hopper (sm_90a), bf16 in, fp32 accumulate,
// and an fp32 forward and backward (split-TF32 tensor cores) for the models that run
// in fp32.
//
// Replaces the Pallas TPU kernels of neurosis_tpu/ops/flash_attention.py:
//   forward  : _fwd_kernel (:297), _fwd_chunked_kernel (:366),
//              _fwd_streamed_kernel (:411), _fwd_wide_kernel (:575)
//   backward : _bwd_dq_kernel (:751), _bwd_dq_chunked_kernel (:811),
//              _bwd_dq_streamed_kernel (:472), _bwd_dq_wide_kernel (:843),
//              _bwd_dkv_kernel (:952), _bwd_dkv_chunked_kernel (:875),
//              _bwd_dkv_streamed_kernel (:519), _bwd_dkv_wide_kernel (:915)
// The TPU families differ only in how they fit VMEM; each computes one
// function, so there is one kernel per function and head-dim family here.
//
// Contract (as the JAX wrapper's): q arrives pre-scaled by scale*log2(e) and
// rounded to bf16, scale = 1/sqrt(d) of the true head dim. Logits are base 2,
// the softmax is online in fp32, the kv tail (kv=77 cross-attention) is
// masked, P and dS are rounded to bf16 before their products, and the per-row
// LSE (base 2) is the backward residual.
//
// Head dims 40, 64, 80, 160 (flash_fwd_wgmma, flash_bwd_wgmma). What bounds
// them on the H100: at S = Skv >= 1024 the tensor-core rate (4 S Skv d flops
// forward, 10 S Skv d backward, hundreds of flops per byte moved); at kv = 77
// the bytes of q, O (and dO, dq) against 3.35 TB/s. The design is Hopper's:
//   - a block is two consumer warpgroups and one producer warpgroup, of which
//     one warp issues the loads (a lone producer warp cannot free enough
//     registers for setmaxnreg: the producer drops to 40, the consumers rise
//     to 232). It moves tiles by TMA (rank-4 tensor maps over the strided
//     [B, H, S, d] views, 64-column boxes with the 128-byte swizzle) into a
//     ring of 2 stages (3 in the backward at d <= 80) with full/empty
//     mbarriers, so the next tile is in flight while the consumers compute on
//     this one, and no consumer spends a register or an issue slot on a copy;
//   - every product is a warpgroup wgmma (m64nNk16) with the accumulator in
//     registers; the logits' accumulator layout is the A-fragment layout, so P
//     (and dS) go from the softmax to the next wgmma as bf16 registers;
//   - the softmax runs in registers: a row's columns sit in the 4 threads of a
//     quad, so its max and sum are two shuffles; O (forward) and dK, dV
//     (backward) stay in registers for the life of the block.
//   Forward: a block owns 128 query rows (64 per warpgroup), loads q~ once and
//   walks kv in 128-row tiles (64 at d=160, to fit the ring in 227 KB). S =
//   q~ K^T (SS wgmma), the kv tail masked to -inf in registers (TMA fills rows
//   past Skv with zeros), O += P V (RS wgmma, V MN-major).
//   Backward: a block owns 128 kv rows (64 per warpgroup), loads K and V once
//   and walks its range of q tiles (64 rows) through the ring of (q~, dO, LSE,
//   Di). S^T = K q~^T and dP^T = V dO^T (SS), P^T and dS^T in registers, dV +=
//   P^T dO and dK += dS^T q~ (RS). dS^T goes to shared memory once (bf16, the
//   swizzle TMA would write, fence.proxy.async before the wgmma reads it, two
//   buffers) for dQ = dS K over the block's 128 kv rows, which the two
//   warpgroups form in turn, tile by tile, and add to the zeroed fp32 buffer,
//   times scale, by float2 atomics: each dQ element takes one atomic per
//   block and q tile. Where the kv tiles alone leave SMs
//   idle (kv = 77: 2 x 10 heads give 20 blocks) the q range is split over
//   blocks (gridDim.z, chosen by the caller) and dK, dV are summed by fp32
//   atomics into zeroed buffers that the caller casts.
//   Head dims pad to the swizzle: the smem rows are 64 columns (d=40 reads 48
//   of them in the k16 steps of q~K^T; columns past d are TMA's zeros), the
//   products whose n is the head dim use n = d exactly.
//   Not done: persistent blocks, and overlapping one tile's softmax with the
//   next tile's q~K^T inside a warpgroup (the two warpgroups overlap each
//   other only as the scheduler interleaves them).
//
// Head dim 512, bf16 (the VAE's single-head mid attention). The 128-row tiles
// above would need ~1 MB of shared memory at d = 512.
//   forward  (flash_fwd512_wgmma): the pipeline above with O split by column.
//              A block owns 64 q rows (8 x 1 x 1024 gives 128 blocks, one wave
//              on 132 SMs) and holds q~, one K tile and one V tile of 64 rows
//              by TMA (64 KB each), with their own full/empty barriers, so K of
//              the next tile loads while the consumers run P V and V while they
//              run the next q~ K^T. Each consumer warpgroup owns 256 of O's 512
//              columns (128 fp32 registers a thread) and forms the whole S = q~
//              K^T itself (SS wgmma, 32 k16 steps): both form the same products
//              in the same order, so both hold the same S, max and sum, and no
//              partial sums cross shared memory; 1.5x the tensor work of
//              splitting S, which the card has to spare here (the kernel's
//              bound is L2 traffic: every block reads all of K and V). P goes
//              to P V as bf16 registers (RS wgmma, N = 256, V MN-major).
//   backward : JAX's two passes (_bwd_dq_kernel, _bwd_dkv_kernel) on the same
//              pipeline, each block 64 rows and each consumer warpgroup one
//              accumulator of 256 columns: dQ, dK and dV of 64 kv rows in one
//              kernel would take 384 fp32 registers a thread. The function
//              needs 5 products of 2 B H Sq Skv 512 operations; the two kernels
//              form 9 (S and dP in both, and in both halves of dK/dV), and
//              every dQ block reads all of K and V, every dK/dV block all of
//              q~ and dO, so L2 traffic, not the tensor cores, sets the pace.
//     flash_bwd512_dq_wgmma (q-stationary; the forward's geometry): warpgroup
//              w forms S and dP for keys 32 w .. +31 of each 64-key tile (N = 32
//              SS wgmma over the 512-deep head dim), P = 2^(S - LSE) and dS = P
//              (dP - Di) in fp32 registers, dS in bf16 into one shared box (the
//              swizzle TMA writes, fence.proxy.async, a named barrier), then dQ
//              [:, 256 w ..] += dS K (N = 256, K MN-major). q~ and dO stay in
//              shared memory, K stays for the tile, V streams box by box (dP
//              first, so K lands meanwhile). dQ is written once, scaled, bf16.
//     flash_bwd512_dkv_wgmma (kv-stationary): 64 kv rows and one 256-column
//              half of dK and dV a block (two blocks a kv tile), q walked in
//              tiles of 64. Warpgroup w forms S^T = K q~^T and dP^T = V dO^T for
//              q columns 32 w .. +31, P^T and dS^T for them in bf16 into two
//              shared boxes; warpgroup 0 then forms dV += P^T dO, warpgroup 1
//              dK += dS^T q~ over the owned half. K and V stay; the other
//              half's boxes of q~ and dO stream through a ring, the owned
//              half's (read again by dV and dK) stay for the tile.
//              Every grad is written once, so two calls give the same bits.
//
// fp32 at padded head dims DP = 64, 96, 160, 512 (the caller zero-pads other
// d <= 512 to the next of them): the frozen VAE encode and the UNets of the
// configs without a precision key run in fp32, and the JAX kernels take fp32
// there (feeding the MXU fp32 operands at its multi-pass fp32 rate, JAX's
// ops/flash_attention.py:317-319), so these kernels keep fp32 accuracy.
//   forward (flash_fwd_f32_wgmma): on the tensor cores by split TF32. One TF32
//     product keeps 11 significant bits of each operand, which would change the
//     fp32 island's numbers; three do not. Each operand x is written as x = hi +
//     lo + e, hi the nearest tf32 to x, lo the nearest tf32 to x - hi (exact in
//     fp32, |x - hi| <= 2^-11 |x|), |e| <= 2^-22 |x|, and a b = hi.hi + hi.lo +
//     lo.hi (wgmma m64nNk8 .tf32, fp32 accumulate) up to the dropped lo.lo and
//     the e terms, each about 2^-22 relative: fp32's own rounding, not TF32's.
//     The hi parts have their low 13 bits clear, so what the tensor cores do
//     with an operand's low bits never matters. Bound on the H100 by three
//     times 4 B H Sq Skv D operations at the TF32 rate (494.7 TFLOP/s), and at
//     d = 512 by L2: every block reads all of K and V.
//     Design: three passes (flash_f32_split_rows for q~ and K, flash_f32_split_vt
//     for V) write hi and lo of each operand to scratch, V transposed: TF32
//     wgmma takes no transposed operand, so both operands of P V are K-major
//     and V^T is stored keys-contiguous, as JAX's wrapper transposes to
//     D-major outside its kernel (:1269-1272). Then the pipeline of the bf16
//     kernels: a producer warpgroup moves 32-column boxes (128 bytes, the
//     swizzle's row) by TMA through one ring; per kv tile of 64 keys it loads
//     the head dim's chunks of q~ and K (hi, lo), then the V^T boxes. q~ is
//     streamed with K, not held: at d = 512 its hi and lo (64 rows) would take
//     256 KB. Two consumer warpgroups run the products with the accumulators
//     in registers, each chunk's wgmmas in flight while the next is awaited,
//     the online softmax in registers, and P = 2^(S - max) split into hi and lo
//     in shared memory in the swizzle TMA writes (fence.proxy.async, a named
//     barrier), from where P V reads it as the K-major A operand.
//     DP <= 160: a block owns 128 query rows, each warpgroup 64 with its own S,
//     P and O, so each K/V box read from L2 serves 128 rows.
//     DP = 512: a block owns 64 rows (O is 256 fp32 registers a thread for one
//     warpgroup): warpgroup w forms the logits of keys 32 w .. +31 of each
//     tile and owns O's columns 256 w .. +255. The row maxima meet in shared
//     memory behind a named barrier, each keeps its part of the row sum (added
//     once at the end), and both read the tile's whole P from shared memory.
//   backward: JAX's two passes (_bwd_dq_kernel, _bwd_dkv_kernel), each on the
//     forward's pipeline, so that a consumer warpgroup holds one accumulator
//     the size of the forward's O (dQ, dK or dV) and one fresh tile: dK, dV and
//     dQ in one kv-stationary kernel, as the bf16 backward has them, would need
//     about 300 registers a thread in fp32 with fresh tiles, and 256 KB of
//     registers for 64 kv rows at 512. Seven split passes write hi and lo of
//     q~, K, V, dO by rows and of K^T, q~^T, dO^T (TF32 wgmma takes K-major
//     operands only). Bound on the H100 by three times 10 B H Sq Skv D
//     operations at the TF32 rate; the two kernels form 7 products where the
//     function needs 5 (9 at 512, where both halves of dK, dV form the logits).
//     flash_bwd_dq_f32_wgmma (q-stationary; FwdF32Cfg's geometry): the forward
//       with the saved LSE in place of the online softmax, one more product (dP
//       = dO V^T, dO and V streamed as q~ and K are) and K^T in place of V^T:
//       per kv tile S and dP (fresh chunk groups at 512), P = 2^(S - LSE), dS =
//       P (dP - Di) as hi and lo into shared memory, dQ += dS K in a fresh
//       accumulator. dQ is written once, times scale, with plain stores.
//     flash_bwd_dkv_f32_wgmma (kv-stationary): 64 kv rows a block (at 512 one
//       256-column half of dK and dV, two blocks a kv tile), q walked in tiles
//       of 64. Warpgroup 0 forms S^T = K q~^T, P^T = 2^(S^T - LSE) into shared
//       memory and dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, reads P^T
//       after a named barrier, writes dS^T = P^T (dP^T - Di) and forms dK +=
//       dS^T q~. Each has its own ring (two slots) fed by its own producer
//       warp. Where the kv tiles leave SMs idle (kv = 77) the q range is split
//       over blocks and dK, dV are summed by fp32 atomics into zeroed buffers;
//       otherwise every grad is written once, so two calls give the same bits.
//     As in the forward, the loads and the per-tile waits, not the products,
//     set their pace (neurosis_tpu_torch/tools/flash_f32_probes.py).

#include <math.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr float INV_LOG2E = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// head dims 40, 64, 80, 160, bf16: TMA ring, wgmma, softmax in registers
// ---------------------------------------------------------------------------

constexpr int FQ = 128;  // forward: query rows per block

template <int D>
struct FwdCfg {
  static constexpr int NB = (D + 63) / 64;          // 64-column boxes across the head dim
  static constexpr int KS = (D + 15) / 16;          // k16 steps over the head dim
  static constexpr int BK = D > 128 ? 64 : 128;     // kv rows per ring stage
  static constexpr int STAGES = 2;
  static constexpr int Q_BOX = FQ * ROW;
  static constexpr int KV_BOX = BK * ROW;
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;      // one of K, V
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

struct FwdTma {
  CUtensorMap q, k, v;   // boxes of 64 columns x FQ (q) or BK (k, v) rows
  bf16* o;               // [B, H, Sq, D] contiguous
  float* lse;            // [B, H, Sq] contiguous
  int heads, sq, skv;
};

template <int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_wgmma(const __grid_constant__ FwdTma p) {
  using C = FwdCfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);           // [box][FQ rows]
  unsigned char* sK = sQ + C::Q_BYTES;               // [stage][box][BK rows]
  unsigned char* sV = sK + C::STAGES * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + C::STAGES * C::KV_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + C::STAGES;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * FQ;
  const int n_tiles = (p.skv + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer: q~ once, then K and V tiles through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      mbar_arrive_tx(q_full, C::Q_BYTES);
      for (int j = 0; j < C::NB; ++j) tma_load_4d(sQ + j * C::Q_BOX, &p.q, q_full, 64 * j, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % C::STAGES;
        mbar_wait(&kv_empty[s], ((t / C::STAGES) & 1) ^ 1);
        mbar_arrive_tx(&kv_full[s], 2 * C::KV_BYTES);
        for (int j = 0; j < C::NB; ++j) {
          tma_load_4d(sK + s * C::KV_BYTES + j * C::KV_BOX, &p.k, &kv_full[s], 64 * j, t * BK, h, b);
          tma_load_4d(sV + s * C::KV_BYTES + j * C::KV_BOX, &p.v, &kv_full[s], 64 * j, t * BK, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows wg * 64 .. +63 of the block; this
    // thread holds rows `row` and `row + 8` of the accumulators, columns
    // 8 c + 2 qd + {0, 1} (registers 4 c + {0, 1} and 4 c + {2, 3})
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int row = q0 + wg * 64 + (warp % 4) * 16 + g;
    const unsigned char* q_wg = sQ + wg * 64 * ROW;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float s_acc[BK / 2];
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % C::STAGES;
      mbar_wait(&kv_full[s], (t / C::STAGES) & 1);
      const unsigned char* k_tile = sK + s * C::KV_BYTES;
      const unsigned char* v_tile = sV + s * C::KV_BYTES;

      // S = q~ K^T, both K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        Wgmma<BK>::template ss<0, 0>(s_acc, sw128_desc(q_wg + kstep_offset(kk, C::Q_BOX), 0),
                                     sw128_desc(k_tile + kstep_offset(kk, C::KV_BOX), 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_acc);

      const int valid = p.skv - t * BK;  // the kv tail: TMA's zero rows become -inf
      if (valid < BK) {
#pragma unroll
        for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (8 * c + 2 * qd + j >= valid) s_acc[4 * c + j] = s_acc[4 * c + 2 + j] = -INFINITY;
          }
        }
      }

      // online softmax; every tile has a valid column, so the max is finite
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * c], s_acc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * c + 2], s_acc[4 * c + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pf[BK / 16][4];  // P in bf16 as the A fragments of P V
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
        const float p00 = exp2f(s_acc[4 * c] - mx0), p01 = exp2f(s_acc[4 * c + 1] - mx0);
        const float p10 = exp2f(s_acc[4 * c + 2] - mx1), p11 = exp2f(s_acc[4 * c + 3] - mx1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pf[c / 2][(c % 2) * 2] = pack_bf16(p00, p01);
        pf[c / 2][(c % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + sum0;  // this thread's part of the row sum; the quad adds at the end
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c] *= a0;
        o[4 * c + 1] *= a0;
        o[4 * c + 2] *= a1;
        o[4 * c + 3] *= a1;
      }

      // O += P V, V MN-major: kv rows 16 kc.. and 64-column boxes KV_BOX apart
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        Wgmma<D>::template rs<1>(o, pf[kc], sw128_desc(v_tile + kc * 16 * ROW, C::KV_BOX), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    bf16* o_bh = p.o + (int64_t)bh * p.sq * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * qd;
      if (row < p.sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)row * D + col) = pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)(row + 8) * D + col) =
            pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
    }
    if (qd == 0) {
      float* lse = p.lse + (int64_t)bh * p.sq;
      if (row < p.sq) lse[row] = m0 + log2f(l0);
      if (row + 8 < p.sq) lse[row + 8] = m1 + log2f(l1);
    }
  }
}

constexpr int BKV = 128;  // backward: kv rows per block
constexpr int BQB = 64;   // backward: q rows per ring stage

template <int D>
struct BwdCfg {
  static constexpr int NB = (D + 63) / 64;
  static constexpr int KS = (D + 15) / 16;
  static constexpr int KV_BOX = BKV * ROW;
  static constexpr int KV_BYTES = NB * KV_BOX;  // one of K, V
  static constexpr int Q_BOX = BQB * ROW;
  static constexpr int Q_BYTES = NB * Q_BOX;    // one of q~, dO
  static constexpr int DS_BYTES = BKV * ROW;    // the block's dS^T, 128 kv x 64 q
  static constexpr int STAGES = D > 128 ? 2 : 3;  // ring depth, as shared memory allows
  static constexpr size_t SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES + 2 * DS_BYTES +
                                 2 * STAGES * BQB * sizeof(float) + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct BwdTma {
  CUtensorMap q, k, v, dout;  // boxes of 64 columns x BQB (q~, dO) or BKV (K, V) rows
  const float* lse;           // [B, H, Sq]
  const float* di;            // [B, H, Sq] rowsum(dO * O)
  float* dq;                  // [B, H, Sq, D] fp32, zeroed; receives dS . k . scale
  bf16* dk;                   // [B, H, Skv, D], written when splits == 1
  bf16* dv;
  float* dk_acc;              // [B, H, Skv, D] fp32, zeroed; summed into when splits > 1
  float* dv_acc;
  float scale;
  int heads, sq, skv, splits;
};

// dQ[q rows of the tile, columns col0 .. col0 + N) += dS K over the block's
// 128 kv rows: dS^T (MN-major A) from its shared tile, K MN-major; added to the
// fp32 buffer times scale
template <int N, int D>
__device__ __forceinline__ void dq_add(const unsigned char* ds, const unsigned char* k, int col0, float* dq,
                                       int row, int sq, float scale, int qd) {
  constexpr int KV_BOX = BwdCfg<D>::KV_BOX;
  float acc[N / 2];
  const unsigned char* kb = k + (col0 / 64) * KV_BOX;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc) {
    Wgmma<N>::template ss<1, 1>(acc, sw128_desc(ds + kc * 16 * ROW, 0), sw128_desc(kb + kc * 16 * ROW, KV_BOX),
                                kc > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(acc);
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const int col = col0 + 8 * c + 2 * qd;
    if (row < sq) {
      atomicAdd(reinterpret_cast<float2*>(dq + (int64_t)row * D + col),
                make_float2(acc[4 * c] * scale, acc[4 * c + 1] * scale));
    }
    if (row + 8 < sq) {
      atomicAdd(reinterpret_cast<float2*>(dq + (int64_t)(row + 8) * D + col),
                make_float2(acc[4 * c + 2] * scale, acc[4 * c + 3] * scale));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_bwd_wgmma(const __grid_constant__ BwdTma p) {
  using C = BwdCfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);        // [box][BKV rows]
  unsigned char* sV = sK + C::KV_BYTES;
  unsigned char* sQ = sV + C::KV_BYTES;           // [stage][box][BQB rows]
  unsigned char* sdO = sQ + C::STAGES * C::Q_BYTES;
  unsigned char* sdS = sdO + C::STAGES * C::Q_BYTES;  // [buffer][BKV kv rows]
  float* sLse = reinterpret_cast<float*>(sdS + 2 * C::DS_BYTES);  // [stage][BQB]
  float* sDi = sLse + C::STAGES * BQB;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDi + C::STAGES * BQB);
  uint64_t* q_full = kv_full + 1;
  uint64_t* q_empty = q_full + C::STAGES;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int k0 = blockIdx.x * BKV;
  const int q_tiles = (p.sq + BQB - 1) / BQB;
  const int t0 = blockIdx.z * q_tiles / p.splits, t1 = (blockIdx.z + 1) * q_tiles / p.splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&q_full[s], 32);  // the producer warp's lanes (LSE and Di) and the TMA bytes
      mbar_init(&q_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer: K and V once, then (q~, dO) by TMA and (LSE, Di) by the lanes
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp > NCW) return;
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * C::KV_BYTES);
      for (int j = 0; j < C::NB; ++j) {
        tma_load_4d(sK + j * C::KV_BOX, &p.k, kv_full, 64 * j, k0, h, b);
        tma_load_4d(sV + j * C::KV_BOX, &p.v, kv_full, 64 * j, k0, h, b);
      }
    }
    const float* lse = p.lse + (int64_t)bh * p.sq;
    const float* di = p.di + (int64_t)bh * p.sq;
    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % C::STAGES;
      mbar_wait(&q_empty[s], ((i / C::STAGES) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, so the loads below overlap their flight
        mbar_expect_tx(&q_full[s], 2 * C::Q_BYTES);
        for (int j = 0; j < C::NB; ++j) {
          tma_load_4d(sQ + s * C::Q_BYTES + j * C::Q_BOX, &p.q, &q_full[s], 64 * j, t * BQB, h, b);
          tma_load_4d(sdO + s * C::Q_BYTES + j * C::Q_BOX, &p.dout, &q_full[s], 64 * j, t * BQB, h, b);
        }
      }
      for (int r = lane; r < BQB; r += 32) {
        const int row = t * BQB + r;
        sLse[s * BQB + r] = row < p.sq ? lse[row] : INFINITY;  // rows past Sq get P = 0
        sDi[s * BQB + r] = row < p.sq ? di[row] : 0.0f;
      }
      mbar_arrive(&q_full[s]);  // each lane after its own stores
    }
  } else {
    // consumers: warpgroup wg owns kv rows wg * 64 .. +63 of the block; this
    // thread holds kv rows kr and kr + 8 of S^T, dP^T, dK, dV (q rows of dQ)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int kr = (warp % 4) * 16 + g;  // within the warpgroup's 64 rows
    const bool ok0 = k0 + wg * 64 + kr < p.skv, ok1 = k0 + wg * 64 + kr + 8 < p.skv;
    const unsigned char* k_wg = sK + wg * 64 * ROW;
    const unsigned char* v_wg = sV + wg * 64 * ROW;
    float* dq_bh = p.dq + (int64_t)bh * p.sq * D;
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;
    float s_acc[BQB / 2], dp_acc[BQB / 2];
    mbar_wait(kv_full, 0);

    for (int t = t0; t < t1; ++t) {
      const int i = t - t0, s = i % C::STAGES;
      mbar_wait(&q_full[s], (i / C::STAGES) & 1);
      const unsigned char* q_tile = sQ + s * C::Q_BYTES;
      const unsigned char* do_tile = sdO + s * C::Q_BYTES;
      // dS^T of this tile, in buffer i % 2: buffer i % 2 is written again at
      // tile i + 2, after the barrier of tile i + 1, which its dQ product precedes
      unsigned char* ds = sdS + (i % 2) * C::DS_BYTES;
      unsigned char* ds_wg = ds + wg * 64 * ROW;

      // S^T = K q~^T, dP^T = V dO^T, all K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        Wgmma<BQB>::template ss<0, 0>(s_acc, sw128_desc(k_wg + kstep_offset(kk, C::KV_BOX), 0),
                                      sw128_desc(q_tile + kstep_offset(kk, C::Q_BOX), 0), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        Wgmma<BQB>::template ss<0, 0>(dp_acc, sw128_desc(v_wg + kstep_offset(kk, C::KV_BOX), 0),
                                      sw128_desc(do_tile + kstep_offset(kk, C::Q_BOX), 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_acc);
      reg_fence(dp_acc);

      // P^T = 2^(S^T - LSE) (0 on kv rows past Skv), dS^T = P^T (dP^T - Di), both
      // as bf16 A fragments; dS^T also to shared memory in the 128-byte swizzle
      const float* lse = sLse + s * BQB;
      const float* di = sDi + s * BQB;
      uint32_t pf[BQB / 16][4], sf[BQB / 16][4];
#pragma unroll
      for (int c = 0; c < BQB / 8; ++c) {
        const float2 L = *reinterpret_cast<const float2*>(lse + 8 * c + 2 * qd);
        const float2 Di = *reinterpret_cast<const float2*>(di + 8 * c + 2 * qd);
        const float p00 = ok0 ? exp2f(s_acc[4 * c] - L.x) : 0.0f;
        const float p01 = ok0 ? exp2f(s_acc[4 * c + 1] - L.y) : 0.0f;
        const float p10 = ok1 ? exp2f(s_acc[4 * c + 2] - L.x) : 0.0f;
        const float p11 = ok1 ? exp2f(s_acc[4 * c + 3] - L.y) : 0.0f;
        const uint32_t ds0 = pack_bf16(p00 * (dp_acc[4 * c] - Di.x), p01 * (dp_acc[4 * c + 1] - Di.y));
        const uint32_t ds1 = pack_bf16(p10 * (dp_acc[4 * c + 2] - Di.x), p11 * (dp_acc[4 * c + 3] - Di.y));
        pf[c / 2][(c % 2) * 2] = pack_bf16(p00, p01);
        pf[c / 2][(c % 2) * 2 + 1] = pack_bf16(p10, p11);
        sf[c / 2][(c % 2) * 2] = ds0;
        sf[c / 2][(c % 2) * 2 + 1] = ds1;
        const int chunk = (c ^ (kr & 7)) * 16 + qd * 4;  // rows kr and kr + 8 share kr % 8
        *reinterpret_cast<uint32_t*>(ds_wg + kr * ROW + chunk) = ds0;
        *reinterpret_cast<uint32_t*>(ds_wg + (kr + 8) * ROW + chunk) = ds1;
      }

      // dV += P^T dO, dK += dS^T q~ (dO, q~ MN-major: q rows 16 kc.., boxes Q_BOX apart)
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BQB / 16; ++kc) {
        Wgmma<D>::template rs<1>(dv, pf[kc], sw128_desc(do_tile + kc * 16 * ROW, C::Q_BOX), 1);
      }
#pragma unroll
      for (int kc = 0; kc < BQB / 16; ++kc) {
        Wgmma<D>::template rs<1>(dk, sf[kc], sw128_desc(q_tile + kc * 16 * ROW, C::Q_BOX), 1);
      }
      wgmma_commit();
      fence_proxy_async();              // dS^T stores -> the wgmma that reads them
      named_bar_sync(1, 2 * 128);       // both warpgroups have stored their rows
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
      __syncwarp();
      if (lane == 0) mbar_arrive(&q_empty[s]);

      // dQ of the tile over all 128 kv rows, by the warpgroups in turn
      const int row = t * BQB + kr;
      if (i % 2 == wg) {
        if constexpr (D == 160) {  // in 64-column chunks: dK, dV and one chunk fit the registers
          dq_add<64, D>(ds, sK, 0, dq_bh, row, p.sq, p.scale, qd);
          dq_add<64, D>(ds, sK, 64, dq_bh, row, p.sq, p.scale, qd);
          dq_add<32, D>(ds, sK, 128, dq_bh, row, p.sq, p.scale, qd);
        } else {
          dq_add<D, D>(ds, sK, 0, dq_bh, row, p.sq, p.scale, qd);
        }
      }
    }

    // dk = dS^T q~ / log2(e): q~ = q * scale * log2(e), dk = dS^T q * scale
    const int64_t base = (int64_t)bh * p.skv * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * qd;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!(r ? ok1 : ok0)) continue;
        const int64_t at = base + (int64_t)(k0 + wg * 64 + kr + 8 * r) * D + col;
        const float2 gk = make_float2(dk[4 * c + 2 * r] * INV_LOG2E, dk[4 * c + 2 * r + 1] * INV_LOG2E);
        const float2 gv = make_float2(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
        if (p.splits == 1) {
          *reinterpret_cast<uint32_t*>(p.dk + at) = pack_bf16(gk.x, gk.y);
          *reinterpret_cast<uint32_t*>(p.dv + at) = pack_bf16(gv.x, gv.y);
        } else {
          atomicAdd(reinterpret_cast<float2*>(p.dk_acc + at), gk);
          atomicAdd(reinterpret_cast<float2*>(p.dv_acc + at), gv);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// head dim 512, bf16 forward: TMA, wgmma, O split over the warpgroups by column
// ---------------------------------------------------------------------------

constexpr int F5Q = 64;  // query rows per block
constexpr int F5K = 64;  // kv rows per tile

struct Fwd512Cfg {
  static constexpr int NB = 512 / 64;    // 64-column boxes across the head dim
  static constexpr int KS = 512 / 16;    // k16 steps over the head dim
  static constexpr int BOX = 64 * ROW;   // one box of 64 rows (q~, K and V alike)
  static constexpr int TILE = NB * BOX;  // q~, K or V: 64 rows x 512 columns, 64 KB
  static constexpr size_t SMEM = 1024 + 3 * TILE + 8 * 5;
  static_assert(F5Q == 64 && F5K == 64, "boxes are 64 rows");
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

__global__ void __launch_bounds__(NT_WS, 1) flash_fwd512_wgmma(const __grid_constant__ FwdTma p) {
  using C = Fwd512Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);  // [box][64 q rows]
  unsigned char* sK = sQ + C::TILE;         // [box][64 kv rows]
  unsigned char* sV = sK + C::TILE;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + C::TILE);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = q_full + 4;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * F5Q;
  const int n_tiles = (p.skv + F5K - 1) / F5K;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    mbar_init(k_empty, NCW);
    mbar_init(v_empty, NCW);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer: q~ once, then K and V of each tile, each as soon as the
    // consumers are done with the previous one (K while they run P V, V while
    // they run the next q~ K^T)
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      mbar_arrive_tx(q_full, C::TILE);
      for (int j = 0; j < C::NB; ++j) tma_load_4d(sQ + j * C::BOX, &p.q, q_full, 64 * j, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const uint32_t free_parity = (t & 1) ^ 1;
        mbar_wait(k_empty, free_parity);
        mbar_arrive_tx(k_full, C::TILE);
        for (int j = 0; j < C::NB; ++j) tma_load_4d(sK + j * C::BOX, &p.k, k_full, 64 * j, t * F5K, h, b);
        mbar_wait(v_empty, free_parity);
        mbar_arrive_tx(v_full, C::TILE);
        for (int j = 0; j < C::NB; ++j) tma_load_4d(sV + j * C::BOX, &p.v, v_full, 64 * j, t * F5K, h, b);
      }
    }
  } else {
    // consumers: both warpgroups own the block's 64 query rows; warpgroup wg
    // owns O's columns 256 wg .. +255. Each forms the whole S = q~ K^T (the same
    // products in the same order, so both hold the same S, max and sum), and
    // this thread holds rows `row` and `row + 8`, columns 8 c + 2 qd + {0, 1}
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int row = q0 + (warp % 4) * 16 + g;
    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float s_acc[F5K / 2];
    mbar_wait(q_full, 0);

    for (int t = 0; t < n_tiles; ++t) {
      const uint32_t parity = t & 1;
      mbar_wait(k_full, parity);
      // S = q~ K^T over the whole head dim, both K-major
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KS; ++kk) {
        Wgmma<F5K>::ss<0, 0>(s_acc, sw128_desc(sQ + kstep_offset(kk, C::BOX), 0),
                                      sw128_desc(sK + kstep_offset(kk, C::BOX), 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty);

      const int valid = p.skv - t * F5K;  // the kv tail: TMA's zero rows become -inf
      if (valid < F5K) {
#pragma unroll
        for (int c = 0; c < F5K / 8; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (8 * c + 2 * qd + j >= valid) s_acc[4 * c + j] = s_acc[4 * c + 2 + j] = -INFINITY;
          }
        }
      }

      // online softmax; every tile has a valid column, so the max is finite
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < F5K / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * c], s_acc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * c + 2], s_acc[4 * c + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      uint32_t pf[F5K / 16][4];  // P in bf16 as the A fragments of P V
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int c = 0; c < F5K / 8; ++c) {
        const float p00 = exp2f(s_acc[4 * c] - mx0), p01 = exp2f(s_acc[4 * c + 1] - mx0);
        const float p10 = exp2f(s_acc[4 * c + 2] - mx1), p11 = exp2f(s_acc[4 * c + 3] - mx1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pf[c / 2][(c % 2) * 2] = pack_bf16(p00, p01);
        pf[c / 2][(c % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = l0 * a0 + sum0;  // this thread's part of the row sum; the quad adds at the end
      l1 = l1 * a1 + sum1;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        o[4 * c] *= a0;
        o[4 * c + 1] *= a0;
        o[4 * c + 2] *= a1;
        o[4 * c + 3] *= a1;
      }

      // O[:, 256 wg ..] += P V[:, 256 wg ..], V MN-major: kv rows 16 kc.., boxes BOX apart
      mbar_wait(v_full, parity);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < F5K / 16; ++kc) {
        Wgmma<256>::rs<1>(o, pf[kc], sw128_desc(sV + 4 * wg * C::BOX + kc * 16 * ROW, C::BOX), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty);
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    bf16* o_bh = p.o + (int64_t)bh * p.sq * 512 + 256 * wg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 8 * c + 2 * qd;
      if (row < p.sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)row * 512 + col) = pack_bf16(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)(row + 8) * 512 + col) =
            pack_bf16(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
    }
    if (wg == 0 && qd == 0) {
      float* lse = p.lse + (int64_t)bh * p.sq;
      if (row < p.sq) lse[row] = m0 + log2f(l0);
      if (row + 8 < p.sq) lse[row + 8] = m1 + log2f(l1);
    }
  }
}

// ---------------------------------------------------------------------------
// head dim 512, bf16 backward: JAX's two passes on the TMA/wgmma pipeline
// ---------------------------------------------------------------------------

constexpr int B5 = 64;             // rows a block owns (q rows for dQ, kv rows for dK/dV) and rows of a tile
constexpr int BOX5 = 64 * ROW;     // one box: 64 rows x 64 columns, 8 KB
constexpr int TILE5 = 8 * BOX5;    // 64 rows x 512 columns, 64 KB

// dQ kernel: q~ and dO stay (128 KB), K of one tile stays until dQ is formed
// (64 KB), V streams box by box through a ring of 3 (24 KB), dS one box (8 KB):
// 229,376 bytes and the barriers, of the 232,448 a block has.
struct BwdDq512Cfg {
  static constexpr int V_SLOTS = 3;
  static constexpr size_t SMEM = 1024 + 3 * TILE5 + V_SLOTS * BOX5 + BOX5 + 8 * (3 + 2 * V_SLOTS);
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

// dK/dV kernel: K and V stay (128 KB); per q tile the owned column half of q~
// and of dO (32 KB each) stays until dK and dV are formed, the other half's
// boxes stream through a ring of 2 (16 KB); P^T and dS^T one box each, LSE
// and Di of the tile (512 bytes): 230,400 bytes and the barriers.
struct BwdKv512Cfg {
  static constexpr int RING = 2;
  static constexpr int HALF = 4 * BOX5;
  static constexpr size_t SMEM = 1024 + 2 * TILE5 + RING * BOX5 + 2 * HALF + 2 * BOX5 + 2 * B5 * sizeof(float) +
                                 8 * (3 + 2 * RING);
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct Bwd512Tma {
  CUtensorMap q, k, v, dout;  // boxes of 64 columns x 64 rows
  const float* lse;           // [B, H, Sq]
  const float* di;            // [B, H, Sq] rowsum(dO * O)
  bf16* dq;                   // [B, H, Sq, 512]: dS K scale
  bf16* dk;                   // [B, H, Skv, 512]: dS^T q~ / log2(e)
  bf16* dv;                   // [B, H, Skv, 512]: P^T dO
  float scale;
  int heads, sq, skv;
};

// dQ = (P (dO V^T - Di)) K scale, q-stationary: a block owns 64 q rows (8 x 1 x
// 1024 gives 128 blocks, one wave). Warpgroup w forms S and dP for keys 32 w ..
// +31 of each 64-key tile (so P stays in fp32 registers and nothing but dS
// crosses shared memory), dS for them into the shared dS tile, then dQ[:, 256 w
// ..] += dS K over the tile's 64 keys. dP comes first, from the V ring, so the
// tile's K lands meanwhile.
__global__ void __launch_bounds__(NT_WS, 1) flash_bwd512_dq_wgmma(const __grid_constant__ Bwd512Tma p) {
  using C = BwdDq512Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);  // [box][64 q rows]
  unsigned char* sdO = sQ + TILE5;
  unsigned char* sK = sdO + TILE5;          // [box][64 keys]
  unsigned char* sV = sK + TILE5;           // [slot]: one box of 64 keys
  unsigned char* sdS = sV + C::V_SLOTS * BOX5;  // 64 q rows x 64 keys
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sdS + BOX5);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = q_full + 2;
  uint64_t* v_full = q_full + 3;
  uint64_t* v_empty = v_full + C::V_SLOTS;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * B5;
  const int n_tiles = (p.skv + B5 - 1) / B5;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(k_empty, NCW);
    for (int s = 0; s < C::V_SLOTS; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer warp 0: q~ and dO once, then each tile's K once the last tile's
    // dQ product is done; producer warp 1: the V boxes through their ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      mbar_arrive_tx(q_full, 2 * TILE5);
      for (int j = 0; j < 8; ++j) {
        tma_load_4d(sQ + j * BOX5, &p.q, q_full, 64 * j, q0, h, b);
        tma_load_4d(sdO + j * BOX5, &p.dout, q_full, 64 * j, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(k_empty, (t & 1) ^ 1);
        mbar_arrive_tx(k_full, TILE5);
        for (int j = 0; j < 8; ++j) tma_load_4d(sK + j * BOX5, &p.k, k_full, 64 * j, t * B5, h, b);
      }
    } else if (warp == NCW + 1 && lane == 0) {
      for (int n = 0; n < 8 * n_tiles; ++n) {
        const int slot = n % C::V_SLOTS;
        mbar_wait(&v_empty[slot], ((n / C::V_SLOTS) & 1) ^ 1);
        mbar_arrive_tx(&v_full[slot], BOX5);
        tma_load_4d(sV + slot * BOX5, &p.v, &v_full[slot], 64 * (n % 8), (n / 8) * B5, h, b);
      }
    }
  } else {
    // consumers: this thread holds q rows r and r + 8 of the block, keys
    // key0 + 8 c + 2 qd + {0, 1} of S and dP, and dQ's columns 256 wg + 8 c +
    // 2 qd + {0, 1}
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int r = (warp % 4) * 16 + g, row = q0 + r;
    const int key0 = 32 * wg;
    const float* lse = p.lse + (int64_t)bh * p.sq;
    const float* di = p.di + (int64_t)bh * p.sq;
    // rows past Sq (TMA's zero rows) get P = 0
    const float L0 = row < p.sq ? lse[row] : INFINITY, L1 = row + 8 < p.sq ? lse[row + 8] : INFINITY;
    const float D0 = row < p.sq ? di[row] : 0.0f, D1 = row + 8 < p.sq ? di[row + 8] : 0.0f;
    float dq[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) dq[i] = 0.0f;
    float s_acc[16], dp_acc[16];
    mbar_wait(q_full, 0);

    int n = 0;  // V boxes taken from the ring
    for (int t = 0; t < n_tiles; ++t) {
      // dP = dO V^T, V box by box; each box's slot is freed once its group is done
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j, ++n) {
        const int slot = n % C::V_SLOTS;
        mbar_wait(&v_full[slot], (n / C::V_SLOTS) & 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          Wgmma<32>::ss<0, 0>(dp_acc, sw128_desc(sdO + j * BOX5 + 32 * kk, 0),
                              sw128_desc(sV + slot * BOX5 + key0 * ROW + 32 * kk, 0), j > 0 || kk > 0);
        }
        wgmma_commit();
        if (j > 0) {
          wgmma_wait<1>();
          release_slot(&v_empty[(n - 1) % C::V_SLOTS], lane);
        }
      }
      // S = q~ K^T, both K-major
      mbar_wait(k_full, t & 1);
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) {
        Wgmma<32>::ss<0, 0>(s_acc, sw128_desc(sQ + kstep_offset(kk, BOX5), 0),
                            sw128_desc(sK + kstep_offset(kk, BOX5) + key0 * ROW, 0), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_acc);
      reg_fence(dp_acc);
      release_slot(&v_empty[(n - 1) % C::V_SLOTS], lane);

      // P = 2^(S - LSE), 0 on keys past Skv (TMA's zero rows); dS = P (dP - Di)
      // in bf16 into sdS, in the 128-byte swizzle TMA would write
      const int valid = p.skv - t * B5 - key0;
      named_bar_sync(1, 2 * 128);  // both warpgroups' dQ products of the last tile have read sdS
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = 8 * c + 2 * qd;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = j + e < valid;
          ds[e] = ok ? exp2f(s_acc[4 * c + e] - L0) * (dp_acc[4 * c + e] - D0) : 0.0f;
          ds[2 + e] = ok ? exp2f(s_acc[4 * c + 2 + e] - L1) * (dp_acc[4 * c + 2 + e] - D1) : 0.0f;
        }
        const int chunk = ((4 * wg + c) ^ (r & 7)) * 16 + qd * 4;  // rows r and r + 8 share r % 8
        *reinterpret_cast<uint32_t*>(sdS + r * ROW + chunk) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(sdS + (r + 8) * ROW + chunk) = pack_bf16(ds[2], ds[3]);
      }
      fence_proxy_async();         // dS's stores -> the wgmma that reads them
      named_bar_sync(2, 2 * 128);  // both warpgroups' keys of dS are in

      // dQ[:, 256 wg ..] += dS K[:, 256 wg ..]: dS K-major, K MN-major (keys 16 kc.., boxes BOX5 apart)
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        Wgmma<256>::ss<0, 1>(dq, sw128_desc(sdS + 32 * kc, 0), sw128_desc(sK + 4 * wg * BOX5 + kc * 16 * ROW, BOX5), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
      release_slot(k_empty, lane);
    }

    bf16* dq_bh = p.dq + (int64_t)bh * p.sq * 512 + 256 * wg;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = 8 * c + 2 * qd;
      if (row < p.sq) {
        *reinterpret_cast<uint32_t*>(dq_bh + (int64_t)row * 512 + col) =
            pack_bf16(dq[4 * c] * p.scale, dq[4 * c + 1] * p.scale);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<uint32_t*>(dq_bh + (int64_t)(row + 8) * 512 + col) =
            pack_bf16(dq[4 * c + 2] * p.scale, dq[4 * c + 3] * p.scale);
      }
    }
  }
}

// dK = dS^T q~ / log2(e), dV = P^T dO, kv-stationary: a block owns 64 kv rows and
// one 256-column half of dK and dV (two blocks a kv tile: 8 x 1 x 1024 gives
// 256) and walks q in tiles of 64. Warpgroup w forms S^T = K q~^T and dP^T = V
// dO^T for q columns 32 w .. +31 of each tile, P^T and dS^T for them into the
// shared P^T and dS^T tiles; then warpgroup 0 forms dV += P^T dO and warpgroup 1
// dK += dS^T q~ over the owned half. The logits take the other half's boxes
// first, from the ring, so the owned half of the tile lands meanwhile.
__global__ void __launch_bounds__(NT_WS, 1) flash_bwd512_dkv_wgmma(const __grid_constant__ Bwd512Tma p) {
  using C = BwdKv512Cfg;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align1024(smem_raw);  // [box][64 kv rows]
  unsigned char* sV = sK + TILE5;
  unsigned char* ring = sV + TILE5;         // [slot]: one box of 64 q rows
  unsigned char* sHq = ring + C::RING * BOX5;  // the owned half of q~'s tile: [box][64 q rows]
  unsigned char* sHd = sHq + C::HALF;          // and of dO's
  unsigned char* sP = sHd + C::HALF;           // P^T: 64 kv rows x 64 q
  unsigned char* sdS = sP + BOX5;              // dS^T
  float* sLse = reinterpret_cast<float*>(sdS + BOX5);  // the tile's LSE and Di
  float* sDi = sLse + B5;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sDi + B5);
  uint64_t* h_full = kv_full + 1;
  uint64_t* h_empty = kv_full + 2;
  uint64_t* r_full = kv_full + 3;
  uint64_t* r_empty = r_full + C::RING;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int col_half = blockIdx.x % 2, k0 = (blockIdx.x / 2) * B5;
  const int own = 4 * col_half, other = 4 - own;  // the first box of the owned and of the other column half
  const int q_tiles = (p.sq + B5 - 1) / B5;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(h_full, 32);  // the producer warp's lanes (LSE and Di) and the TMA bytes
    mbar_init(h_empty, NCW);
    for (int s = 0; s < C::RING; ++s) {
      mbar_init(&r_full[s], 1);
      mbar_init(&r_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer warp 0: K and V once, then per q tile the other half's boxes of
    // q~ and of dO through the ring; producer warp 1: per q tile the owned
    // half's boxes by TMA and LSE, Di by its lanes, once dK and dV of the last
    // tile are formed
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      mbar_arrive_tx(kv_full, 2 * TILE5);
      for (int j = 0; j < 8; ++j) {
        tma_load_4d(sK + j * BOX5, &p.k, kv_full, 64 * j, k0, h, b);
        tma_load_4d(sV + j * BOX5, &p.v, kv_full, 64 * j, k0, h, b);
      }
      for (int n = 0; n < 8 * q_tiles; ++n) {
        const int slot = n % C::RING, i = n % 8;
        mbar_wait(&r_empty[slot], ((n / C::RING) & 1) ^ 1);
        mbar_arrive_tx(&r_full[slot], BOX5);
        tma_load_4d(ring + slot * BOX5, i < 4 ? &p.q : &p.dout, &r_full[slot], 64 * (other + i % 4), (n / 8) * B5, h,
                    b);
      }
    } else if (warp == NCW + 1) {
      const float* lse = p.lse + (int64_t)bh * p.sq;
      const float* di = p.di + (int64_t)bh * p.sq;
      for (int t = 0; t < q_tiles; ++t) {
        mbar_wait(h_empty, (t & 1) ^ 1);
        if (lane == 0) {  // the boxes first, so the loads below overlap their flight
          mbar_expect_tx(h_full, 2 * C::HALF);
          for (int j = 0; j < 4; ++j) {
            tma_load_4d(sHq + j * BOX5, &p.q, h_full, 64 * (own + j), t * B5, h, b);
            tma_load_4d(sHd + j * BOX5, &p.dout, h_full, 64 * (own + j), t * B5, h, b);
          }
        }
        for (int i = lane; i < B5; i += 32) {
          const int q = t * B5 + i;
          sLse[i] = q < p.sq ? lse[q] : INFINITY;  // q rows past Sq get P = 0
          sDi[i] = q < p.sq ? di[q] : 0.0f;
        }
        mbar_arrive(h_full);  // each lane after its own stores
      }
    }
  } else {
    // consumers: this thread holds kv rows r and r + 8 of the block, q columns
    // 32 wg + 8 c + 2 qd + {0, 1} of S^T and dP^T, and dV's (warpgroup 0) or
    // dK's (1) columns 256 col_half + 8 c + 2 qd + {0, 1}
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int r = (warp % 4) * 16 + g;
    const int col0 = 32 * wg;
    const bool ok0 = k0 + r < p.skv, ok1 = k0 + r + 8 < p.skv;
    float acc[128];  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    float s_acc[16], dp_acc[16];
    mbar_wait(kv_full, 0);

    int n = 0;  // boxes taken from the ring
    for (int t = 0; t < q_tiles; ++t) {
      // S^T = K q~^T, dP^T = V dO^T (A the kv rows, B the q rows, both K-major):
      // the other half's head-dim chunks box by box from the ring, then the owned half's
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < 8; ++i, ++n) {
        const int slot = n % C::RING;
        mbar_wait(&r_full[slot], (n / C::RING) & 1);
        const unsigned char* a = (i < 4 ? sK : sV) + (other + i % 4) * BOX5;
        const unsigned char* bq = ring + slot * BOX5 + col0 * ROW;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (i < 4) {
            Wgmma<32>::ss<0, 0>(s_acc, sw128_desc(a + 32 * kk, 0), sw128_desc(bq + 32 * kk, 0), i > 0 || kk > 0);
          } else {
            Wgmma<32>::ss<0, 0>(dp_acc, sw128_desc(a + 32 * kk, 0), sw128_desc(bq + 32 * kk, 0), i > 4 || kk > 0);
          }
        }
        wgmma_commit();
        if (i > 0) {
          wgmma_wait<1>();
          release_slot(&r_empty[(n - 1) % C::RING], lane);
        }
      }
      mbar_wait(h_full, t & 1);
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        Wgmma<32>::ss<0, 0>(s_acc, sw128_desc(sK + own * BOX5 + kstep_offset(kk, BOX5), 0),
                            sw128_desc(sHq + kstep_offset(kk, BOX5) + col0 * ROW, 0), 1);
      }
#pragma unroll
      for (int kk = 0; kk < 16; ++kk) {
        Wgmma<32>::ss<0, 0>(dp_acc, sw128_desc(sV + own * BOX5 + kstep_offset(kk, BOX5), 0),
                            sw128_desc(sHd + kstep_offset(kk, BOX5) + col0 * ROW, 0), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s_acc);
      reg_fence(dp_acc);
      release_slot(&r_empty[(n - 1) % C::RING], lane);

      // P^T = 2^(S^T - LSE), 0 on kv rows past Skv and (by their infinite LSE) on q
      // columns past Sq; dS^T = P^T (dP^T - Di); both in bf16 into their shared
      // tiles, in the 128-byte swizzle TMA would write
      named_bar_sync(1, 2 * 128);  // both warpgroups' dV and dK products of the last tile have read them
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = col0 + 8 * c + 2 * qd;
        const float2 L = *reinterpret_cast<const float2*>(sLse + j);
        const float2 Di = *reinterpret_cast<const float2*>(sDi + j);
        const float p00 = ok0 ? exp2f(s_acc[4 * c] - L.x) : 0.0f;
        const float p01 = ok0 ? exp2f(s_acc[4 * c + 1] - L.y) : 0.0f;
        const float p10 = ok1 ? exp2f(s_acc[4 * c + 2] - L.x) : 0.0f;
        const float p11 = ok1 ? exp2f(s_acc[4 * c + 3] - L.y) : 0.0f;
        const int chunk = ((4 * wg + c) ^ (r & 7)) * 16 + qd * 4;  // rows r and r + 8 share r % 8
        *reinterpret_cast<uint32_t*>(sP + r * ROW + chunk) = pack_bf16(p00, p01);
        *reinterpret_cast<uint32_t*>(sP + (r + 8) * ROW + chunk) = pack_bf16(p10, p11);
        *reinterpret_cast<uint32_t*>(sdS + r * ROW + chunk) =
            pack_bf16(p00 * (dp_acc[4 * c] - Di.x), p01 * (dp_acc[4 * c + 1] - Di.y));
        *reinterpret_cast<uint32_t*>(sdS + (r + 8) * ROW + chunk) =
            pack_bf16(p10 * (dp_acc[4 * c + 2] - Di.x), p11 * (dp_acc[4 * c + 3] - Di.y));
      }
      fence_proxy_async();         // the stores -> the wgmma that reads them
      named_bar_sync(2, 2 * 128);  // both warpgroups' q columns are in

      // dV += P^T dO (warpgroup 0) or dK += dS^T q~ (1) over the owned half: A
      // K-major, B MN-major (q rows 16 kc.., boxes BOX5 apart)
      const unsigned char* a = wg ? sdS : sP;
      const unsigned char* owned = wg ? sHq : sHd;
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        Wgmma<256>::ss<0, 1>(acc, sw128_desc(a + 32 * kc, 0), sw128_desc(owned + kc * 16 * ROW, BOX5), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
      release_slot(h_empty, lane);
    }

    // dk = dS^T q~ / log2(e): q~ = q * scale * log2(e), dk = dS^T q * scale
    const float mul = wg ? INV_LOG2E : 1.0f;
    bf16* out = (wg ? p.dk : p.dv) + (int64_t)bh * p.skv * 512 + 256 * col_half;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = k0 + r + 8 * e;
        if (row < p.skv) {
          *reinterpret_cast<uint32_t*>(out + (int64_t)row * 512 + 8 * c + 2 * qd) =
              pack_bf16(acc[4 * c + 2 * e] * mul, acc[4 * c + 2 * e + 1] * mul);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 forward and backward (split TF32), templated over the padded head dim DP
// ---------------------------------------------------------------------------

// ---- fp32 forward: split-TF32 wgmma ------------------------------------------

constexpr int FKT = 64;  // fp32 forward: kv rows (keys) per tile
constexpr uint32_t TF32_MASK = 0xffffe000u;

// x rounded to the nearest tf32 (ties away from zero), its low 13 bits clear
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r & TF32_MASK);
}

// x = hi + lo + e: hi the nearest tf32 to x, lo the nearest tf32 to x - hi
// (exact in fp32, |x - hi| <= 2^-11 |x|), so |e| <= 2^-22 |x|
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// hi and lo of a strided fp32 [B, H, S, DP] operand (unit stride on DP, rows
// 16-byte aligned) into dst [2][B*H][S][DP], contiguous: four columns a thread
__global__ void __launch_bounds__(256) flash_f32_split_rows(const float* src, int64_t sb, int64_t sh, int64_t ss,
                                                            int heads, int rows, int dp, int64_t total4, float* dst) {
  const int64_t plane = total4 * 4;  // elements of one of hi, lo
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total4; i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t e = i * 4, r = e / dp, bh = r / rows;
    const int col = (int)(e % dp), row = (int)(r % rows);
    const float4 x = *reinterpret_cast<const float4*>(src + (bh / heads) * sb + (bh % heads) * sh + row * ss + col);
    float4 hi, lo;
    tf32_split(x.x, hi.x, lo.x);
    tf32_split(x.y, hi.y, lo.y);
    tf32_split(x.z, hi.z, lo.z);
    tf32_split(x.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(dst + e) = hi;
    *reinterpret_cast<float4*>(dst + plane + e) = lo;
  }
}

// hi and lo of X^T (V^T in the forward; K^T, q~^T, dO^T in the backward): X
// strided fp32 [B, H, S, DP] (unit stride on DP) into dst [2][B*H][DP][skv4],
// contiguous (skv4 = S rounded up to 4; rows past S are zero), through 32 x 32
// tiles so that reads and writes are both coalesced
__global__ void __launch_bounds__(256) flash_f32_split_vt(const float* src, int64_t sb, int64_t sh, int64_t ss,
                                                          int heads, int skv, int skv4, int dp, float* dst) {
  __shared__ float tile[32][33];
  const int bh = blockIdx.z, key0 = blockIdx.x * 32, col0 = blockIdx.y * 32;
  const float* v = src + (bh / heads) * sb + (bh % heads) * sh;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int key = key0 + r;
    tile[r][threadIdx.x] = key < skv ? v[(int64_t)key * ss + col0 + threadIdx.x] : 0.0f;
  }
  __syncthreads();
  const int64_t plane = (int64_t)gridDim.z * dp * skv4;
  const int key = key0 + threadIdx.x;
  if (key >= skv4) return;
  for (int r = threadIdx.y; r < 32; r += 8) {
    float hi, lo;
    tf32_split(tile[threadIdx.x][r], hi, lo);
    const int64_t at = ((int64_t)bh * dp + col0 + r) * skv4 + key;
    dst[at] = hi;
    dst[plane + at] = lo;
  }
}

template <int DP>
struct FwdF32Cfg {
  static constexpr bool WIDE = DP == 512;        // O split by column over the two warpgroups
  static constexpr int QR = WIDE ? 64 : 128;     // query rows per block
  static constexpr int NC = DP / 32;             // 32-column chunks of the head dim
  static constexpr int SN = WIDE ? 32 : FKT;     // logits columns a warpgroup forms per tile
  static constexpr int ON = WIDE ? 256 : DP;     // O columns a warpgroup owns
  static constexpr int Q_BOX = QR * ROW;         // 32 columns of the block's q~ rows
  static constexpr int K_BOX = FKT * ROW;        // 32 columns of a tile's keys
  static constexpr int V_ROWS = WIDE ? 64 : DP;  // rows of V^T (O columns) in one box
  static constexpr int V_BOX = V_ROWS * ROW;     // 32 keys of them
  static constexpr int S_STAGE = 2 * Q_BOX + 2 * K_BOX;     // q~ and K chunks, hi and lo
  static constexpr int PV_STAGE = (WIDE ? 4 : 2) * V_BOX;   // V^T hi and lo (of both warpgroups at 512)
  static constexpr int PV_STAGES = WIDE ? 8 : 2;  // per tile: key halves (x 4 column blocks at 512)
  static constexpr int SLOT = S_STAGE > PV_STAGE ? S_STAGE : PV_STAGE;
  static constexpr int SLOTS = WIDE ? 5 : 3;
  static constexpr int P_BOX = 64 * ROW;          // 32 keys of P for 64 rows
  static constexpr int P_BYTES = 4 * P_BOX;       // hi and lo of a tile's 64 keys
  static constexpr int N_P = WIDE ? 1 : 2;        // one P shared at 512, else one a warpgroup
  static constexpr size_t SMEM = 1024 + (size_t)SLOTS * SLOT + N_P * P_BYTES + 2 * 64 * sizeof(float) +
                                 8 * 2 * SLOTS;
  static_assert(DP % 32 == 0 && (WIDE || DP <= 256), "V^T boxes hold at most 256 rows");
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct FwdF32Tma {
  CUtensorMap q, k, vt;  // split operands [2 (hi, lo), B*H, rows, cols]: boxes of 32 columns
  float* o;              // [B, H, Sq, DP] contiguous
  float* lse;            // [B, H, Sq] contiguous
  int sq, skv;
};

// d (+)= q~ K^T over one 32-column chunk of the head dim (four k8 steps), the
// small products (hi.lo, lo.hi) first and hi.hi last, as in pv_tile_tf32
template <int N>
__device__ __forceinline__ void qk_chunk_tf32(float (&d)[N / 2], const unsigned char* qh, const unsigned char* ql,
                                              const unsigned char* kh, const unsigned char* kl, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    WgmmaTf32<N>::ss(d, sw128_desc(qh + 32 * kk, 0), sw128_desc(kl + 32 * kk, 0), accumulate || kk > 0);
    WgmmaTf32<N>::ss(d, sw128_desc(ql + 32 * kk, 0), sw128_desc(kh + 32 * kk, 0), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) WgmmaTf32<N>::ss(d, sw128_desc(qh + 32 * kk, 0), sw128_desc(kh + 32 * kk, 0), 1);
}

// d = P V over a tile's 64 keys (two V^T stages of 32 keys each), into a fresh
// accumulator: P (64 rows) and V^T (N rows) both K-major, hi boxes at ph and
// vh0 / vh1, lo boxes P_LO and v_lo bytes on. The tensor cores sum a wgmma's
// products into the accumulator with an error of the order of its last bit, so
// the small products (hi.lo, lo.hi) go first, while the sum is small, and hi.hi
// last; the caller adds the tile into O in fp32, so the error does not grow
// with the number of tiles.
template <int N>
__device__ __forceinline__ void pv_tile_tf32(float (&d)[N / 2], const unsigned char* ph, const unsigned char* vh0,
                                             const unsigned char* vh1, int v_lo) {
  constexpr int P_BOX = 64 * ROW, P_LO = 2 * P_BOX;
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned char* pk = ph + kh * P_BOX + 32 * kk;
      const unsigned char* vk = (kh ? vh1 : vh0) + 32 * kk;
      WgmmaTf32<N>::ss(d, sw128_desc(pk, 0), sw128_desc(vk + v_lo, 0), kh > 0 || kk > 0);
      WgmmaTf32<N>::ss(d, sw128_desc(pk + P_LO, 0), sw128_desc(vk, 0), 1);
    }
  }
#pragma unroll
  for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      WgmmaTf32<N>::ss(d, sw128_desc(ph + kh * P_BOX + 32 * kk, 0), sw128_desc((kh ? vh1 : vh0) + 32 * kk, 0), 1);
    }
  }
}

// acc = A B^T over G 32-column chunks of the head dim, one ring stage each (A's hi
// at a_off, its lo a_lo bytes on; B's at b_off, b_lo), summed in place in a fresh
// accumulator; each chunk's products in flight while the next chunk is awaited,
// and every slot released once its products are done
template <int N, int G>
__device__ __forceinline__ void chunks_tf32(float (&acc)[N / 2], const unsigned char* ring, int slot_bytes,
                                            int slots, uint64_t* full, uint64_t* empty, int& n, int a_off, int a_lo,
                                            int b_off, int b_lo, int lane) {
#pragma unroll 1
  for (int c = 0; c < G; ++c, ++n) {
    const int slot = n % slots;
    mbar_wait(&full[slot], (n / slots) & 1);
    const unsigned char* st = ring + slot * slot_bytes;
    wgmma_fence();
    qk_chunk_tf32<N>(acc, st + a_off, st + a_off + a_lo, st + b_off, st + b_off + b_lo, c > 0);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      release_slot(&empty[(n - 1) % slots], lane);
    }
  }
  wgmma_wait<0>();
  reg_fence(acc);
  release_slot(&empty[(n - 1) % slots], lane);
}

template <int DP>
__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_f32_wgmma(const __grid_constant__ FwdF32Tma p) {
  using C = FwdF32Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);                       // [slot] stages
  unsigned char* sP = ring + C::SLOTS * C::SLOT;                   // [buffer][hi, lo][key half]
  float* red = reinterpret_cast<float*>(sP + C::N_P * C::P_BYTES);  // [warpgroup][64 rows]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 64);
  uint64_t* empty = full + C::SLOTS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::QR;
  const int n_tiles = (p.skv + FKT - 1) / FKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer: per kv tile, NC stages of (q~, K) chunks along the head dim,
    // then PV_STAGES stages of V^T, all through one ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      int n = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int i = 0; i < C::NC + C::PV_STAGES; ++i, ++n) {
          const int slot = n % C::SLOTS;
          unsigned char* st = ring + slot * C::SLOT;
          uint64_t* bar = &full[slot];
          mbar_wait(&empty[slot], ((n / C::SLOTS) & 1) ^ 1);
          if (i < C::NC) {
            mbar_arrive_tx(bar, C::S_STAGE);
            for (int part = 0; part < 2; ++part) {
              tma_load_4d(st + part * C::Q_BOX, &p.q, bar, 32 * i, q0, bh, part);
              tma_load_4d(st + 2 * C::Q_BOX + part * C::K_BOX, &p.k, bar, 32 * i, t * FKT, bh, part);
            }
          } else {
            const int v = i - C::NC;
            const int key = t * FKT + 32 * (v % 2);
            mbar_arrive_tx(bar, C::PV_STAGE);
            for (int part = 0; part < 2; ++part) {
              if constexpr (C::WIDE) {  // column block v / 2 of each warpgroup's 256 columns
                for (int w = 0; w < 2; ++w) {
                  tma_load_4d(st + (2 * part + w) * C::V_BOX, &p.vt, bar, key, 256 * w + 64 * (v / 2), bh, part);
                }
              } else {
                tma_load_4d(st + part * C::V_BOX, &p.vt, bar, key, 0, bh, part);
              }
            }
          }
        }
      }
    }
  } else {
    // consumers. DP <= 160: warpgroup wg owns query rows wg * 64 .. +63 of the
    // block, all of a tile's logits and all of O's columns. DP = 512: both own
    // the block's 64 rows; warpgroup wg forms the logits of keys 32 wg .. +31 of
    // each tile and owns O's columns 256 wg .. +255. This thread holds rows r and
    // r + 8 of the warpgroup's 64, columns 8 c + 2 qd + {0, 1} of the accumulators
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int r = (warp % 4) * 16 + g;
    const int row = q0 + (C::WIDE ? 0 : wg * 64) + r;
    const int key0 = C::WIDE ? 32 * wg : 0;  // this warpgroup's first key of a tile
    unsigned char* pbuf = sP + (C::WIDE ? 0 : wg * C::P_BYTES);
    float o[C::ON / 2];
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) o[i] = 0.0f;
    float o_tile[C::WIDE ? 32 : DP / 2];  // one tile's P V, added into O in fp32
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
    float s_acc[C::SN / 2];
    int n = 0;

    for (int t = 0; t < n_tiles; ++t) {
      // S = q~ K^T in 32-column chunks of the head dim, each chunk's products in
      // flight while the next chunk is awaited. At 512 (128 k8 steps, 384
      // wgmmas) each chunk goes to a fresh accumulator that is added into S in
      // fp32, as O's tiles are (pv_tile_tf32); at DP <= 160 the chunks sum in place
      if constexpr (C::WIDE) {
        float s_part[2][C::SN / 2];
#pragma unroll
        for (int c = 0; c < C::NC; ++c, ++n) {
          const int slot = n % C::SLOTS;
          mbar_wait(&full[slot], (n / C::SLOTS) & 1);
          const unsigned char* st = ring + slot * C::SLOT;
          const unsigned char* kh = st + 2 * C::Q_BOX + key0 * ROW;
          wgmma_fence();
          qk_chunk_tf32<C::SN>(s_part[c % 2], st, st + C::Q_BOX, kh, kh + C::K_BOX, 0);
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();
            reg_fence(s_part[(c - 1) % 2]);
            release_slot(&empty[(n - 1) % C::SLOTS], lane);
#pragma unroll
            for (int i = 0; i < C::SN / 2; ++i) s_acc[i] = c == 1 ? s_part[0][i] : s_acc[i] + s_part[(c - 1) % 2][i];
          }
        }
        wgmma_wait<0>();
        reg_fence(s_part[(C::NC - 1) % 2]);
        release_slot(&empty[(n - 1) % C::SLOTS], lane);
#pragma unroll
        for (int i = 0; i < C::SN / 2; ++i) s_acc[i] += s_part[(C::NC - 1) % 2][i];
      } else {
        chunks_tf32<C::SN, C::NC>(s_acc, ring, C::SLOT, C::SLOTS, full, empty, n, wg * 64 * ROW, C::Q_BOX,
                                  2 * C::Q_BOX, C::K_BOX, lane);
      }

      const int valid = p.skv - t * FKT - key0;  // the kv tail: TMA's zero rows become -inf
      if (valid < C::SN) {
#pragma unroll
        for (int c = 0; c < C::SN / 8; ++c) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (8 * c + 2 * qd + j >= valid) s_acc[4 * c + j] = s_acc[4 * c + 2 + j] = -INFINITY;
          }
        }
      }

      // online softmax; at 512 the two warpgroups' row maxima meet in shared
      // memory, and each keeps its own part of the row sum (added at the end)
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int c = 0; c < C::SN / 8; ++c) {
        mx0 = fmaxf(mx0, fmaxf(s_acc[4 * c], s_acc[4 * c + 1]));
        mx1 = fmaxf(mx1, fmaxf(s_acc[4 * c + 2], s_acc[4 * c + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if constexpr (C::WIDE) {
        if (qd == 0) {
          red[wg * 64 + r] = mx0;
          red[wg * 64 + r + 8] = mx1;
        }
        named_bar_sync(1, 2 * 128);
        mx0 = fmaxf(mx0, red[(wg ^ 1) * 64 + r]);
        mx1 = fmaxf(mx1, red[(wg ^ 1) * 64 + r + 8]);
      }
      const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      // P = 2^(S - max) as tf32 hi and lo into shared memory, K-major in the
      // 128-byte swizzle that TMA writes: key j of row r at box j / 32, row r,
      // 16-byte chunk (j % 32) / 4 XOR r % 8 (rows r and r + 8 share r % 8)
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int c = 0; c < C::SN / 8; ++c) {
        const float p00 = exp2f(s_acc[4 * c] - mx0), p01 = exp2f(s_acc[4 * c + 1] - mx0);
        const float p10 = exp2f(s_acc[4 * c + 2] - mx1), p11 = exp2f(s_acc[4 * c + 3] - mx1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        const int j = key0 + 8 * c + 2 * qd;
        unsigned char* at = pbuf + (j / 32) * C::P_BOX + r * ROW + ((((j % 32) / 4) ^ (r & 7)) * 16) + (j % 4) * 4;
        float2 h0, l0v, h1, l1v;
        tf32_split(p00, h0.x, l0v.x);
        tf32_split(p01, h0.y, l0v.y);
        tf32_split(p10, h1.x, l1v.x);
        tf32_split(p11, h1.y, l1v.y);
        *reinterpret_cast<float2*>(at) = h0;
        *reinterpret_cast<float2*>(at + 8 * ROW) = h1;
        *reinterpret_cast<float2*>(at + 2 * C::P_BOX) = l0v;
        *reinterpret_cast<float2*>(at + 2 * C::P_BOX + 8 * ROW) = l1v;
      }
      l0 = l0 * a0 + sum0;  // this thread's part of the row sum; the quad adds at the end
      l1 = l1 * a1 + sum1;
      fence_proxy_async();  // P's stores -> the wgmma that reads them
      if constexpr (C::WIDE) {
        named_bar_sync(1, 2 * 128);
      } else {
        named_bar_sync(2 + wg, 128);
      }

      // O = O a + P V: each tile's P V in a fresh accumulator (pv_tile_tf32) over
      // two V^T stages of 32 keys; at 512 in four blocks of 64 columns
#pragma unroll
      for (int j = 0; j < C::PV_STAGES / 2; ++j, n += 2) {
        const int slot0 = n % C::SLOTS, slot1 = (n + 1) % C::SLOTS;
        mbar_wait(&full[slot0], (n / C::SLOTS) & 1);
        mbar_wait(&full[slot1], ((n + 1) / C::SLOTS) & 1);
        const unsigned char* v0 = ring + slot0 * C::SLOT + (C::WIDE ? wg * C::V_BOX : 0);
        const unsigned char* v1 = ring + slot1 * C::SLOT + (C::WIDE ? wg * C::V_BOX : 0);
        constexpr int TN = C::WIDE ? 64 : DP;
        float* oj = o + (TN / 2) * j;
        wgmma_fence();
        pv_tile_tf32<TN>(o_tile, pbuf, v0, v1, (C::WIDE ? 2 : 1) * C::V_BOX);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o_tile);
        release_slot(&empty[slot0], lane);
        release_slot(&empty[slot1], lane);
#pragma unroll
        for (int c = 0; c < TN / 8; ++c) {
          oj[4 * c] = fmaf(oj[4 * c], a0, o_tile[4 * c]);
          oj[4 * c + 1] = fmaf(oj[4 * c + 1], a0, o_tile[4 * c + 1]);
          oj[4 * c + 2] = fmaf(oj[4 * c + 2], a1, o_tile[4 * c + 2]);
          oj[4 * c + 3] = fmaf(oj[4 * c + 3], a1, o_tile[4 * c + 3]);
        }
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if constexpr (C::WIDE) {  // the other warpgroup's keys
      if (qd == 0) {
        red[wg * 64 + r] = l0;
        red[wg * 64 + r + 8] = l1;
      }
      named_bar_sync(1, 2 * 128);
      l0 += red[(wg ^ 1) * 64 + r];
      l1 += red[(wg ^ 1) * 64 + r + 8];
    }
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
    float* o_bh = p.o + (int64_t)bh * p.sq * DP + (C::WIDE ? 256 * wg : 0);
#pragma unroll
    for (int c = 0; c < C::ON / 8; ++c) {
      const int col = 8 * c + 2 * qd;
      if (row < p.sq) {
        *reinterpret_cast<float2*>(o_bh + (int64_t)row * DP + col) = make_float2(o[4 * c] * inv0, o[4 * c + 1] * inv0);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<float2*>(o_bh + (int64_t)(row + 8) * DP + col) =
            make_float2(o[4 * c + 2] * inv1, o[4 * c + 3] * inv1);
      }
    }
    if ((!C::WIDE || wg == 0) && qd == 0) {
      float* lse = p.lse + (int64_t)bh * p.sq;
      if (row < p.sq) lse[row] = m0 + log2f(l0);
      if (row + 8 < p.sq) lse[row + 8] = m1 + log2f(l1);
    }
  }
}

// ---- fp32 backward: split-TF32 wgmma, a dQ pass and a dK/dV pass ---------------

// d = A B^T over the head dim's NC chunks: at NC = G in place (DP <= 160, at most
// 60 wgmmas, as the forward's logits), else in groups of G chunks, each group in a
// fresh accumulator added into d in fp32 (at 512, 192 wgmmas in one chain would
// carry the tensor cores' accumulation error, as the forward found)
template <int N, int NC, int G>
__device__ __forceinline__ void logits_tf32(float (&d)[N / 2], const unsigned char* ring, int slot_bytes, int slots,
                                            uint64_t* full, uint64_t* empty, int& n, int a_off, int a_lo, int b_off,
                                            int b_lo, int lane) {
  if constexpr (G == NC) {
    chunks_tf32<N, G>(d, ring, slot_bytes, slots, full, empty, n, a_off, a_lo, b_off, b_lo, lane);
  } else {
    float part[N / 2];
#pragma unroll 1
    for (int gi = 0; gi < NC / G; ++gi) {
      chunks_tf32<N, G>(part, ring, slot_bytes, slots, full, empty, n, a_off, a_lo, b_off, b_lo, lane);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) d[i] = gi == 0 ? part[i] : d[i] + part[i];
    }
  }
}

// x as tf32 hi and lo into a 64-row operand of 32-column boxes in the 128-byte
// swizzle TMA writes (the forward's P): column j of row r at box j / 32, 16-byte
// chunk (j % 32) / 4 XOR r % 8; lo boxes 2 boxes on (two boxes hold 64 columns)
__device__ __forceinline__ unsigned char* swz_at(unsigned char* base, int r, int j) {
  return base + (j / 32) * (64 * ROW) + r * ROW + ((((j % 32) / 4) ^ (r & 7)) * 16) + (j % 4) * 4;
}

__device__ __forceinline__ void store_split2(unsigned char* at, float x0, float x1) {
  float2 hi, lo;
  tf32_split(x0, hi.x, lo.x);
  tf32_split(x1, hi.y, lo.y);
  *reinterpret_cast<float2*>(at) = hi;
  *reinterpret_cast<float2*>(at + 2 * 64 * ROW) = lo;
}

struct BwdDqF32Tma {
  CUtensorMap q, dout;  // split q~, dO by rows: boxes of 32 columns x QR rows
  CUtensorMap k, v;     // split K, V by rows: boxes of 32 columns x 64 keys
  CUtensorMap kt;       // split K^T: boxes of 32 keys x V_ROWS rows
  const float* lse;     // [B, H, Sq]
  const float* di;      // [B, H, Sq] rowsum(dO * O)
  float* dq;            // [B, H, Sq, DP]: dS K scale
  float scale;
  int sq, skv;
};

// dQ = (P (dO V^T - Di)) K scale, q-stationary: the fp32 forward's geometry
// (FwdF32Cfg) and pipeline. Per kv tile of 64 keys the producer moves NC stages
// of (q~, K) chunks, NC of (dO, V) chunks (the same boxes), then PV_STAGES of K^T.
template <int DP>
__global__ void __launch_bounds__(NT_WS, 1) flash_bwd_dq_f32_wgmma(const __grid_constant__ BwdDqF32Tma p) {
  using C = FwdF32Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);                          // [slot] stages
  unsigned char* sP = ring + C::SLOTS * C::SLOT;                      // dS: [buffer][hi, lo][key half]
  uint64_t* full = reinterpret_cast<uint64_t*>(sP + C::N_P * C::P_BYTES);
  uint64_t* empty = full + C::SLOTS;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * C::QR;
  const int n_tiles = (p.skv + FKT - 1) / FKT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      int n = 0;
      for (int t = 0; t < n_tiles; ++t) {
        for (int i = 0; i < 2 * C::NC + C::PV_STAGES; ++i, ++n) {
          const int slot = n % C::SLOTS;
          unsigned char* st = ring + slot * C::SLOT;
          uint64_t* bar = &full[slot];
          mbar_wait(&empty[slot], ((n / C::SLOTS) & 1) ^ 1);
          if (i < 2 * C::NC) {  // (q~, K) chunk i, then (dO, V) chunk i - NC
            const bool dp = i >= C::NC;
            const int c = dp ? i - C::NC : i;
            mbar_arrive_tx(bar, C::S_STAGE);
            for (int part = 0; part < 2; ++part) {
              tma_load_4d(st + part * C::Q_BOX, dp ? &p.dout : &p.q, bar, 32 * c, q0, bh, part);
              tma_load_4d(st + 2 * C::Q_BOX + part * C::K_BOX, dp ? &p.v : &p.k, bar, 32 * c, t * FKT, bh, part);
            }
          } else {
            const int v = i - 2 * C::NC;
            const int key = t * FKT + 32 * (v % 2);
            mbar_arrive_tx(bar, C::PV_STAGE);
            for (int part = 0; part < 2; ++part) {
              if constexpr (C::WIDE) {  // column block v / 2 of each warpgroup's 256 columns
                for (int w = 0; w < 2; ++w) {
                  tma_load_4d(st + (2 * part + w) * C::V_BOX, &p.kt, bar, key, 256 * w + 64 * (v / 2), bh, part);
                }
              } else {
                tma_load_4d(st + part * C::V_BOX, &p.kt, bar, key, 0, bh, part);
              }
            }
          }
        }
      }
    }
  } else {
    // consumers, as the forward's: DP <= 160, warpgroup wg owns query rows wg *
    // 64 .. +63, all of a tile's keys and all of dQ's columns; DP = 512, both own
    // the block's 64 rows, warpgroup wg forms S and dP for keys 32 wg .. +31 of
    // each tile and owns dQ's columns 256 wg .. +255
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int r = (warp % 4) * 16 + g;
    const int row = q0 + (C::WIDE ? 0 : wg * 64) + r;
    const int key0 = C::WIDE ? 32 * wg : 0;
    unsigned char* pbuf = sP + (C::WIDE ? 0 : wg * C::P_BYTES);
    const float* lse = p.lse + (int64_t)bh * p.sq;
    const float* di = p.di + (int64_t)bh * p.sq;
    const float L0 = row < p.sq ? lse[row] : 0.0f, L1 = row + 8 < p.sq ? lse[row + 8] : 0.0f;
    const float D0 = row < p.sq ? di[row] : 0.0f, D1 = row + 8 < p.sq ? di[row + 8] : 0.0f;
    const int a_off = C::WIDE ? 0 : wg * 64 * ROW;  // this warpgroup's q~ (dO) rows in a stage
    const int b_off = 2 * C::Q_BOX + key0 * ROW;    // its keys of K (V)
    constexpr int G = C::WIDE ? 4 : C::NC;
    float dq[C::ON / 2];
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) dq[i] = 0.0f;
    float tile[C::WIDE ? 32 : DP / 2];  // one tile's dS K, added into dQ in fp32
    float s_acc[C::SN / 2], dp_acc[C::SN / 2];
    int n = 0;

    for (int t = 0; t < n_tiles; ++t) {
      logits_tf32<C::SN, C::NC, G>(s_acc, ring, C::SLOT, C::SLOTS, full, empty, n, a_off, C::Q_BOX, b_off, C::K_BOX,
                                   lane);
      logits_tf32<C::SN, C::NC, G>(dp_acc, ring, C::SLOT, C::SLOTS, full, empty, n, a_off, C::Q_BOX, b_off, C::K_BOX,
                                   lane);
      // at 512 the two warpgroups share dS: both have finished the last tile's
      // dS K (each waited for its own) before either writes this tile's
      if constexpr (C::WIDE) named_bar_sync(1, 2 * 128);
      // P = 2^(S - LSE), zero on keys past Skv (TMA's zero rows), dS = P (dP - Di)
      const int valid = p.skv - t * FKT - key0;
#pragma unroll
      for (int c = 0; c < C::SN / 8; ++c) {
        const int j = 8 * c + 2 * qd;
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = j + e < valid;
          ds[e] = ok ? exp2f(s_acc[4 * c + e] - L0) * (dp_acc[4 * c + e] - D0) : 0.0f;
          ds[2 + e] = ok ? exp2f(s_acc[4 * c + 2 + e] - L1) * (dp_acc[4 * c + 2 + e] - D1) : 0.0f;
        }
        unsigned char* at = swz_at(pbuf, r, key0 + j);
        store_split2(at, ds[0], ds[1]);
        store_split2(at + 8 * ROW, ds[2], ds[3]);
      }
      fence_proxy_async();  // dS's stores -> the wgmma that reads them
      if constexpr (C::WIDE) {
        named_bar_sync(1, 2 * 128);
      } else {
        named_bar_sync(2 + wg, 128);
      }

      // dQ += dS K: each tile's product in a fresh accumulator (pv_tile_tf32) over
      // two K^T stages of 32 keys; at 512 in four blocks of 64 columns
#pragma unroll
      for (int j = 0; j < C::PV_STAGES / 2; ++j, n += 2) {
        const int slot0 = n % C::SLOTS, slot1 = (n + 1) % C::SLOTS;
        mbar_wait(&full[slot0], (n / C::SLOTS) & 1);
        mbar_wait(&full[slot1], ((n + 1) / C::SLOTS) & 1);
        const unsigned char* k0 = ring + slot0 * C::SLOT + (C::WIDE ? wg * C::V_BOX : 0);
        const unsigned char* k1 = ring + slot1 * C::SLOT + (C::WIDE ? wg * C::V_BOX : 0);
        constexpr int TN = C::WIDE ? 64 : DP;
        float* dqj = dq + (TN / 2) * j;
        wgmma_fence();
        pv_tile_tf32<TN>(tile, pbuf, k0, k1, (C::WIDE ? 2 : 1) * C::V_BOX);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(tile);
        release_slot(&empty[slot0], lane);
        release_slot(&empty[slot1], lane);
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) dqj[i] += tile[i];
      }
    }

    float* dq_bh = p.dq + (int64_t)bh * p.sq * DP + (C::WIDE ? 256 * wg : 0);
#pragma unroll
    for (int c = 0; c < C::ON / 8; ++c) {
      const int col = 8 * c + 2 * qd;
      if (row < p.sq) {
        *reinterpret_cast<float2*>(dq_bh + (int64_t)row * DP + col) =
            make_float2(dq[4 * c] * p.scale, dq[4 * c + 1] * p.scale);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<float2*>(dq_bh + (int64_t)(row + 8) * DP + col) =
            make_float2(dq[4 * c + 2] * p.scale, dq[4 * c + 3] * p.scale);
      }
    }
  }
}

template <int DP>
struct BwdKvF32Cfg {
  static constexpr bool WIDE = DP == 512;         // a block owns one 256-column half of dK and dV
  static constexpr int HALVES = WIDE ? 2 : 1;
  static constexpr int NC = DP / 32;              // 32-column chunks of the head dim
  static constexpr int G = WIDE ? 4 : NC;         // chunks of the logits summed in place
  static constexpr int ON = WIDE ? 256 : DP;      // dK (dV) columns a block owns
  static constexpr int TR = WIDE ? 64 : DP;       // rows of q~^T (dO^T) in one box: a column block
  static constexpr int BOX = 64 * ROW;            // 32 columns of 64 rows
  static constexpr int T_BOX = TR * ROW;          // 32 q of a column block of q~^T (dO^T)
  static constexpr int S_STAGE = 4 * BOX;         // K (V) and q~ (dO) chunks, hi and lo
  static constexpr int T_STAGE = 2 * T_BOX;       // hi and lo
  static constexpr int T_STAGES = 2 * (ON / TR);  // per q tile: column blocks x q halves
  static constexpr int SLOT = S_STAGE > T_STAGE ? S_STAGE : T_STAGE;
  static constexpr int SLOTS = 2;                 // a ring per consumer warpgroup
  static constexpr int P_BYTES = 4 * BOX;         // hi and lo of a 64 x 64 tile
  static constexpr size_t SMEM = 1024 + (size_t)2 * SLOTS * SLOT + 2 * P_BYTES + 8 * 4 * SLOTS;
  static_assert(SMEM <= 232448, "the block's shared memory exceeds the H100's 227 KB");
};

struct BwdKvF32Tma {
  CUtensorMap k, q, dot;    // warpgroup 0's ring: split K, q~ (64-row boxes), dO^T (TR-row boxes)
  CUtensorMap v, dout, qt;  // warpgroup 1's: split V, dO, q~^T
  const float* lse;         // [B, H, Sq]
  const float* di;          // [B, H, Sq]
  float* dk;                // [B, H, Skv, DP]: dS^T q~ / log2(e); zeroed and summed into when splits > 1
  float* dv;                // [B, H, Skv, DP]: P^T dO; the same
  int sq, skv, splits;
};

// dK = dS^T q~ / log2(e), dV = P^T dO, kv-stationary: a block owns 64 kv rows (at
// 512 one half of dK's and dV's columns) and walks its range of q tiles of 64.
template <int DP>
__global__ void __launch_bounds__(NT_WS, 1) flash_bwd_dkv_f32_wgmma(const __grid_constant__ BwdKvF32Tma p) {
  using C = BwdKvF32Cfg<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* rings = align1024(smem_raw);            // [warpgroup][slot]
  unsigned char* sP = rings + 2 * C::SLOTS * C::SLOT;    // P^T: [hi, lo][q half]
  unsigned char* sdS = sP + C::P_BYTES;                  // dS^T, the same
  uint64_t* full = reinterpret_cast<uint64_t*>(sdS + C::P_BYTES);  // [warpgroup][slot]
  uint64_t* empty = full + 2 * C::SLOTS;

  const int bh = blockIdx.y, col0 = 256 * (blockIdx.x % C::HALVES);
  const int k0 = (blockIdx.x / C::HALVES) * 64;
  const int q_tiles = (p.sq + 63) / 64;
  const int t0 = blockIdx.z * q_tiles / p.splits, t1 = (blockIdx.z + 1) * q_tiles / p.splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * C::SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // the warps of one warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer warp w feeds warpgroup w's ring: per q tile NC stages of (K, q~)
    // chunks (w = 0) or (V, dO) chunks (w = 1), then T_STAGES of dO^T or q~^T
    setmaxnreg_dec<PRODUCER_REGS>();
    const int w = warp - NCW;
    if (w < 2 && lane == 0) {
      unsigned char* ring = rings + w * C::SLOTS * C::SLOT;
      uint64_t* f = full + w * C::SLOTS;
      uint64_t* e = empty + w * C::SLOTS;
      const CUtensorMap* kv = w ? &p.v : &p.k;
      const CUtensorMap* qrows = w ? &p.dout : &p.q;
      const CUtensorMap* qcols = w ? &p.qt : &p.dot;
      int n = 0;
      for (int t = t0; t < t1; ++t) {
        for (int i = 0; i < C::NC + C::T_STAGES; ++i, ++n) {
          const int slot = n % C::SLOTS;
          unsigned char* st = ring + slot * C::SLOT;
          mbar_wait(&e[slot], ((n / C::SLOTS) & 1) ^ 1);
          if (i < C::NC) {
            mbar_arrive_tx(&f[slot], C::S_STAGE);
            for (int part = 0; part < 2; ++part) {
              tma_load_4d(st + part * C::BOX, kv, &f[slot], 32 * i, k0, bh, part);
              tma_load_4d(st + (2 + part) * C::BOX, qrows, &f[slot], 32 * i, t * 64, bh, part);
            }
          } else {  // column block v / 2, q half v % 2
            const int v = i - C::NC;
            mbar_arrive_tx(&f[slot], C::T_STAGE);
            for (int part = 0; part < 2; ++part) {
              tma_load_4d(st + part * C::T_BOX, qcols, &f[slot], t * 64 + 32 * (v % 2), col0 + C::TR * (v / 2), bh,
                          part);
            }
          }
        }
      }
    }
  } else {
    // consumers: this thread holds kv rows r and r + 8 of the warpgroup's
    // accumulators (S^T or dP^T; dV or dK), columns 8 c + 2 qd + {0, 1}
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = warp / 4, g = lane / 4, qd = lane % 4;
    const int r = (warp % 4) * 16 + g;
    const unsigned char* ring = rings + wg * C::SLOTS * C::SLOT;
    uint64_t* f = full + wg * C::SLOTS;
    uint64_t* e = empty + wg * C::SLOTS;
    const float* stat = (wg ? p.di : p.lse) + (int64_t)bh * p.sq;
    const float stat_pad = wg ? 0.0f : INFINITY;  // q rows past Sq get P = 0
    const bool ok0 = k0 + r < p.skv, ok1 = k0 + r + 8 < p.skv;
    float acc[C::ON / 2];  // dV (warpgroup 0) or dK (1)
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) acc[i] = 0.0f;
    float tile[C::TR / 2];  // one column block's product over a q tile
    float s_acc[32];        // S^T (warpgroup 0) or dP^T (1): 64 kv rows x 64 q
    int n = 0;

    for (int t = t0; t < t1; ++t) {
      // S^T = K q~^T or dP^T = V dO^T: A the kv rows' chunk, B the q rows'
      logits_tf32<64, C::NC, C::G>(s_acc, ring, C::SLOT, C::SLOTS, f, e, n, 0, C::BOX, 2 * C::BOX, C::BOX, lane);
      float x[16];  // LSE (warpgroup 0) or Di (1) of this thread's q columns
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int q = t * 64 + 8 * c + 2 * qd + j;
          x[2 * c + j] = q < p.sq ? stat[q] : stat_pad;
        }
      }

      named_bar_sync(1, 2 * 128);  // warpgroup 1 has read the last tile's P^T
      if (wg == 0) {
        // P^T = 2^(S^T - LSE) as hi and lo into sP, zero on kv rows past Skv
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float pt[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pt[i] = (i < 2 ? ok0 : ok1) ? exp2f(s_acc[4 * c + i] - x[2 * c + i % 2]) : 0.0f;
          unsigned char* at = swz_at(sP, r, 8 * c + 2 * qd);
          store_split2(at, pt[0], pt[1]);
          store_split2(at + 8 * ROW, pt[2], pt[3]);
        }
        fence_proxy_async();
        named_bar_sync(2, 2 * 128);  // P^T is in sP
      } else {
        named_bar_sync(2, 2 * 128);
        // dS^T = P^T (dP^T - Di), P^T read back as hi + lo, into sdS
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int j = 8 * c + 2 * qd;
          const unsigned char* pa = swz_at(sP, r, j);
          float pt[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 hi = *reinterpret_cast<const float2*>(pa + h * 8 * ROW);
            const float2 lo = *reinterpret_cast<const float2*>(pa + h * 8 * ROW + 2 * C::BOX);
            pt[2 * h] = hi.x + lo.x;
            pt[2 * h + 1] = hi.y + lo.y;
          }
          unsigned char* at = swz_at(sdS, r, j);
          store_split2(at, pt[0] * (s_acc[4 * c] - x[2 * c]), pt[1] * (s_acc[4 * c + 1] - x[2 * c + 1]));
          store_split2(at + 8 * ROW, pt[2] * (s_acc[4 * c + 2] - x[2 * c]),
                       pt[3] * (s_acc[4 * c + 3] - x[2 * c + 1]));
        }
        fence_proxy_async();
        named_bar_sync(3, 128);  // dS^T is in sdS
      }

      // dV += P^T dO (B = dO^T) or dK += dS^T q~ (B = q~^T): each column block's
      // product over the tile's 64 q in a fresh accumulator, added in fp32
      const unsigned char* a = wg ? sdS : sP;
#pragma unroll
      for (int j = 0; j < C::T_STAGES / 2; ++j, n += 2) {
        const int slot0 = n % C::SLOTS, slot1 = (n + 1) % C::SLOTS;
        mbar_wait(&f[slot0], (n / C::SLOTS) & 1);
        mbar_wait(&f[slot1], ((n + 1) / C::SLOTS) & 1);
        wgmma_fence();
        pv_tile_tf32<C::TR>(tile, a, ring + slot0 * C::SLOT, ring + slot1 * C::SLOT, C::T_BOX);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(tile);
        release_slot(&e[slot0], lane);
        release_slot(&e[slot1], lane);
        float* accj = acc + (C::TR / 2) * j;
#pragma unroll
        for (int i = 0; i < C::TR / 2; ++i) accj[i] += tile[i];
      }
    }

    // dk = dS^T q~ / log2(e): q~ = q * scale * log2(e), dk = dS^T q * scale
    const float mul = wg ? INV_LOG2E : 1.0f;
    float* out = (wg ? p.dk : p.dv) + (int64_t)bh * p.skv * DP + col0;
#pragma unroll
    for (int c = 0; c < C::ON / 8; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + r + 8 * h;
        if (row >= p.skv) continue;
        float2* at = reinterpret_cast<float2*>(out + (int64_t)row * DP + 8 * c + 2 * qd);
        const float2 val = make_float2(acc[4 * c + 2 * h] * mul, acc[4 * c + 2 * h + 1] * mul);
        if (p.splits == 1) {
          *at = val;
        } else {
          atomicAdd(at, val);
        }
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

struct View {  // a strided [B, H, S, d] operand: base pointer, element strides
  const void* ptr;
  int64_t sb, sh, ss;
};

template <int D>
cudaError_t launch_fwd_wgmma(View q, View k, View v, void* o, void* lse, int64_t batch, int64_t heads, int64_t sq,
                             int64_t skv, cudaStream_t stream) {
  using C = FwdCfg<D>;
  FwdTma p;
  if (!bf16_map(&p.q, q.ptr, batch, heads, sq, D, q.sb, q.sh, q.ss, FQ) ||
      !bf16_map(&p.k, k.ptr, batch, heads, skv, D, k.sb, k.sh, k.ss, C::BK) ||
      !bf16_map(&p.v, v.ptr, batch, heads, skv, D, v.sb, v.sh, v.ss, C::BK)) {
    return cudaErrorInvalidValue;
  }
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = (int)heads; p.sq = (int)sq; p.skv = (int)skv;
  static cudaError_t opted_in = allow_smem(flash_fwd_wgmma<D>, C::SMEM);  // once per head dim
  if (opted_in != cudaSuccess) return opted_in;
  dim3 grid((unsigned)((sq + FQ - 1) / FQ), (unsigned)(batch * heads));
  flash_fwd_wgmma<D><<<grid, NT_WS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd_wgmma(View q, View k, View v, View dout, const void* lse, const void* di, void* dq, void* dk,
                             void* dv, void* dk_acc, void* dv_acc, int64_t batch, int64_t heads, int64_t sq,
                             int64_t skv, int64_t splits, double scale, cudaStream_t stream) {
  using C = BwdCfg<D>;
  BwdTma p;
  if (splits < 1 || splits > (sq + BQB - 1) / BQB ||
      !bf16_map(&p.q, q.ptr, batch, heads, sq, D, q.sb, q.sh, q.ss, BQB) ||
      !bf16_map(&p.dout, dout.ptr, batch, heads, sq, D, dout.sb, dout.sh, dout.ss, BQB) ||
      !bf16_map(&p.k, k.ptr, batch, heads, skv, D, k.sb, k.sh, k.ss, BKV) ||
      !bf16_map(&p.v, v.ptr, batch, heads, skv, D, v.sb, v.sh, v.ss, BKV)) {
    return cudaErrorInvalidValue;
  }
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dk_acc = static_cast<float*>(dk_acc);
  p.dv_acc = static_cast<float*>(dv_acc);
  p.scale = (float)scale;
  p.heads = (int)heads; p.sq = (int)sq; p.skv = (int)skv; p.splits = (int)splits;
  static cudaError_t opted_in = allow_smem(flash_bwd_wgmma<D>, C::SMEM);  // once per head dim
  if (opted_in != cudaSuccess) return opted_in;
  dim3 grid((unsigned)((skv + BKV - 1) / BKV), (unsigned)(batch * heads), (unsigned)splits);
  flash_bwd_wgmma<D><<<grid, NT_WS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_fwd512(View q, View k, View v, void* o, void* lse, int64_t batch, int64_t heads, int64_t sq,
                          int64_t skv, cudaStream_t stream) {
  FwdTma p;
  if (!bf16_map(&p.q, q.ptr, batch, heads, sq, 512, q.sb, q.sh, q.ss, F5Q) ||
      !bf16_map(&p.k, k.ptr, batch, heads, skv, 512, k.sb, k.sh, k.ss, F5K) ||
      !bf16_map(&p.v, v.ptr, batch, heads, skv, 512, v.sb, v.sh, v.ss, F5K)) {
    return cudaErrorInvalidValue;
  }
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.heads = (int)heads; p.sq = (int)sq; p.skv = (int)skv;
  static cudaError_t opted_in = allow_smem(flash_fwd512_wgmma, Fwd512Cfg::SMEM);
  if (opted_in != cudaSuccess) return opted_in;
  dim3 grid((unsigned)((sq + F5Q - 1) / F5Q), (unsigned)(batch * heads));
  flash_fwd512_wgmma<<<grid, NT_WS, Fwd512Cfg::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The dQ kernel, then the dK/dV kernel, one after the other on the stream.
cudaError_t launch_bwd512(View q, View k, View v, View dout, const void* lse, const void* di, void* dq, void* dk,
                          void* dv, int64_t batch, int64_t heads, int64_t sq, int64_t skv, double scale,
                          cudaStream_t stream) {
  Bwd512Tma p;
  if (!bf16_map(&p.q, q.ptr, batch, heads, sq, 512, q.sb, q.sh, q.ss, B5) ||
      !bf16_map(&p.dout, dout.ptr, batch, heads, sq, 512, dout.sb, dout.sh, dout.ss, B5) ||
      !bf16_map(&p.k, k.ptr, batch, heads, skv, 512, k.sb, k.sh, k.ss, B5) ||
      !bf16_map(&p.v, v.ptr, batch, heads, skv, 512, v.sb, v.sh, v.ss, B5)) {
    return cudaErrorInvalidValue;
  }
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.scale = (float)scale;
  p.heads = (int)heads; p.sq = (int)sq; p.skv = (int)skv;
  static cudaError_t dq_opted_in = allow_smem(flash_bwd512_dq_wgmma, BwdDq512Cfg::SMEM);
  if (dq_opted_in != cudaSuccess) return dq_opted_in;
  static cudaError_t kv_opted_in = allow_smem(flash_bwd512_dkv_wgmma, BwdKv512Cfg::SMEM);
  if (kv_opted_in != cudaSuccess) return kv_opted_in;
  flash_bwd512_dq_wgmma<<<dim3((unsigned)((sq + B5 - 1) / B5), (unsigned)(batch * heads)), NT_WS,
                          BwdDq512Cfg::SMEM, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd512_dkv_wgmma<<<dim3((unsigned)((skv + B5 - 1) / B5 * 2), (unsigned)(batch * heads)), NT_WS,
                           BwdKv512Cfg::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// Map over a contiguous fp32 [2 (hi, lo), bh, rows, cols] split operand: boxes of
// 32 columns (128 bytes, the swizzle's row) x box_rows rows of one (part, b*h),
// 128-byte swizzle; rows and columns past the ends read as zero.
bool f32_split_map(CUtensorMap* map, const float* base, int64_t bh, int64_t rows, int64_t cols, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)bh, 2};
  const cuuint64_t strides[3] = {(cuuint64_t)cols * 4, (cuuint64_t)(rows * cols) * 4, (cuuint64_t)(bh * rows * cols) * 4};
  const cuuint32_t box[4] = {32, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

void launch_split_rows(View x, int64_t bh, int64_t heads, int64_t rows, int dp, float* dst, cudaStream_t stream) {
  const int64_t total4 = bh * rows * dp / 4;
  const int64_t blocks = (total4 + 255) / 256;
  flash_f32_split_rows<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(x.ptr), x.sb, x.sh, x.ss, (int)heads, (int)rows, dp, total4, dst);
}

// hi and lo of x^T: x strided fp32 [B, H, rows, DP] into dst [2][B*H][DP][rows4]
void launch_split_t(View x, int64_t bh, int64_t heads, int64_t rows, int64_t rows4, int dp, float* dst,
                    cudaStream_t stream) {
  const dim3 grid((unsigned)((rows4 + 31) / 32), (unsigned)(dp / 32), (unsigned)bh);
  flash_f32_split_vt<<<grid, dim3(32, 8), 0, stream>>>(static_cast<const float*>(x.ptr), x.sb, x.sh, x.ss,
                                                       (int)heads, (int)rows, (int)rows4, dp, dst);
}

template <int DP>
cudaError_t launch_fwd_f32(View q, View k, View v, float* o, float* lse, float* split_q, float* split_k,
                           float* split_vt, int64_t batch, int64_t heads, int64_t sq, int64_t skv,
                           cudaStream_t stream) {
  using C = FwdF32Cfg<DP>;
  const int64_t bh = batch * heads, skv4 = (skv + 3) / 4 * 4;
  launch_split_rows(q, bh, heads, sq, DP, split_q, stream);
  launch_split_rows(k, bh, heads, skv, DP, split_k, stream);
  launch_split_t(v, bh, heads, skv, skv4, DP, split_vt, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  FwdF32Tma p;
  if (!f32_split_map(&p.q, split_q, bh, sq, DP, C::QR) || !f32_split_map(&p.k, split_k, bh, skv, DP, FKT) ||
      !f32_split_map(&p.vt, split_vt, bh, DP, skv4, C::V_ROWS)) {
    return cudaErrorInvalidValue;
  }
  p.o = o;
  p.lse = lse;
  p.sq = (int)sq;
  p.skv = (int)skv;
  static cudaError_t opted_in = allow_smem(flash_fwd_f32_wgmma<DP>, C::SMEM);  // once per head dim
  if (opted_in != cudaSuccess) return opted_in;
  dim3 grid((unsigned)((sq + C::QR - 1) / C::QR), (unsigned)bh);
  flash_fwd_f32_wgmma<DP><<<grid, NT_WS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// The split passes into scratch (see flash_bwd_f32), then the dQ kernel and the
// dK/dV kernel, one after the other on the stream.
template <int DP>
cudaError_t launch_bwd_f32(View q, View k, View v, View dout, const float* lse, const float* di, float* dq,
                           float* dk, float* dv, float* scratch, int64_t batch, int64_t heads, int64_t sq,
                           int64_t skv, int64_t splits, double scale, cudaStream_t stream) {
  using CQ = FwdF32Cfg<DP>;
  using CK = BwdKvF32Cfg<DP>;
  const int64_t bh = batch * heads, sq4 = (sq + 3) / 4 * 4, skv4 = (skv + 3) / 4 * 4;
  if (splits < 1 || splits > (sq + 63) / 64) return cudaErrorInvalidValue;
  float* s_q = scratch;
  float* s_k = s_q + 2 * bh * sq * DP;
  float* s_v = s_k + 2 * bh * skv * DP;
  float* s_do = s_v + 2 * bh * skv * DP;
  float* s_kt = s_do + 2 * bh * sq * DP;
  float* s_qt = s_kt + 2 * bh * DP * skv4;
  float* s_dot = s_qt + 2 * bh * DP * sq4;
  launch_split_rows(q, bh, heads, sq, DP, s_q, stream);
  launch_split_rows(k, bh, heads, skv, DP, s_k, stream);
  launch_split_rows(v, bh, heads, skv, DP, s_v, stream);
  launch_split_rows(dout, bh, heads, sq, DP, s_do, stream);
  launch_split_t(k, bh, heads, skv, skv4, DP, s_kt, stream);
  launch_split_t(q, bh, heads, sq, sq4, DP, s_qt, stream);
  launch_split_t(dout, bh, heads, sq, sq4, DP, s_dot, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  BwdDqF32Tma pq;
  if (!f32_split_map(&pq.q, s_q, bh, sq, DP, CQ::QR) || !f32_split_map(&pq.dout, s_do, bh, sq, DP, CQ::QR) ||
      !f32_split_map(&pq.k, s_k, bh, skv, DP, FKT) || !f32_split_map(&pq.v, s_v, bh, skv, DP, FKT) ||
      !f32_split_map(&pq.kt, s_kt, bh, DP, skv4, CQ::V_ROWS)) {
    return cudaErrorInvalidValue;
  }
  pq.lse = lse;
  pq.di = di;
  pq.dq = dq;
  pq.scale = (float)scale;
  pq.sq = (int)sq;
  pq.skv = (int)skv;
  static cudaError_t dq_opted_in = allow_smem(flash_bwd_dq_f32_wgmma<DP>, CQ::SMEM);  // once per head dim
  if (dq_opted_in != cudaSuccess) return dq_opted_in;
  flash_bwd_dq_f32_wgmma<DP><<<dim3((unsigned)((sq + CQ::QR - 1) / CQ::QR), (unsigned)bh), NT_WS, CQ::SMEM,
                               stream>>>(pq);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  BwdKvF32Tma pk;
  if (!f32_split_map(&pk.k, s_k, bh, skv, DP, 64) || !f32_split_map(&pk.q, s_q, bh, sq, DP, 64) ||
      !f32_split_map(&pk.dot, s_dot, bh, DP, sq4, CK::TR) || !f32_split_map(&pk.v, s_v, bh, skv, DP, 64) ||
      !f32_split_map(&pk.dout, s_do, bh, sq, DP, 64) || !f32_split_map(&pk.qt, s_qt, bh, DP, sq4, CK::TR)) {
    return cudaErrorInvalidValue;
  }
  pk.lse = lse;
  pk.di = di;
  pk.dk = dk;
  pk.dv = dv;
  pk.sq = (int)sq;
  pk.skv = (int)skv;
  pk.splits = (int)splits;
  static cudaError_t kv_opted_in = allow_smem(flash_bwd_dkv_f32_wgmma<DP>, CK::SMEM);
  if (kv_opted_in != cudaSuccess) return kv_opted_in;
  const dim3 grid((unsigned)((skv + 63) / 64 * CK::HALVES), (unsigned)bh, (unsigned)splits);
  flash_bwd_dkv_f32_wgmma<DP><<<grid, NT_WS, CK::SMEM, stream>>>(pk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: bf16 [B, H, S, d] with unit stride on d and the given element
// strides for batch, head and row (multiples of 8, 16-byte aligned base).
// Writes o [B, H, Sq, d] and lse [B, H, Sq].
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                   int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                   void* stream) {
  const View vq = {q, q_sb, q_sh, q_ss}, vk = {k, k_sb, k_sh, k_ss}, vv = {v, v_sb, v_sh, v_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch_fwd_wgmma<40>(vq, vk, vv, o, lse, batch, heads, sq, skv, s);
    case 64: return launch_fwd_wgmma<64>(vq, vk, vv, o, lse, batch, heads, sq, skv, s);
    case 80: return launch_fwd_wgmma<80>(vq, vk, vv, o, lse, batch, heads, sq, skv, s);
    case 160: return launch_fwd_wgmma<160>(vq, vk, vv, o, lse, batch, heads, sq, skv, s);
    case 512: return launch_fwd512(vq, vk, vv, o, lse, batch, heads, sq, skv, s);
    default: return cudaErrorInvalidValue;
  }
}

// q (pre-scaled), k, v, dout: strided bf16 as in flash_fwd_bf16; lse, di:
// fp32 [B, H, Sq]; dk, dv: bf16 [B, H, Skv, d].
// d = 40, 64, 80, 160: dq is a zeroed fp32 [B, H, Sq, d] that receives dS . k .
// scale; the q range is split over `splits` blocks per kv tile, and with
// splits > 1 dk and dv are summed into the zeroed fp32 dk_acc, dv_acc [B, H,
// Skv, d] (dk, dv untouched).
// d = 512: dq is bf16 [B, H, Sq, 512] and written dS . k . scale; splits must
// be 1 and dk_acc, dv_acc are not read.
int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* di, void* dq, void* dk, void* dv,
                   int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                   int64_t do_sb, int64_t do_sh, int64_t do_ss,
                   void* dk_acc, void* dv_acc, int64_t splits, double scale,
                   void* stream) {
  const View vq = {q, q_sb, q_sh, q_ss}, vk = {k, k_sb, k_sh, k_ss}, vv = {v, v_sb, v_sh, v_ss};
  const View vdo = {dout, do_sb, do_sh, do_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_WGMMA(D)                                                                                      \
  launch_bwd_wgmma<D>(vq, vk, vv, vdo, lse, di, dq, dk, dv, dk_acc, dv_acc, batch, heads, sq, skv, splits, scale, \
                      s)
  switch (d) {
    case 40: return FLASH_BWD_WGMMA(40);
    case 64: return FLASH_BWD_WGMMA(64);
    case 80: return FLASH_BWD_WGMMA(80);
    case 160: return FLASH_BWD_WGMMA(160);
    case 512:
      if (splits != 1) return cudaErrorInvalidValue;
      return launch_bwd512(vq, vk, vv, vdo, lse, di, dq, dk, dv, batch, heads, sq, skv, scale, s);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_WGMMA
}

// The fp32 kernels' padded head dims: the caller pads any other d <= 512 with
// zero columns up to the next of them.
#define FLASH_F32_DISPATCH(LAUNCH)                                   \
  switch (d) {                                                       \
    case 64: return LAUNCH(64);                                      \
    case 96: return LAUNCH(96);                                      \
    case 160: return LAUNCH(160);                                    \
    case 512: return LAUNCH(512);                                    \
    default: return cudaErrorInvalidValue;                           \
  }

// q (pre-scaled), k, v: fp32 [B, H, S, d] strided as in flash_fwd_bf16, d one of
// 64, 96, 160, 512. Writes o fp32 [B, H, Sq, d] and lse [B, H, Sq]. split_q,
// split_k: scratch of 2 B H Sq d and 2 B H Skv d floats, split_vt of 2 B H d
// Skv4 (Skv rounded up to 4), which receive the tf32 hi and lo parts of q~, k
// and v^T.
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                  int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                  int64_t q_sb, int64_t q_sh, int64_t q_ss,
                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  void* split_q, void* split_k, void* split_vt, void* stream) {
  const View vq = {q, q_sb, q_sh, q_ss}, vk = {k, k_sb, k_sh, k_ss}, vv = {v, v_sb, v_sh, v_ss};
  float* sq_ = static_cast<float*>(split_q);
  float* sk_ = static_cast<float*>(split_k);
  float* sv_ = static_cast<float*>(split_vt);
  float* o_ = static_cast<float*>(o);
  float* lse_ = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_FWD_F32(DP) launch_fwd_f32<DP>(vq, vk, vv, o_, lse_, sq_, sk_, sv_, batch, heads, sq, skv, s)
  FLASH_F32_DISPATCH(FLASH_FWD_F32)
#undef FLASH_FWD_F32
}

// q (pre-scaled), k, v, dout: fp32 [B, H, S, d] strided as in flash_fwd_bf16, d
// as in flash_fwd_f32; lse, di: fp32 [B, H, Sq]. Writes dq = dS k scale (fp32
// [B, H, Sq, d]), and dk = dS^T q~ / log2(e), dv = P^T dO (fp32 [B, H, Skv, d]);
// with splits > 1 (the q range split over that many blocks a kv tile, at most
// ceil(Sq / 64)) dk and dv must be zeroed and are summed into. scratch: 2 B H d
// (2 Sq + 2 Skv + Skv4 + 2 Sq4) floats (S4: S rounded up to 4), which receive the
// tf32 hi and lo parts of q~, k, v, dO, then k^T, q~^T, dO^T.
int flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* di, void* dq, void* dk, void* dv,
                  int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                  int64_t q_sb, int64_t q_sh, int64_t q_ss,
                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  int64_t do_sb, int64_t do_sh, int64_t do_ss,
                  void* scratch, int64_t splits, double scale, void* stream) {
  const View vq = {q, q_sb, q_sh, q_ss}, vk = {k, k_sb, k_sh, k_ss}, vv = {v, v_sb, v_sh, v_ss};
  const View vdo = {dout, do_sb, do_sh, do_ss};
  const float* lse_ = static_cast<const float*>(lse);
  const float* di_ = static_cast<const float*>(di);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
  float* scratch_ = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_BWD_F32(DP) \
  launch_bwd_f32<DP>(vq, vk, vv, vdo, lse_, di_, dq_, dk_, dv_, scratch_, batch, heads, sq, skv, splits, scale, s)
  FLASH_F32_DISPATCH(FLASH_BWD_F32)
#undef FLASH_BWD_F32
}

#undef FLASH_F32_DISPATCH

}  // extern "C"
