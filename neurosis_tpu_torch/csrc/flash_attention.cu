// Flash attention forward and backward for Hopper (sm_90a), bf16 in, fp32 accumulate,
// and an fp32 forward and backward at head dim 512 for the VAE in fp32.
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
// Head dim 512 (the VAE's single-head mid attention) has its own tiling:
// the 128-row tiles above would need ~1 MB of shared memory at d = 512.
//   forward  : 32 query rows, 8 warps; K and V take turns in one 64-row
//              buffer (S is built from K before V is loaded over it), the
//              fp32 O accumulator stays in shared memory (~176 KB in all).
//   backward : 16 kv rows per block, 8 warps, q walked in 64-row tiles. dK
//              and dV live in WMMA accumulator registers (no rescaling is
//              needed in the backward, so their opaque layout is fine): each
//              warp owns 4 of the 32 16-wide column tiles of each. dQ goes
//              to the fp32 buffer with vector (float4) atomics (~187 KB).
//   fp32 fwd : the frozen VAE encode runs in fp32 and the JAX kernel takes
//              fp32 there, so this kernel stays in fp32 end to end, with
//              FFMA on the CUDA cores (not TF32 tensor cores: TF32 keeps 10
//              mantissa bits and would change the fp32 island's numbers).
//              32 query rows, 256 threads, 64-row kv tiles in shared memory;
//              each warp owns 4 query rows for both the softmax and P.V, so
//              O (4 rows x 512 per warp) stays in registers and is rescaled
//              there. Bound on the H100 by the FFMA rate (67 TFLOP/s).
//   fp32 bwd : fp32 VAE training (the JAX backward kernels take fp32 as they
//              take bf16), FFMA for the same reason as the fp32 forward. An
//              fp32 K tile plus V tile of 16 rows is 64 KB and there are no
//              WMMA fragments to keep dK/dV in, so a block owns 16 kv rows,
//              walks q in 32-row tiles (q~ and dO tiles, 129 KB) and keeps
//              dK/dV in plain registers: warp w owns kv rows 2w, 2w+1, lane l
//              the forward's 16 columns (64 registers a thread). Logits and
//              dP are split between the two halves of the block; dQ of the
//              warp's 4 query rows is formed in registers and added to the
//              zeroed fp32 buffer with float4 atomics (~199 KB, one block
//              per SM). Bound by the FFMA rate: 10 B H Sq Skv D operations.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "wgmma.cuh"

using namespace nvcuda;

namespace {

constexpr float INV_LOG2E = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// head dims 40, 64, 80, 160, bf16: TMA ring, wgmma, softmax in registers
// ---------------------------------------------------------------------------

constexpr int NCW = 8;                 // consumer warps: two warpgroups
constexpr int NT_WS = NCW * 32 + 128;  // and a producer warpgroup, of which one warp works
// registers a thread: ptxas budgets 168 for three warpgroups; the producer
// warpgroup gives 128 from each of its threads to the consumers (setmaxnreg)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int ROW = 128;              // bytes of one row of a 64-column box

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// the k16 step kk over the head dim of a K-major tile of 64-column boxes
// (box_bytes apart): 32 bytes along the row, then the next box
__device__ __forceinline__ int kstep_offset(int kk, int box_bytes) { return (kk / 4) * box_bytes + (kk % 4) * 32; }

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

// arguments of the head-dim-512 bf16 kernels
struct FwdArgs {
  StridedRows q, k, v;   // base pointers of (b=0, h=0)
  int64_t q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  bf16* o;               // [B, H, Sq, d] contiguous
  float* lse;            // [B, H, Sq] contiguous
  int heads, sq, skv, d;
};

struct BwdArgs {
  StridedRows q, k, v, dout;  // q is the pre-scaled q
  int64_t q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, do_sb, do_sh;
  const float* lse;           // [B, H, Sq]
  const float* di;            // [B, H, Sq] rowsum(dO * O)
  float* dq;                  // [B, H, Sq, d] fp32, zeroed; receives dS . k
  bf16* dk;                   // [B, H, Skv, d]
  bf16* dv;                   // [B, H, Skv, d]
  int heads, sq, skv, d;
};

// ---------------------------------------------------------------------------
// head dim 512, bf16
// ---------------------------------------------------------------------------

constexpr int D5 = 512;
constexpr int LDK5 = D5 + 8;      // bf16 row stride of a q/k/v/dO tile
constexpr int LDO5 = D5 + 4;      // fp32 row stride of the O accumulator
constexpr int NW5 = 8;
constexpr int NT5 = NW5 * 32;
constexpr int BQ5 = 32;           // forward: query rows per block
constexpr int BK5 = 64;           // forward: kv rows per tile
constexpr int LDS5 = BK5 + 4;
constexpr int LDP5 = BK5 + 8;

constexpr size_t fwd512_smem_bytes() {
  return sizeof(bf16) * (size_t)(BQ5 + BK5) * LDK5   // q tile, shared k/v tile
       + sizeof(float) * (size_t)BQ5 * LDS5          // logits
       + sizeof(bf16) * (size_t)BQ5 * LDP5           // probabilities
       + sizeof(float) * (size_t)BQ5 * LDO5          // output accumulator
       + sizeof(float) * 2 * BQ5;                    // running max, sum
}

__global__ void __launch_bounds__(NT5) flash_fwd512_kernel(FwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + BQ5 * LDK5;
  float* sS = reinterpret_cast<float*>(sKV + BK5 * LDK5);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ5 * LDS5);
  float* sO = reinterpret_cast<float*>(sP + BQ5 * LDP5);
  float* sM = sO + BQ5 * LDO5;
  float* sL = sM + BQ5;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * BQ5;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  StridedRows q = {a.q.ptr + b * a.q_sb + h * a.q_sh, a.q.stride};
  StridedRows k = {a.k.ptr + b * a.k_sb + h * a.k_sh, a.k.stride};
  StridedRows v = {a.v.ptr + b * a.v_sb + h * a.v_sh, a.v.stride};

  load_tile<BQ5, D5, LDK5, NT5>(sQ, q, q0, a.sq, a.d);
  for (int i = threadIdx.x; i < BQ5 * LDO5; i += NT5) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ5; i += NT5) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }

  // S tile of this warp: rows (warp / 4) * 16, columns (warp % 4) * 16
  const int s_row = (warp / 4) * 16, s_col = (warp % 4) * 16;
  // P.V tiles of this warp: rows (warp % 2) * 16, columns (warp / 2) * 128 + 16 j
  const int o_row = (warp % 2) * 16, o_col = (warp / 2) * 128;

  for (int k0 = 0; k0 < a.skv; k0 += BK5) {
    __syncthreads();  // the previous tile's readers of sKV/sP/sO are done
    load_tile<BK5, D5, LDK5, NT5>(sKV, k, k0, a.skv, a.d);
    __syncthreads();
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 8
      for (int kk = 0; kk < D5; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + s_row * LDK5 + kk, LDK5);
        wmma::load_matrix_sync(fb, sKV + s_col * LDK5 + kk, LDK5);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + s_row * LDS5 + s_col, acc, LDS5, wmma::mem_row_major);
    }
    __syncthreads();  // S is whole and K is no longer read
    load_tile<BK5, D5, LDK5, NT5>(sKV, v, k0, a.skv, a.d);

    // online softmax: each warp takes 4 rows, two columns per lane
    const int kv_valid = min(BK5, a.skv - k0);
    for (int r = warp * 4; r < warp * 4 + 4; ++r) {
      const float s0 = lane < kv_valid ? sS[r * LDS5 + lane] : -INFINITY;
      const float s1 = lane + 32 < kv_valid ? sS[r * LDS5 + lane + 32] : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float alpha = exp2f(m_old - m_new);
      sP[r * LDP5 + lane] = __float2bfloat16(p0);
      sP[r * LDP5 + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < D5; c += 32) sO[r * LDO5 + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncthreads();  // V, P and the rescaled O are in place

    // O[16 x 128] += P[16 x BK] . V[BK x 128] for this warp's tiles
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fp[BK5 / 16];
#pragma unroll
    for (int kk = 0; kk < BK5 / 16; ++kk) wmma::load_matrix_sync(fp[kk], sP + o_row * LDP5 + kk * 16, LDP5);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = o_col + j * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + o_row * LDO5 + n, LDO5, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK5 / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sKV + kk * 16 * LDK5 + n, LDK5);
        wmma::mma_sync(acc, fp[kk], fb, acc);
      }
      wmma::store_matrix_sync(sO + o_row * LDO5 + n, acc, LDO5, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* o = a.o + (int64_t)bh * a.sq * D5;
  for (int i = threadIdx.x; i < BQ5 * D5; i += NT5) {
    const int r = i / D5, c = i % D5;
    if (q0 + r < a.sq) o[(int64_t)(q0 + r) * D5 + c] = __float2bfloat16(sO[r * LDO5 + c] / sL[r]);
  }
  for (int r = threadIdx.x; r < BQ5; r += NT5) {
    if (q0 + r < a.sq) a.lse[(int64_t)bh * a.sq + q0 + r] = sM[r] + log2f(sL[r]);
  }
}

constexpr int BKB5 = 16;          // backward: kv rows per block
constexpr int BQB5 = 64;          // backward: query rows per tile
constexpr int LDSB5 = BKB5 + 4;
constexpr int LDPB5 = BKB5 + 8;

constexpr size_t bwd512_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BKB5 + 2 * BQB5) * LDK5   // k, v, q, dO tiles
       + sizeof(float) * (size_t)2 * BQB5 * LDSB5               // logits, dP
       + sizeof(bf16) * (size_t)2 * BQB5 * LDPB5                // P, dS
       + sizeof(float) * (size_t)NW5 * 256                      // per-warp staging
       + sizeof(float) * 2 * BQB5;                              // lse, Di
}

__global__ void __launch_bounds__(NT5) flash_bwd512_kernel(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BKB5 * LDK5;
  bf16* sQ = sV + BKB5 * LDK5;
  bf16* sdO = sQ + BQB5 * LDK5;
  float* sS = reinterpret_cast<float*>(sdO + BQB5 * LDK5);
  float* sdP = sS + BQB5 * LDSB5;
  bf16* sP = reinterpret_cast<bf16*>(sdP + BQB5 * LDSB5);
  bf16* sdS = sP + BQB5 * LDPB5;
  float* sScr = reinterpret_cast<float*>(sdS + BQB5 * LDPB5);
  float* sLse = sScr + NW5 * 256;
  float* sDi = sLse + BQB5;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * BKB5;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_valid = min(BKB5, a.skv - k0);

  StridedRows q = {a.q.ptr + b * a.q_sb + h * a.q_sh, a.q.stride};
  StridedRows k = {a.k.ptr + b * a.k_sb + h * a.k_sh, a.k.stride};
  StridedRows v = {a.v.ptr + b * a.v_sb + h * a.v_sh, a.v.stride};
  StridedRows dout = {a.dout.ptr + b * a.do_sb + h * a.do_sh, a.dout.stride};
  const float* lse = a.lse + (int64_t)bh * a.sq;
  const float* di = a.di + (int64_t)bh * a.sq;
  float* dq = a.dq + (int64_t)bh * a.sq * D5;
  float* scr = sScr + warp * 256;

  load_tile<BKB5, D5, LDK5, NT5>(sK, k, k0, a.skv, a.d);
  load_tile<BKB5, D5, LDK5, NT5>(sV, v, k0, a.skv, a.d);

  // this warp's dK and dV column tiles: (warp * 4 + j) * 16, j < 4
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[4], acc_v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wmma::fill_fragment(acc_k[j], 0.0f);
    wmma::fill_fragment(acc_v[j], 0.0f);
  }
  // logits (warps 0-3) or dP (warps 4-7) for query rows (warp % 4) * 16
  const int sd_row = (warp % 4) * 16;
  const bf16* sd_a = warp < 4 ? sQ : sdO;
  const bf16* sd_b = warp < 4 ? sK : sV;
  float* sd_out = warp < 4 ? sS : sdP;
  // dQ tiles: query rows (warp % 4) * 16, columns (warp / 4) * 256 + 16 j
  const int dq_row = (warp % 4) * 16, dq_col = (warp / 4) * 256;

  for (int q0 = 0; q0 < a.sq; q0 += BQB5) {
    __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
    load_tile<BQB5, D5, LDK5, NT5>(sQ, q, q0, a.sq, a.d);
    load_tile<BQB5, D5, LDK5, NT5>(sdO, dout, q0, a.sq, a.d);
    for (int r = threadIdx.x; r < BQB5; r += NT5) {
      const bool in = q0 + r < a.sq;
      sLse[r] = in ? lse[q0 + r] : INFINITY;  // padded rows get P = 0
      sDi[r] = in ? di[q0 + r] : 0.0f;
    }
    __syncthreads();

    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll 8
      for (int kk = 0; kk < D5; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sd_a + sd_row * LDK5 + kk, LDK5);
        wmma::load_matrix_sync(fb, sd_b + kk, LDK5);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sd_out + sd_row * LDSB5, acc, LDSB5, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQB5 * BKB5; i += NT5) {
      const int r = i / BKB5, c = i % BKB5;
      const float p = c < kv_valid ? exp2f(sS[r * LDSB5 + c] - sLse[r]) : 0.0f;
      const float ds = p * (sdP[r * LDSB5 + c] - sDi[r]);
      sP[r * LDPB5 + c] = __float2bfloat16(p);
      sdS[r * LDPB5 + c] = __float2bfloat16(ds);
    }
    __syncthreads();

    // dV += P^T . dO ; dK += dS^T . q~  (kv rows 0..15, this warp's columns)
#pragma unroll
    for (int kk = 0; kk < BQB5; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fpt, fdst;
      wmma::load_matrix_sync(fpt, sP + kk * LDPB5, LDPB5);
      wmma::load_matrix_sync(fdst, sdS + kk * LDPB5, LDPB5);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (warp * 4 + j) * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fdo, fq;
        wmma::load_matrix_sync(fdo, sdO + kk * LDK5 + n, LDK5);
        wmma::load_matrix_sync(fq, sQ + kk * LDK5 + n, LDK5);
        wmma::mma_sync(acc_v[j], fpt, fdo, acc_v[j]);
        wmma::mma_sync(acc_k[j], fdst, fq, acc_k[j]);
      }
    }

    // dQ[16 x 256] += dS[16 x 16] . K[16 x 256], added into the fp32 buffer
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fds;
    wmma::load_matrix_sync(fds, sdS + dq_row * LDPB5, LDPB5);
    for (int j = 0; j < 16; ++j) {
      const int n = dq_col + j * 16;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      wmma::load_matrix_sync(fk, sK + n, LDK5);
      wmma::mma_sync(acc, fds, fk, acc);
      wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 64; e += 32) {  // 64 float4 per 16 x 16 tile
        const int row = q0 + dq_row + e / 4, col = n + (e % 4) * 4;
        if (row < a.sq) {
          const float4 val = reinterpret_cast<const float4*>(scr)[e];
          atomicAdd(reinterpret_cast<float4*>(dq + (int64_t)row * D5 + col), val);
        }
      }
      __syncwarp();
    }
  }

  // dk = dS^T . q~ / log2(e), as in flash_bwd_wgmma
  bf16* dk = a.dk + (int64_t)bh * a.skv * D5;
  bf16* dv = a.dv + (int64_t)bh * a.skv * D5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = (warp * 4 + j) * 16;
    for (int pass = 0; pass < 2; ++pass) {
      wmma::store_matrix_sync(scr, pass == 0 ? acc_k[j] : acc_v[j], 16, wmma::mem_row_major);
      __syncwarp();
      bf16* dst = pass == 0 ? dk : dv;
      const float mul = pass == 0 ? INV_LOG2E : 1.0f;
      for (int e = lane; e < 256; e += 32) {
        const int r = e / 16, c = e % 16;
        if (r < kv_valid) dst[(int64_t)(k0 + r) * D5 + n + c] = __float2bfloat16(scr[e] * mul);
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// head dim 512, fp32 forward (FFMA)
// ---------------------------------------------------------------------------

constexpr int BQF = 32;           // query rows per block
constexpr int BKF = 64;           // kv rows per tile
constexpr int LDF = D5 + 4;       // fp32 row stride of the q and k/v tiles
constexpr int LDSF = BKF + 4;     // fp32 row stride of the logits tile

struct FwdArgsF32 {
  const float* q;
  const float* k;
  const float* v;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float* o;               // [B, H, Sq, 512] contiguous
  float* lse;             // [B, H, Sq] contiguous
  int heads, sq, skv;
};

constexpr size_t fwdf32_smem_bytes() {
  return sizeof(float) * ((size_t)(BQF + BKF) * LDF + (size_t)BQF * LDSF);
}

__global__ void __launch_bounds__(NT5, 1) flash_fwd_f32_kernel(FwdArgsF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);
  float* sKV = sQ + BQF * LDF;
  float* sS = sKV + BKF * LDF;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * BQF;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Rows<float> q = {a.q + b * a.q_sb + h * a.q_sh, a.q_ss};
  const Rows<float> k = {a.k + b * a.k_sb + h * a.k_sh, a.k_ss};
  const Rows<float> v = {a.v + b * a.v_sb + h * a.v_sh, a.v_ss};

  load_tile<BQF, D5, LDF, NT5>(sQ, q, q0, a.sq, D5);

  // logits: thread t owns rows 2 (t / 16) + {0, 1}, columns t % 16 + 16 j
  const int s_r = (threadIdx.x / 16) * 2, s_c = threadIdx.x % 16;
  // softmax and P.V: warp w owns query rows 4 w .. 4 w + 3; lane l owns
  // columns 4 l + 128 m + {0..3}, m < 4
  float o[4][16];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < 16; ++c) o[i][c] = 0.0f;
  }

  for (int k0 = 0; k0 < a.skv; k0 += BKF) {
    __syncthreads();  // the previous tile's readers of sKV/sS are done
    load_tile<BKF, D5, LDF, NT5>(sKV, k, k0, a.skv, D5);
    __syncthreads();
    {
      float acc[2][4] = {};
      for (int kk = 0; kk < D5; kk += 4) {
        float4 qv[2], kv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (s_r + i) * LDF + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sKV + (s_c + 16 * j) * LDF + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(qv[i].x, kv[j].x, acc[i][j]);
            acc[i][j] = fmaf(qv[i].y, kv[j].y, acc[i][j]);
            acc[i][j] = fmaf(qv[i].z, kv[j].z, acc[i][j]);
            acc[i][j] = fmaf(qv[i].w, kv[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sS[(s_r + i) * LDSF + s_c + 16 * j] = acc[i][j];
      }
    }
    __syncthreads();  // S is whole and K is no longer read
    load_tile<BKF, D5, LDF, NT5>(sKV, v, k0, a.skv, D5);

    // online softmax of this warp's rows; P overwrites S, O is rescaled in registers
    const int kv_valid = min(BKF, a.skv - k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = warp * 4 + i;
      const float s0 = lane < kv_valid ? sS[r * LDSF + lane] : -INFINITY;
      const float s1 = lane + 32 < kv_valid ? sS[r * LDSF + lane + 32] : -INFINITY;
      const float m_new = fmaxf(m_run[i], warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      const float alpha = exp2f(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p0 + p1);
      m_run[i] = m_new;
      sS[r * LDSF + lane] = p0;
      sS[r * LDSF + lane + 32] = p1;
#pragma unroll
      for (int c = 0; c < 16; ++c) o[i][c] *= alpha;
    }
    __syncthreads();  // V is in place (P of this warp's rows is its own)

    for (int j = 0; j < BKF; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = sS[(warp * 4 + i) * LDSF + j];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 vv = *reinterpret_cast<const float4*>(sKV + j * LDF + lane * 4 + 128 * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][4 * m + 0] = fmaf(p[i], vv.x, o[i][4 * m + 0]);
          o[i][4 * m + 1] = fmaf(p[i], vv.y, o[i][4 * m + 1]);
          o[i][4 * m + 2] = fmaf(p[i], vv.z, o[i][4 * m + 2]);
          o[i][4 * m + 3] = fmaf(p[i], vv.w, o[i][4 * m + 3]);
        }
      }
    }
  }

  float* out = a.o + (int64_t)bh * a.sq * D5;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + warp * 4 + i;
    if (row >= a.sq) continue;
    const float inv = 1.0f / l_run[i];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float4 val = make_float4(o[i][4 * m] * inv, o[i][4 * m + 1] * inv, o[i][4 * m + 2] * inv,
                                     o[i][4 * m + 3] * inv);
      *reinterpret_cast<float4*>(out + (int64_t)row * D5 + lane * 4 + 128 * m) = val;
    }
    if (lane == 0) a.lse[(int64_t)bh * a.sq + row] = m_run[i] + log2f(l_run[i]);
  }
}

// ---------------------------------------------------------------------------
// head dim 512, fp32 backward (FFMA)
// ---------------------------------------------------------------------------

constexpr int BKG = 16;           // kv rows per block
constexpr int BQG = 32;           // query rows per tile
constexpr int LDG = BKG + 4;      // fp32 row stride of the logits / dP tiles

struct BwdArgsF32 {
  const float* q;         // pre-scaled q
  const float* k;
  const float* v;
  const float* dout;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss;
  const float* lse;       // [B, H, Sq]
  const float* di;        // [B, H, Sq] rowsum(dO * O)
  float* dq;              // [B, H, Sq, 512], zeroed; receives dS . k
  float* dk;              // [B, H, Skv, 512]
  float* dv;              // [B, H, Skv, 512]
  int heads, sq, skv;
};

constexpr size_t bwdf32_smem_bytes() {
  return sizeof(float) * ((size_t)(2 * BKG + 2 * BQG) * LDF   // k, v, q, dO tiles
                          + (size_t)2 * BQG * LDG              // logits -> P, dP -> dS
                          + 2 * BQG);                          // lse, Di
}

__global__ void __launch_bounds__(NT5, 1) flash_bwd_f32_kernel(BwdArgsF32 a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sK = reinterpret_cast<float*>(smem);
  float* sV = sK + BKG * LDF;
  float* sQ = sV + BKG * LDF;
  float* sdO = sQ + BQG * LDF;
  float* sP = sdO + BQG * LDF;     // logits, then P
  float* sdS = sP + BQG * LDG;     // dP, then dS
  float* sLse = sdS + BQG * LDG;
  float* sDi = sLse + BQG;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * BKG;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kv_valid = min(BKG, a.skv - k0);
  const Rows<float> q = {a.q + b * a.q_sb + h * a.q_sh, a.q_ss};
  const Rows<float> k = {a.k + b * a.k_sb + h * a.k_sh, a.k_ss};
  const Rows<float> v = {a.v + b * a.v_sb + h * a.v_sh, a.v_ss};
  const Rows<float> dout = {a.dout + b * a.do_sb + h * a.do_sh, a.do_ss};
  const float* lse = a.lse + (int64_t)bh * a.sq;
  const float* di = a.di + (int64_t)bh * a.sq;
  float* dq = a.dq + (int64_t)bh * a.sq * D5;

  load_tile<BKG, D5, LDF, NT5>(sK, k, k0, a.skv, D5);
  load_tile<BKG, D5, LDF, NT5>(sV, v, k0, a.skv, D5);

  // dK, dV: warp w owns kv rows 2 w + {0, 1}; lane l owns columns
  // 4 l + 128 m + {0..3}, m < 4 (the forward's column layout)
  float acc_k[2][16], acc_v[2][16];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      acc_k[i][c] = 0.0f;
      acc_v[i][c] = 0.0f;
    }
  }
  // logits (warps 0-3) or dP (warps 4-7): thread u of the 128 owns query rows
  // 2 (u / 8) + {0, 1} and kv rows u % 8 + {0, 8}
  const int u = threadIdx.x % 128;
  const int sd_r = (u / 8) * 2, sd_c = u % 8;
  const float* sd_a = warp < 4 ? sQ : sdO;
  const float* sd_b = warp < 4 ? sK : sV;
  float* sd_out = warp < 4 ? sP : sdS;

  for (int q0 = 0; q0 < a.sq; q0 += BQG) {
    __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
    load_tile<BQG, D5, LDF, NT5>(sQ, q, q0, a.sq, D5);
    load_tile<BQG, D5, LDF, NT5>(sdO, dout, q0, a.sq, D5);
    for (int r = threadIdx.x; r < BQG; r += NT5) {
      const bool in = q0 + r < a.sq;
      sLse[r] = in ? lse[q0 + r] : INFINITY;  // padded rows get P = 0
      sDi[r] = in ? di[q0 + r] : 0.0f;
    }
    __syncthreads();

    {
      float acc[2][2] = {};
      for (int kk = 0; kk < D5; kk += 4) {
        float4 av[2], bv[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) av[i] = *reinterpret_cast<const float4*>(sd_a + (sd_r + i) * LDF + kk);
#pragma unroll
        for (int j = 0; j < 2; ++j) bv[j] = *reinterpret_cast<const float4*>(sd_b + (sd_c + 8 * j) * LDF + kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) sd_out[(sd_r + i) * LDG + sd_c + 8 * j] = acc[i][j];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQG * BKG; i += NT5) {
      const int r = i / BKG, c = i % BKG;
      const float p = c < kv_valid ? exp2f(sP[r * LDG + c] - sLse[r]) : 0.0f;
      sdS[r * LDG + c] = p * (sdS[r * LDG + c] - sDi[r]);
      sP[r * LDG + c] = p;
    }
    __syncthreads();

    // dV += P^T . dO ; dK += dS^T . q~  (this warp's two kv rows)
    for (int r = 0; r < BQG; ++r) {
      const float2 p = *reinterpret_cast<const float2*>(sP + r * LDG + 2 * warp);
      const float2 ds = *reinterpret_cast<const float2*>(sdS + r * LDG + 2 * warp);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 dov = *reinterpret_cast<const float4*>(sdO + r * LDF + lane * 4 + 128 * m);
        const float4 qv = *reinterpret_cast<const float4*>(sQ + r * LDF + lane * 4 + 128 * m);
        acc_v[0][4 * m + 0] = fmaf(p.x, dov.x, acc_v[0][4 * m + 0]);
        acc_v[0][4 * m + 1] = fmaf(p.x, dov.y, acc_v[0][4 * m + 1]);
        acc_v[0][4 * m + 2] = fmaf(p.x, dov.z, acc_v[0][4 * m + 2]);
        acc_v[0][4 * m + 3] = fmaf(p.x, dov.w, acc_v[0][4 * m + 3]);
        acc_v[1][4 * m + 0] = fmaf(p.y, dov.x, acc_v[1][4 * m + 0]);
        acc_v[1][4 * m + 1] = fmaf(p.y, dov.y, acc_v[1][4 * m + 1]);
        acc_v[1][4 * m + 2] = fmaf(p.y, dov.z, acc_v[1][4 * m + 2]);
        acc_v[1][4 * m + 3] = fmaf(p.y, dov.w, acc_v[1][4 * m + 3]);
        acc_k[0][4 * m + 0] = fmaf(ds.x, qv.x, acc_k[0][4 * m + 0]);
        acc_k[0][4 * m + 1] = fmaf(ds.x, qv.y, acc_k[0][4 * m + 1]);
        acc_k[0][4 * m + 2] = fmaf(ds.x, qv.z, acc_k[0][4 * m + 2]);
        acc_k[0][4 * m + 3] = fmaf(ds.x, qv.w, acc_k[0][4 * m + 3]);
        acc_k[1][4 * m + 0] = fmaf(ds.y, qv.x, acc_k[1][4 * m + 0]);
        acc_k[1][4 * m + 1] = fmaf(ds.y, qv.y, acc_k[1][4 * m + 1]);
        acc_k[1][4 * m + 2] = fmaf(ds.y, qv.z, acc_k[1][4 * m + 2]);
        acc_k[1][4 * m + 3] = fmaf(ds.y, qv.w, acc_k[1][4 * m + 3]);
      }
    }

    // dQ[4 rows of this warp x 512] = dS . K, added into the fp32 buffer
    float acc_q[4][16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 16; ++c) acc_q[i][c] = 0.0f;
    }
    for (int j = 0; j < BKG; ++j) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sdS[(warp * 4 + i) * LDG + j];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + j * LDF + lane * 4 + 128 * m);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_q[i][4 * m + 0] = fmaf(ds[i], kv.x, acc_q[i][4 * m + 0]);
          acc_q[i][4 * m + 1] = fmaf(ds[i], kv.y, acc_q[i][4 * m + 1]);
          acc_q[i][4 * m + 2] = fmaf(ds[i], kv.z, acc_q[i][4 * m + 2]);
          acc_q[i][4 * m + 3] = fmaf(ds[i], kv.w, acc_q[i][4 * m + 3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + warp * 4 + i;
      if (row >= a.sq) continue;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float4 val = make_float4(acc_q[i][4 * m], acc_q[i][4 * m + 1], acc_q[i][4 * m + 2],
                                       acc_q[i][4 * m + 3]);
        atomicAdd(reinterpret_cast<float4*>(dq + (int64_t)row * D5 + lane * 4 + 128 * m), val);
      }
    }
  }

  // dk = dS^T . q~ / log2(e), as in flash_bwd_wgmma
  float* dk = a.dk + (int64_t)bh * a.skv * D5;
  float* dv = a.dv + (int64_t)bh * a.skv * D5;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + 2 * warp + i;
    if (row >= a.skv) continue;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int col = lane * 4 + 128 * m;
      *reinterpret_cast<float4*>(dk + (int64_t)row * D5 + col) =
          make_float4(acc_k[i][4 * m] * INV_LOG2E, acc_k[i][4 * m + 1] * INV_LOG2E,
                      acc_k[i][4 * m + 2] * INV_LOG2E, acc_k[i][4 * m + 3] * INV_LOG2E);
      *reinterpret_cast<float4*>(dv + (int64_t)row * D5 + col) =
          make_float4(acc_v[i][4 * m], acc_v[i][4 * m + 1], acc_v[i][4 * m + 2], acc_v[i][4 * m + 3]);
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

cudaError_t launch_fwd512(const FwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fwd512_smem_bytes();
  cudaError_t err = allow_smem(flash_fwd512_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQ5 - 1) / BQ5, batch * a.heads);
  flash_fwd512_kernel<<<grid, NT5, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bwd512(const BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = bwd512_smem_bytes();
  cudaError_t err = allow_smem(flash_bwd512_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.skv + BKB5 - 1) / BKB5, batch * a.heads);
  flash_bwd512_kernel<<<grid, NT5, smem, stream>>>(a);
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
    case 512: {
      FwdArgs a;
      a.q = {static_cast<const bf16*>(q), q_ss};
      a.k = {static_cast<const bf16*>(k), k_ss};
      a.v = {static_cast<const bf16*>(v), v_ss};
      a.q_sb = q_sb; a.q_sh = q_sh; a.k_sb = k_sb; a.k_sh = k_sh; a.v_sb = v_sb; a.v_sh = v_sh;
      a.o = static_cast<bf16*>(o);
      a.lse = static_cast<float*>(lse);
      a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv; a.d = (int)d;
      return launch_fwd512(a, (int)batch, s);
    }
    default: return cudaErrorInvalidValue;
  }
}

// q (pre-scaled), k, v, dout: strided bf16 as in flash_fwd_bf16; lse, di:
// fp32 [B, H, Sq]; dq: zeroed fp32 [B, H, Sq, d]; dk, dv: bf16 [B, H, Skv, d].
// d = 40, 64, 80, 160: dq receives dS . k . scale; the q range is split over
// `splits` blocks per kv tile, and with splits > 1 dk and dv are summed into
// the zeroed fp32 dk_acc, dv_acc [B, H, Skv, d] (dk, dv untouched).
// d = 512: dq receives dS . k (the caller multiplies by scale); splits must
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
    case 512: {
      if (splits != 1) return cudaErrorInvalidValue;
      BwdArgs a;
      a.q = {static_cast<const bf16*>(q), q_ss};
      a.k = {static_cast<const bf16*>(k), k_ss};
      a.v = {static_cast<const bf16*>(v), v_ss};
      a.dout = {static_cast<const bf16*>(dout), do_ss};
      a.q_sb = q_sb; a.q_sh = q_sh; a.k_sb = k_sb; a.k_sh = k_sh;
      a.v_sb = v_sb; a.v_sh = v_sh; a.do_sb = do_sb; a.do_sh = do_sh;
      a.lse = static_cast<const float*>(lse);
      a.di = static_cast<const float*>(di);
      a.dq = static_cast<float*>(dq);
      a.dk = static_cast<bf16*>(dk);
      a.dv = static_cast<bf16*>(dv);
      a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv; a.d = (int)d;
      return launch_bwd512(a, (int)batch, s);
    }
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_BWD_WGMMA
}

// q (pre-scaled), k, v: fp32 [B, H, S, 512] strided as in flash_fwd_bf16.
// Writes o fp32 [B, H, Sq, 512] and lse [B, H, Sq].
int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                  int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                  int64_t q_sb, int64_t q_sh, int64_t q_ss,
                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  void* stream) {
  if (d != D5) return cudaErrorInvalidValue;
  FwdArgsF32 a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv;
  const size_t smem = fwdf32_smem_bytes();
  cudaError_t err = allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQF - 1) / BQF, (int)batch * a.heads);
  flash_fwd_f32_kernel<<<grid, NT5, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// q (pre-scaled), k, v, dout: fp32 [B, H, S, 512] strided as in flash_fwd_bf16;
// lse, di: fp32 [B, H, Sq]. dq: zeroed fp32 [B, H, Sq, 512] receiving dS . k
// (the caller multiplies by scale); dk, dv: fp32 [B, H, Skv, 512].
int flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* di, void* dq, void* dk, void* dv,
                  int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                  int64_t q_sb, int64_t q_sh, int64_t q_ss,
                  int64_t k_sb, int64_t k_sh, int64_t k_ss,
                  int64_t v_sb, int64_t v_sh, int64_t v_ss,
                  int64_t do_sb, int64_t do_sh, int64_t do_ss,
                  void* stream) {
  if (d != D5) return cudaErrorInvalidValue;
  BwdArgsF32 a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.dout = static_cast<const float*>(dout);
  a.q_sb = q_sb; a.q_sh = q_sh; a.q_ss = q_ss;
  a.k_sb = k_sb; a.k_sh = k_sh; a.k_ss = k_ss;
  a.v_sb = v_sb; a.v_sh = v_sh; a.v_ss = v_ss;
  a.do_sb = do_sb; a.do_sh = do_sh; a.do_ss = do_ss;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv;
  const size_t smem = bwdf32_smem_bytes();
  cudaError_t err = allow_smem(flash_bwd_f32_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.skv + BKG - 1) / BKG, (int)batch * a.heads);
  flash_bwd_f32_kernel<<<grid, NT5, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
