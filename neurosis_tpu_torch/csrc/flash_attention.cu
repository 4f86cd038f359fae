// Flash attention forward and backward for Hopper (sm_90a), bf16 in, fp32 accumulate,
// and an fp32 forward for the VAE's fp32 encode.
//
// Replaces the Pallas TPU kernels of neurosis_tpu/ops/flash_attention.py:
//   forward  : _fwd_kernel (:297), _fwd_chunked_kernel (:366),
//              _fwd_streamed_kernel (:411), _fwd_wide_kernel (:575)
//   backward : _bwd_dq_kernel (:751), _bwd_dq_chunked_kernel (:811),
//              _bwd_dq_streamed_kernel (:472), _bwd_dq_wide_kernel (:843),
//              _bwd_dkv_kernel (:952), _bwd_dkv_chunked_kernel (:875),
//              _bwd_dkv_streamed_kernel (:519), _bwd_dkv_wide_kernel (:915)
// The TPU families differ only in how they fit VMEM; each computes one
// function, so there is one kernel per function here.
//
// Contract (as the JAX wrapper's): q arrives pre-scaled by scale*log2(e) and
// rounded to bf16, scale = 1/sqrt(d) of the true head dim. Logits are base 2,
// the softmax is online in fp32, the kv tail (kv=77 cross-attention) is
// masked, and the per-row LSE (base 2) is the backward residual.
//
// What bounds it on the H100: at d=40..160 attention is operation-bound
// (4*S*Skv*d flops over 2*(2*S+2*Skv)*d bytes is hundreds of flops per byte
// at S=4096). The design keeps the S x Skv logits out of device memory: one
// block owns 64 query rows and walks the kv range in 64-row tiles held in
// shared memory, with bf16 tensor-core products (WMMA 16x16x16, fp32
// accumulators). The backward is FA2-style: one block owns a 64-row kv
// tile, walks the q range, keeps dK/dV in shared fp32 and adds dQ into an
// fp32 buffer with atomics. Head dims are padded to a multiple of 16 inside
// shared memory (40 -> 48) and masked on store. TMA, wgmma and warp
// specialisation are left for a later change.
//
// Head dim 512 (the VAE's single-head mid attention) has its own tiling: at
// DP = 512 the 64-row tiles above need ~358 KB (forward) and ~584 KB
// (backward) of shared memory, past the 227 KB a block can have.
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

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // kv rows per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BK + 4;     // fp32 row stride of a logits tile
constexpr int LDP = BK + 8;     // bf16 row stride of a probabilities tile
constexpr float INV_LOG2E = 0.6931471805599453f;

template <typename T>
struct Rows {
  const T* ptr;      // row 0 of this (batch, head)
  int64_t stride;    // elements between rows
};
using StridedRows = Rows<bf16>;

// Copy rows [row0, row0+R) x [0, d) of a strided bf16 or fp32 matrix into a
// shared tile of R x DP (row stride LD) in 16-byte chunks; rows past n_rows
// and columns past d are zero.
template <int R, int DP, int LD, int NT = NTHREADS, typename T>
__device__ __forceinline__ void load_tile(T* dst, Rows<T> src, int row0, int n_rows, int d) {
  constexpr int PER = 16 / sizeof(T);  // elements per chunk
  constexpr int CHUNKS = DP / PER;
  for (int i = threadIdx.x; i < R * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * PER;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int row = row0 + r;
    if (row < n_rows && c < d) {
      v = *reinterpret_cast<const uint4*>(src.ptr + (int64_t)row * src.stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = v;
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[16 x BK] = A[16 x DP] . B[BK x DP]^T  for one warp's 16 rows, stored to S.
template <int DP, int LDA>
__device__ __forceinline__ void rows_times_tile_t(const bf16* a, const bf16* b, float* s) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDA);
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDA + kk, LDA);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) wmma::store_matrix_sync(s + j * 16, acc[j], LDS, wmma::mem_row_major);
}

struct FwdArgs {
  StridedRows q, k, v;   // base pointers of (b=0, h=0)
  int64_t q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  bf16* o;               // [B, H, Sq, d] contiguous
  float* lse;            // [B, H, Sq] contiguous
  int heads, sq, skv, d;
};

template <int DP>
constexpr size_t fwd_smem_bytes() {
  return sizeof(bf16) * (size_t)(BQ + 2 * BK) * (DP + 8)   // q, k, v tiles
       + sizeof(float) * (size_t)BQ * LDS                   // logits
       + sizeof(bf16) * (size_t)BQ * LDP                    // probabilities
       + sizeof(float) * (size_t)BQ * (DP + 4)              // output accumulator
       + sizeof(float) * 2 * BQ;                            // running max, sum
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(FwdArgs a) {
  constexpr int LDK = DP + 8;
  constexpr int LDO = DP + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDK;
  bf16* sV = sK + BK * LDK;
  float* sS = reinterpret_cast<float*>(sV + BK * LDK);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * LDS);
  float* sO = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sM = sO + BQ * LDO;
  float* sL = sM + BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  StridedRows q = {a.q.ptr + b * a.q_sb + h * a.q_sh, a.q.stride};
  StridedRows k = {a.k.ptr + b * a.k_sb + h * a.k_sh, a.k.stride};
  StridedRows v = {a.v.ptr + b * a.v_sb + h * a.v_sh, a.v.stride};

  load_tile<BQ, DP, LDK>(sQ, q, q0, a.sq, a.d);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }

  for (int k0 = 0; k0 < a.skv; k0 += BK) {
    __syncthreads();  // the previous tile's readers of sK/sV are done
    load_tile<BK, DP, LDK>(sK, k, k0, a.skv, a.d);
    load_tile<BK, DP, LDK>(sV, v, k0, a.skv, a.d);
    __syncthreads();

    rows_times_tile_t<DP, LDK>(sQ + r0 * LDK, sK, sS + r0 * LDS);
    __syncwarp();

    // online softmax over this warp's 16 rows, two columns per lane
    const int kv_valid = min(BK, a.skv - k0);
    for (int r = r0; r < r0 + 16; ++r) {
      const float s0 = lane < kv_valid ? sS[r * LDS + lane] : -INFINITY;
      const float s1 = lane + 32 < kv_valid ? sS[r * LDS + lane + 32] : -INFINITY;
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = exp2f(s0 - m_new);
      const float p1 = exp2f(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      const float alpha = exp2f(m_old - m_new);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      for (int c = lane; c < DP; c += 32) sO[r * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O[16 x DP] += P[16 x BK] . V[BK x DP]
    for (int n = 0; n < DP; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + n, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(fb, sV + kk * LDK + n, LDK);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + n, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  bf16* o = a.o + (int64_t)bh * a.sq * a.d;
  for (int i = threadIdx.x; i < BQ * a.d; i += NTHREADS) {
    const int r = i / a.d, c = i % a.d;
    if (q0 + r < a.sq) o[(int64_t)(q0 + r) * a.d + c] = __float2bfloat16(sO[r * LDO + c] / sL[r]);
  }
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    if (q0 + r < a.sq) a.lse[(int64_t)bh * a.sq + q0 + r] = sM[r] + log2f(sL[r]);
  }
}

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

template <int DP>
constexpr size_t bwd_smem_bytes() {
  return sizeof(bf16) * (size_t)(2 * BK + 2 * BQ) * (DP + 8)   // k, v, q, dO tiles
       + sizeof(float) * (size_t)2 * BQ * LDS                   // logits, dP
       + sizeof(bf16) * (size_t)2 * BQ * LDP                    // P, dS
       + sizeof(float) * (size_t)2 * BK * (DP + 4)              // dK, dV accumulators
       + sizeof(float) * (size_t)NWARPS * 256                   // per-warp dQ staging
       + sizeof(float) * 2 * BQ;                                // lse, Di
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kernel(BwdArgs a) {
  constexpr int LDK = DP + 8;
  constexpr int LDO = DP + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + BK * LDK;
  bf16* sQ = sV + BK * LDK;
  bf16* sdO = sQ + BQ * LDK;
  float* sS = reinterpret_cast<float*>(sdO + BQ * LDK);
  float* sdP = sS + BQ * LDS;
  bf16* sP = reinterpret_cast<bf16*>(sdP + BQ * LDS);
  bf16* sdS = sP + BQ * LDP;
  float* sdK = reinterpret_cast<float*>(sdS + BQ * LDP);
  float* sdV = sdK + BK * LDO;
  float* sScr = sdV + BK * LDO;
  float* sLse = sScr + NWARPS * 256;
  float* sDi = sLse + BQ;

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int kv_valid = min(BK, a.skv - k0);

  StridedRows q = {a.q.ptr + b * a.q_sb + h * a.q_sh, a.q.stride};
  StridedRows k = {a.k.ptr + b * a.k_sb + h * a.k_sh, a.k.stride};
  StridedRows v = {a.v.ptr + b * a.v_sb + h * a.v_sh, a.v.stride};
  StridedRows dout = {a.dout.ptr + b * a.do_sb + h * a.do_sh, a.dout.stride};
  const float* lse = a.lse + (int64_t)bh * a.sq;
  const float* di = a.di + (int64_t)bh * a.sq;
  float* dq = a.dq + (int64_t)bh * a.sq * a.d;
  float* scr = sScr + warp * 256;

  load_tile<BK, DP, LDK>(sK, k, k0, a.skv, a.d);
  load_tile<BK, DP, LDK>(sV, v, k0, a.skv, a.d);
  for (int i = threadIdx.x; i < BK * LDO; i += NTHREADS) {
    sdK[i] = 0.0f;
    sdV[i] = 0.0f;
  }

  for (int q0 = 0; q0 < a.sq; q0 += BQ) {
    __syncthreads();  // the previous tile's readers of sQ/sdO/sP/sdS are done
    load_tile<BQ, DP, LDK>(sQ, q, q0, a.sq, a.d);
    load_tile<BQ, DP, LDK>(sdO, dout, q0, a.sq, a.d);
    for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
      const bool in = q0 + r < a.sq;
      sLse[r] = in ? lse[q0 + r] : INFINITY;  // padded rows get P = 0
      sDi[r] = in ? di[q0 + r] : 0.0f;
    }
    __syncthreads();

    rows_times_tile_t<DP, LDK>(sQ + r0 * LDK, sK, sS + r0 * LDS);    // base-2 logits
    rows_times_tile_t<DP, LDK>(sdO + r0 * LDK, sV, sdP + r0 * LDS);  // dP = dO . V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      for (int c = lane; c < BK; c += 32) {
        const float p = c < kv_valid ? exp2f(sS[r * LDS + c] - sLse[r]) : 0.0f;
        const float ds = p * (sdP[r * LDS + c] - sDi[r]);
        sP[r * LDP + c] = __float2bfloat16(p);
        sdS[r * LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncthreads();

    // dV[kv rows r0..] += P^T . dO ; dK[kv rows r0..] += dS^T . q~
    for (int n = 0; n < DP; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_v, acc_k;
      wmma::load_matrix_sync(acc_v, sdV + r0 * LDO + n, LDO, wmma::mem_row_major);
      wmma::load_matrix_sync(acc_k, sdK + r0 * LDO + n, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fpt, fdst;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fdo, fq;
        wmma::load_matrix_sync(fpt, sP + kk * LDP + r0, LDP);
        wmma::load_matrix_sync(fdst, sdS + kk * LDP + r0, LDP);
        wmma::load_matrix_sync(fdo, sdO + kk * LDK + n, LDK);
        wmma::load_matrix_sync(fq, sQ + kk * LDK + n, LDK);
        wmma::mma_sync(acc_v, fpt, fdo, acc_v);
        wmma::mma_sync(acc_k, fdst, fq, acc_k);
      }
      wmma::store_matrix_sync(sdV + r0 * LDO + n, acc_v, LDO, wmma::mem_row_major);
      wmma::store_matrix_sync(sdK + r0 * LDO + n, acc_k, LDO, wmma::mem_row_major);
    }

    // dQ[q rows r0..] += dS . K, added into the fp32 buffer
    for (int n = 0; n < DP; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fds;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fk;
        wmma::load_matrix_sync(fds, sdS + r0 * LDP + kk, LDP);
        wmma::load_matrix_sync(fk, sK + kk * LDK + n, LDK);
        wmma::mma_sync(acc, fds, fk, acc);
      }
      wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = q0 + r0 + e / 16, col = n + e % 16;
        if (row < a.sq && col < a.d) atomicAdd(dq + (int64_t)row * a.d + col, scr[e]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // dk = dS^T . q~ / log2(e): q~ = q * scale * log2(e), dk = dS^T . q * scale
  bf16* dk = a.dk + (int64_t)bh * a.skv * a.d;
  bf16* dv = a.dv + (int64_t)bh * a.skv * a.d;
  for (int i = threadIdx.x; i < kv_valid * a.d; i += NTHREADS) {
    const int r = i / a.d, c = i % a.d;
    dk[(int64_t)(k0 + r) * a.d + c] = __float2bfloat16(sdK[r * LDO + c] * INV_LOG2E);
    dv[(int64_t)(k0 + r) * a.d + c] = __float2bfloat16(sdV[r * LDO + c]);
  }
}

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

  // dk = dS^T . q~ / log2(e), as in flash_bwd_kernel
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

template <int DP>
cudaError_t launch_fwd(const FwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQ - 1) / BQ, batch * a.heads);
  flash_fwd_kernel<DP><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd(const BwdArgs& a, int batch, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<DP>();
  cudaError_t err = allow_smem(flash_bwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.skv + BK - 1) / BK, batch * a.heads);
  flash_bwd_kernel<DP><<<grid, NTHREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v: bf16 [B, H, S, d] with unit stride on d and the given element
// strides for batch, head and row. Writes o [B, H, Sq, d] and lse [B, H, Sq].
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                   int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                   void* stream) {
  FwdArgs a;
  a.q = {static_cast<const bf16*>(q), q_ss};
  a.k = {static_cast<const bf16*>(k), k_ss};
  a.v = {static_cast<const bf16*>(v), v_ss};
  a.q_sb = q_sb; a.q_sh = q_sh; a.k_sb = k_sb; a.k_sh = k_sh; a.v_sb = v_sb; a.v_sh = v_sh;
  a.o = static_cast<bf16*>(o);
  a.lse = static_cast<float*>(lse);
  a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv; a.d = (int)d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch_fwd<48>(a, (int)batch, s);
    case 64: return launch_fwd<64>(a, (int)batch, s);
    case 80: return launch_fwd<80>(a, (int)batch, s);
    case 160: return launch_fwd<160>(a, (int)batch, s);
    case 512: return launch_fwd512(a, (int)batch, s);
    default: return cudaErrorInvalidValue;
  }
}

// q (pre-scaled), k, v, dout: strided bf16 as in flash_fwd_bf16; lse, di:
// fp32 [B, H, Sq]. dq: zeroed fp32 [B, H, Sq, d] receiving dS . k (the
// caller multiplies by scale); dk, dv: bf16 [B, H, Skv, d].
int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* di, void* dq, void* dk, void* dv,
                   int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                   int64_t q_sb, int64_t q_sh, int64_t q_ss,
                   int64_t k_sb, int64_t k_sh, int64_t k_ss,
                   int64_t v_sb, int64_t v_sh, int64_t v_ss,
                   int64_t do_sb, int64_t do_sh, int64_t do_ss,
                   void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch_bwd<48>(a, (int)batch, s);
    case 64: return launch_bwd<64>(a, (int)batch, s);
    case 80: return launch_bwd<80>(a, (int)batch, s);
    case 160: return launch_bwd<160>(a, (int)batch, s);
    case 512: return launch_bwd512(a, (int)batch, s);
    default: return cudaErrorInvalidValue;
  }
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

}  // extern "C"
