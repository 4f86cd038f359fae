// Flash attention forward and backward for Hopper (sm_90a), bf16 in, fp32 accumulate.
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

struct StridedRows {
  const bf16* ptr;   // row 0 of this (batch, head)
  int64_t stride;    // elements between rows
};

// Copy rows [row0, row0+R) x [0, d) of a strided bf16 matrix into a shared
// tile of R x DP (row stride LD); rows past n_rows and columns past d are zero.
template <int R, int DP, int LD>
__device__ __forceinline__ void load_tile(bf16* dst, StridedRows src, int row0, int n_rows, int d) {
  constexpr int CHUNKS = DP / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < R * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 8;
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
