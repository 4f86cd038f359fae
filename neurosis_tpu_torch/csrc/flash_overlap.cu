// Flash attention forward with the next chunk's logits formed ahead of this
// chunk's softmax, for Hopper (sm_90a): bf16 in, fp32 accumulate, head dim 64.
//
// Replaces the two Pallas TPU kernels of the experiment tool
// tools/overlap_bench.py:
//   _split2_kernel  (:37)  -> flash_fwd_split2   (2 chunks)
//   _chunked_kernel (:66)  -> flash_fwd_chunked  (n chunks)
// Both compute softmax(q~ k^T) v for one block of queries against the whole
// kv row, cut into n equal chunks, with q~ pre-scaled by scale*log2(e), base-2
// logits and the online rescale (running max, sum, output) carried from chunk
// to chunk. What sets them apart from the main forward kernel is the order of
// work: the logits of chunk i+1 are formed before the max/exp2/sum and the
// P.V product of chunk i, so that a machine whose matrix unit runs beside its
// vector unit can overlap the two. The TPU kernels also write a natural-log
// LSE that their callers drop; these write the output only.
//
// What differs on the H100. The TPU kernels hold the whole kv row of a
// (batch, head) in VMEM (1 MB of K and V at 4096 keys); a block here has
// 227 KB, so kv streams through shared memory in stages of 128 rows. A chunk
// of up to 128 rows is one stage, its missing rows masked; a longer chunk is
// walked in 128-row stages, each scheduled like a chunk (an online-softmax step gives the same
// result at any granularity). The schedule is kept: two logits buffers and two
// K buffers in shared memory, and stage s+1's q~ k^T is formed before stage
// s's softmax and P.V. One block owns 64 query rows; each of its 4 warps owns
// 16 of them through all three phases, so only the tile loads need block
// barriers. The products are WMMA 16x16x16 bf16 with fp32 accumulators, which
// a warp runs synchronously: the early start cannot overlap anything yet.
// Asynchronous wgmma and cp.async/TMA loads are where this schedule pays, and
// are left for a later change. Operation-bound on the H100: 4 Sq Skv 64 flops
// a (batch, head) over bf16 tensor cores.

#include <math.h>
#include <mma.h>

#include "flash_common.cuh"

using namespace nvcuda;

namespace {

constexpr int D = 64;             // head dim
constexpr int BQ = 64;            // query rows per block
constexpr int NWARPS = 4;         // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDK = D + 8;        // bf16 row stride of a q/k/v tile
constexpr int LDO = D + 4;        // fp32 row stride of the output accumulator
constexpr int BKS = 128;          // kv rows a stage holds
constexpr int LDS = BKS + 4;      // fp32 row stride of a logits buffer
constexpr int LDP = BKS + 8;      // bf16 row stride of the probabilities
constexpr int NC = BKS / 32;      // logits columns per lane

struct OverlapArgs {
  StridedRows q, k, v;   // base pointers of (b=0, h=0); q is pre-scaled
  int64_t q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  bf16* o;               // [B, H, Sq, 64] contiguous
  int heads, sq, skv, n_chunks;
};

constexpr size_t SMEM_BYTES =
    sizeof(bf16) * (size_t)(BQ + 3 * BKS) * LDK        // q, two k tiles, v
    + sizeof(float) * (size_t)2 * BQ * LDS             // two logits buffers
    + sizeof(bf16) * (size_t)BQ * LDP                  // probabilities
    + sizeof(float) * (size_t)BQ * LDO                 // output accumulator
    + sizeof(float) * 2 * BQ;                          // running max, sum

// s[16 x BKS] = a[16 x 64] . b[BKS x 64]^T for one warp's 16 query rows
__device__ __forceinline__ void logits_tile(const bf16* a, const bf16* b, float* s) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKS / 16];
#pragma unroll
  for (int j = 0; j < BKS / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk, LDK);
#pragma unroll
    for (int j = 0; j < BKS / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, b + j * 16 * LDK + kk, LDK);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BKS / 16; ++j) wmma::store_matrix_sync(s + j * 16, acc[j], LDS, wmma::mem_row_major);
}

__global__ void __launch_bounds__(NTHREADS) flash_fwd_overlap_kernel(OverlapArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LDK;                     // two buffers of BKS rows
  bf16* sV = sK + 2 * BKS * LDK;
  float* sS = reinterpret_cast<float*>(sV + BKS * LDK);   // two buffers of BQ rows
  bf16* sP = reinterpret_cast<bf16*>(sS + 2 * BQ * LDS);
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

  // stage s covers kv rows [stage_k0(s), stage_k0(s) + stage_rows(s)) of its chunk
  const int chunk = a.skv / a.n_chunks;
  const int per_chunk = (chunk + BKS - 1) / BKS;
  const int n_stages = a.n_chunks * per_chunk;
  auto stage_k0 = [&](int s) { return (s / per_chunk) * chunk + (s % per_chunk) * BKS; };
  auto stage_rows = [&](int s) { return min(BKS, chunk - (s % per_chunk) * BKS); };

  load_tile<BQ, D, LDK, NTHREADS>(sQ, q, q0, a.sq, D);
  load_tile<BKS, D, LDK, NTHREADS>(sK, k, stage_k0(0), stage_k0(0) + stage_rows(0), D);
  for (int i = threadIdx.x; i < BQ * LDO; i += NTHREADS) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.0f;
  }
  __syncthreads();
  logits_tile(sQ + r0 * LDK, sK, sS + r0 * LDS);

  for (int s = 0; s < n_stages; ++s) {
    const bool more = s + 1 < n_stages;
    bf16* k_next = sK + ((s + 1) & 1) * BKS * LDK;
    const float* s_cur = sS + (s & 1) * BQ * LDS;
    float* s_next = sS + ((s + 1) & 1) * BQ * LDS;

    __syncthreads();  // stage s-1's readers of sV and of the other K buffer are done
    if (more) load_tile<BKS, D, LDK, NTHREADS>(k_next, k, stage_k0(s + 1), stage_k0(s + 1) + stage_rows(s + 1), D);
    load_tile<BKS, D, LDK, NTHREADS>(sV, v, stage_k0(s), stage_k0(s) + stage_rows(s), D);
    __syncthreads();

    // the next stage's logits, formed ahead of this stage's softmax and P.V
    if (more) logits_tile(sQ + r0 * LDK, k_next, s_next + r0 * LDS);
    __syncwarp();

    // online softmax over this warp's 16 rows, NC columns per lane
    const int valid = stage_rows(s);
    for (int r = r0; r < r0 + 16; ++r) {
      float sv[NC];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        sv[i] = c < valid ? s_cur[r * LDS + c] : -INFINITY;
        mx = fmaxf(mx, sv[i]);
      }
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + 32 * i;
        const float p = exp2f(sv[i] - m_new);
        sum += p;
        sP[r * LDP + c] = __float2bfloat16(p);
      }
      sum = warp_sum(sum);
      const float alpha = exp2f(m_old - m_new);
      for (int c = lane; c < D; c += 32) sO[r * LDO + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O[16 x 64] += P[16 x BKS] . V[BKS x 64]
    for (int n = 0; n < D; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + n, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKS; kk += 16) {
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

  bf16* o = a.o + (int64_t)bh * a.sq * D;
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < a.sq) o[(int64_t)(q0 + r) * D + c] = __float2bfloat16(sO[r * LDO + c] / sL[r]);
  }
}

cudaError_t launch_overlap(OverlapArgs a, int64_t batch, int64_t d, void* stream) {
  if (d != D || a.n_chunks < 1 || a.skv < 1 || a.skv % a.n_chunks != 0) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_overlap_kernel, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + BQ - 1) / BQ, (int)batch * a.heads);
  flash_fwd_overlap_kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

OverlapArgs make_args(const void* q, const void* k, const void* v, void* o, int64_t heads, int64_t sq,
                      int64_t skv, int64_t n_chunks, int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                      int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss) {
  OverlapArgs a;
  a.q = {static_cast<const bf16*>(q), q_ss};
  a.k = {static_cast<const bf16*>(k), k_ss};
  a.v = {static_cast<const bf16*>(v), v_ss};
  a.q_sb = q_sb; a.q_sh = q_sh; a.k_sb = k_sb; a.k_sh = k_sh; a.v_sb = v_sb; a.v_sh = v_sh;
  a.o = static_cast<bf16*>(o);
  a.heads = (int)heads; a.sq = (int)sq; a.skv = (int)skv; a.n_chunks = (int)n_chunks;
  return a;
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v: bf16 [B, H, S, 64] with unit stride on the head dim and
// the given element strides for batch, head and row. Writes o [B, H, Sq, 64].
// The kv row is processed as two halves; skv must be even.
int flash_fwd_split2(const void* q, const void* k, const void* v, void* o,
                     int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                     int64_t q_sb, int64_t q_sh, int64_t q_ss,
                     int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss,
                     void* stream) {
  return launch_overlap(make_args(q, k, v, o, heads, sq, skv, 2, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                  v_sb, v_sh, v_ss), batch, d, stream);
}

// The same for n_chunks equal chunks; skv must be a multiple of n_chunks.
int flash_fwd_chunked(const void* q, const void* k, const void* v, void* o,
                      int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d, int64_t n_chunks,
                      int64_t q_sb, int64_t q_sh, int64_t q_ss,
                      int64_t k_sb, int64_t k_sh, int64_t k_ss,
                      int64_t v_sb, int64_t v_sh, int64_t v_ss,
                      void* stream) {
  return launch_overlap(make_args(q, k, v, o, heads, sq, skv, n_chunks, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                                  v_sb, v_sh, v_ss), batch, d, stream);
}

}  // extern "C"
