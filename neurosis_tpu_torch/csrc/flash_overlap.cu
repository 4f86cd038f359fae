// Flash attention forward with the next stage's logits in flight while this
// stage's softmax runs, for Hopper (sm_90a): bf16 in, fp32 accumulate, head dim 64.
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
// LSE that their callers drop; these write the output only. Bound on the H100
// by 4 Sq Skv 64 operations a (batch, head) on the bf16 tensor cores.
//
// The design is the main forward's at head dim 64 (flash_fwd_wgmma<64>,
// csrc/flash_attention.cu) with the tool's schedule. A block is two consumer
// warpgroups of 64 query rows and a producer warpgroup whose one warp moves q~
// once and the K and V of each stage by TMA (64-column boxes, 128-byte
// swizzle) into a ring of 3 stages. The TPU kernels hold the whole kv row in
// VMEM; here kv streams in stages: a chunk of up to 128 rows is one stage, a
// longer chunk 128-row stages, and a stage never crosses a chunk boundary. Its
// TMA box starts at the stage's first row; the box's rows past the stage (the
// next chunk's, or TMA's zeros past Skv) are masked to -inf in registers, so a
// chunk shorter than a box still rounds P at its own running max, as the
// plain version does. Inside each consumer warpgroup, stage s+1's S = q~
// K^T is issued as an asynchronous wgmma (SS, N = 128) into the second of two
// logits accumulators before stage s's max, exp2 and sum run on the CUDA cores;
// then O += P V is issued (RS wgmma, P as bf16 registers, V MN-major), and one
// wait_group 0 awaits both before the next stage reads their registers.
// ptxas serialises every wgmma of the kernel (its C7513/C7515 notes) when a
// non-wgmma instruction writes a logits accumulator while the other one's
// wgmma is in flight, or when P V stays in flight into the next stage; so a
// short stage's mask is applied before the next logits are issued, and no
// wgmma outlives its stage. Registers a thread: two logits accumulators of 64,
// O of 32, P of 32.

#include <math.h>

#include "flash_common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int D = 64;                  // head dim: one 64-column box
constexpr int BQ = 128;                // query rows a block, 64 a consumer warpgroup
constexpr int BKS = 128;               // kv rows a stage holds
constexpr int STAGES = 3;              // K and V land up to two stages ahead of the one read
constexpr int Q_BYTES = BQ * ROW;
constexpr int KV_BYTES = BKS * ROW;    // one of K, V
constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);

struct OverlapTma {
  CUtensorMap q, k, v;  // boxes of 64 columns x BQ (q) or BKS (k, v) rows
  bf16* o;              // [B, H, Sq, 64] contiguous
  int heads, sq;
  int chunk, per_chunk, n_stages;  // kv rows a chunk, stages a chunk, stages in all
};

// stage s covers kv rows [stage_k0(s), stage_k0(s) + stage_rows(s)) of chunk s / per_chunk
__device__ __forceinline__ int stage_k0(const OverlapTma& p, int s) {
  return (s / p.per_chunk) * p.chunk + (s % p.per_chunk) * BKS;
}
__device__ __forceinline__ int stage_rows(const OverlapTma& p, int s) {
  return min(BKS, p.chunk - (s % p.per_chunk) * BKS);
}

// issue S = q~ K^T of stage s (both K-major) into s_acc, once its stage has landed
__device__ __forceinline__ void issue_logits(float (&s_acc)[BKS / 2], const unsigned char* q_wg,
                                             const unsigned char* sK, uint64_t* kv_full, int s) {
  mbar_wait(&kv_full[s % STAGES], (s / STAGES) & 1);
  const unsigned char* k_tile = sK + (s % STAGES) * KV_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    Wgmma<BKS>::ss<0, 0>(s_acc, sw128_desc(q_wg + 32 * kk, 0), sw128_desc(k_tile + 32 * kk, 0), kk > 0);
  }
  wgmma_commit();
}

struct Softmax {
  float o[D / 2];
  float m0, m1, l0, l1;  // running max and this thread's part of the row sums
};

// One stage of a consumer warpgroup: mask this stage's logits `cur` if the stage
// is short, issue the next stage's logits into `nxt`, run this stage's softmax
// meanwhile, issue O += P V, and wait for both products.
__device__ __forceinline__ void overlap_stage(const OverlapTma& p, float (&cur)[BKS / 2], float (&nxt)[BKS / 2],
                                              Softmax& st, uint32_t (&pf)[BKS / 16][4], const unsigned char* q_wg,
                                              const unsigned char* sK, const unsigned char* sV, uint64_t* kv_full,
                                              uint64_t* kv_empty, int s, int qd, int lane) {
  const int valid = stage_rows(p, s);  // the box's rows past the stage become -inf
  if (valid < BKS) {
#pragma unroll
    for (int c = 0; c < BKS / 8; ++c) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (8 * c + 2 * qd + j >= valid) cur[4 * c + j] = cur[4 * c + 2 + j] = -INFINITY;
      }
    }
  }

  if (s + 1 < p.n_stages) issue_logits(nxt, q_wg, sK, kv_full, s + 1);

  // online softmax; every stage has a valid column, so the max is finite
  float mx0 = st.m0, mx1 = st.m1;
#pragma unroll
  for (int c = 0; c < BKS / 8; ++c) {
    mx0 = fmaxf(mx0, fmaxf(cur[4 * c], cur[4 * c + 1]));
    mx1 = fmaxf(mx1, fmaxf(cur[4 * c + 2], cur[4 * c + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float a0 = exp2f(st.m0 - mx0), a1 = exp2f(st.m1 - mx1);
  st.m0 = mx0;
  st.m1 = mx1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int c = 0; c < BKS / 8; ++c) {
    const float p00 = exp2f(cur[4 * c] - mx0), p01 = exp2f(cur[4 * c + 1] - mx0);
    const float p10 = exp2f(cur[4 * c + 2] - mx1), p11 = exp2f(cur[4 * c + 3] - mx1);
    sum0 += p00 + p01;
    sum1 += p10 + p11;
    pf[c / 2][(c % 2) * 2] = pack_bf16(p00, p01);
    pf[c / 2][(c % 2) * 2 + 1] = pack_bf16(p10, p11);
  }
  st.l0 = st.l0 * a0 + sum0;
  st.l1 = st.l1 * a1 + sum1;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    st.o[4 * c] *= a0;
    st.o[4 * c + 1] *= a0;
    st.o[4 * c + 2] *= a1;
    st.o[4 * c + 3] *= a1;
  }

  // O += P V, V MN-major: kv rows 16 kc..; then the next stage's logits and
  // this P V are awaited together
  const unsigned char* v_tile = sV + (s % STAGES) * KV_BYTES;
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < BKS / 16; ++kc) {
    Wgmma<D>::rs<1>(st.o, pf[kc], sw128_desc(v_tile + kc * 16 * ROW, KV_BYTES), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(nxt);
  reg_fence(st.o);
  release_slot(&kv_empty[s % STAGES], lane);
}

__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_overlap_wgmma(const __grid_constant__ OverlapTma p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align1024(smem_raw);      // [BQ rows]
  unsigned char* sK = sQ + Q_BYTES;             // [stage][BKS rows]
  unsigned char* sV = sK + STAGES * KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * KV_BYTES);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + STAGES;

  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    // producer: q~ once, then K and V of each stage through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW && lane == 0) {
      mbar_arrive_tx(q_full, Q_BYTES);
      tma_load_4d(sQ, &p.q, q_full, 0, q0, h, b);
      for (int s = 0; s < p.n_stages; ++s) {
        const int slot = s % STAGES;
        mbar_wait(&kv_empty[slot], ((s / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&kv_full[slot], 2 * KV_BYTES);
        tma_load_4d(sK + slot * KV_BYTES, &p.k, &kv_full[slot], 0, stage_k0(p, s), h, b);
        tma_load_4d(sV + slot * KV_BYTES, &p.v, &kv_full[slot], 0, stage_k0(p, s), h, b);
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
    Softmax st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] = 0.0f;
    st.m0 = st.m1 = -INFINITY;
    st.l0 = st.l1 = 0.0f;
    float sa[BKS / 2], sb[BKS / 2];  // the two logits accumulators, stages alternating
    uint32_t pf[BKS / 16][4];        // P in bf16 as the A fragments of P V
    mbar_wait(q_full, 0);

    issue_logits(sa, q_wg, sK, kv_full, 0);
    wgmma_wait<0>();
    reg_fence(sa);
    for (int s = 0; s < p.n_stages; s += 2) {
      overlap_stage(p, sa, sb, st, pf, q_wg, sK, sV, kv_full, kv_empty, s, qd, lane);
      if (s + 1 < p.n_stages) overlap_stage(p, sb, sa, st, pf, q_wg, sK, sV, kv_full, kv_empty, s + 1, qd, lane);
    }

    float l0 = st.l0, l1 = st.l1;
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
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)row * D + col) =
            pack_bf16(st.o[4 * c] * inv0, st.o[4 * c + 1] * inv0);
      }
      if (row + 8 < p.sq) {
        *reinterpret_cast<uint32_t*>(o_bh + (int64_t)(row + 8) * D + col) =
            pack_bf16(st.o[4 * c + 2] * inv1, st.o[4 * c + 3] * inv1);
      }
    }
  }
}

cudaError_t launch_overlap(const void* q, const void* k, const void* v, void* o, int64_t batch, int64_t heads,
                           int64_t sq, int64_t skv, int64_t d, int64_t n_chunks, int64_t q_sb, int64_t q_sh,
                           int64_t q_ss, int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                           int64_t v_ss, void* stream) {
  if (d != D || n_chunks < 1 || skv < 1 || skv % n_chunks != 0) return cudaErrorInvalidValue;
  OverlapTma p;
  if (!bf16_map(&p.q, q, batch, heads, sq, D, q_sb, q_sh, q_ss, BQ) ||
      !bf16_map(&p.k, k, batch, heads, skv, D, k_sb, k_sh, k_ss, BKS) ||
      !bf16_map(&p.v, v, batch, heads, skv, D, v_sb, v_sh, v_ss, BKS)) {
    return cudaErrorInvalidValue;
  }
  p.o = static_cast<bf16*>(o);
  p.heads = (int)heads;
  p.sq = (int)sq;
  p.chunk = (int)(skv / n_chunks);
  p.per_chunk = (p.chunk + BKS - 1) / BKS;
  p.n_stages = (int)n_chunks * p.per_chunk;
  static cudaError_t opted_in = allow_smem(flash_fwd_overlap_wgmma, SMEM);
  if (opted_in != cudaSuccess) return opted_in;
  dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(batch * heads));
  flash_fwd_overlap_wgmma<<<grid, NT_WS, SMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (pre-scaled), k, v: bf16 [B, H, S, 64] with unit stride on the head dim and
// the given element strides for batch, head and row (multiples of 8, 16-byte
// aligned base). Writes o [B, H, Sq, 64]. The kv row is processed as two
// halves; skv must be even.
int flash_fwd_split2(const void* q, const void* k, const void* v, void* o,
                     int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d,
                     int64_t q_sb, int64_t q_sh, int64_t q_ss,
                     int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss,
                     void* stream) {
  return launch_overlap(q, k, v, o, batch, heads, sq, skv, d, 2, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh,
                        v_ss, stream);
}

// The same for n_chunks equal chunks; skv must be a multiple of n_chunks.
int flash_fwd_chunked(const void* q, const void* k, const void* v, void* o,
                      int64_t batch, int64_t heads, int64_t sq, int64_t skv, int64_t d, int64_t n_chunks,
                      int64_t q_sb, int64_t q_sh, int64_t q_ss,
                      int64_t k_sb, int64_t k_sh, int64_t k_ss,
                      int64_t v_sb, int64_t v_sh, int64_t v_ss,
                      void* stream) {
  return launch_overlap(q, k, v, o, batch, heads, sq, skv, d, n_chunks, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb,
                        v_sh, v_ss, stream);
}

}  // extern "C"
