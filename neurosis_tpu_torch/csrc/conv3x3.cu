// 3x3 stride-1 SAME convolution, NHWC bf16 in, fp32 accumulate, bf16 out,
// with an optional fused GroupNorm-affine + SiLU prologue (sm_90a).
//
// Replaces the Pallas TPU kernels of neurosis_tpu/ops/conv3x3.py:
//   conv3x3_wgmma<false, N> : _kernel (:42) via _conv_fwd (:109), also used as
//                             dgrad with the flipped, in/out-swapped filter
//                             (_vjp_bwd, :382-400)
//   conv3x3_wgmma<true, N>  : _kernel_gn (:179) via _gn_conv_fwd (:231):
//                             conv3x3(silu(round_bf16(x*a + b))) with per-(batch,
//                             channel) fp32 affines a, b (the folded GroupNorm)
//
// What bounds it on the H100: at the UNet's and the VAE's 32x32 and 64x64
// levels with 512-2560 channels the product is 2*9*C*F flops per pixel against
// 2*(C+F) bytes per pixel, far above the ~295 flops/byte ridge, so it is bound
// by the tensor cores. The design is an implicit GEMM (M = pixels, N = output
// channels, K = 9 taps x C), warp-specialised as the flash kernels are:
//   - a block owns up to 128 pixels, TR image rows by CW columns, by N = 256,
//     160, 128 or 64 output channels (the wrapper picks all three: 8 x 16
//     pixels at 64x64 and 32x32, whose halo is 180 pixels, not 2 x 64's 264;
//     N by waves on the card), and is two consumer warpgroups (64 pixels
//     each) and one producer warpgroup. Registers are split with setmaxnreg
//     (216 / 72): at N = 256 a consumer thread holds 128 accumulators;
//   - per 64-channel stage the halo tile, (TR+2) x (CW+2) pixels, arrives
//     once by TMA (a rank-4 map over x as (C, W, H, B), start (c0, w0-1,
//     h0-1, b), 128-byte swizzle: one halo pixel is one 128-byte row). TMA
//     fills coordinates outside the image, and channels past C, with zeros:
//     the SAME padding and the channel tail. Three halo stages where they fit
//     in shared memory, else two; one producer thread issues each as soon as
//     the consumers free its slot (with GN, one stage ahead of the prologue,
//     below);
//   - the nine taps are shifted windows of that tile. A window starting at an
//     arbitrary pixel row is no wgmma descriptor (its rows start mid-pattern),
//     so each consumer lane computes the address of its pixel row at the
//     tap's shift, with that row's swizzle XOR, and ldmatrix brings the A
//     fragments into registers; the product is wgmma with A from registers;
//   - B comes from a finer ring: one stage is one tap x 64 input channels x N
//     of the filter, TMA'd from a rank-3 map (F, C, tap) as MN-major
//     64-column boxes (rows past C read as zeros, not as the next tap's; N =
//     160 loads three boxes and multiplies 160 columns), 4, 5, 6 or 10 stages
//     at N = 256, 160, 128, 64. Filter slots are released one tap after their
//     product, so one tap's wgmma runs while the next tap's A fragments load
//     (two register buffers);
//   - each input element leaves device memory about once per output-channel
//     block; the grid walks output-channel blocks fastest, so the blocks that
//     share a halo run side by side and read it from L2.
// The GN prologue runs once per halo element, never once per tap: the
// producer's warps 1-3 (96 threads) wait for a landed halo stage, activate it in
// place (fp32 x*a + b, round to bf16, fp32 SiLU with __expf and a fast
// division, round to bf16), four halo pixels a thread at a time, leave the
// positions outside the image and the channel tail at TMA's zeros (silu(b)
// is not zero), fence the writes against the next TMA into the slot and
// arrive on the stage's "ready" barrier, which the consumers wait on. They
// run one stage ahead of the consumers, and issue the halo stage after next
// before they start a stage, so its TMA is in flight meanwhile. Every block
// activates its own halo, so the prologue's work grows with F / N and with
// the halo's overhang; on the H100 it also slows the products beside it on
// the SM (a fused launch takes 1.1-1.4x the plain conv's time), which is why
// the wrapper takes the widest N the waves allow for it.
// Epilogue: the fp32 accumulators become bf16 and go to device memory from
// registers, masked past H and W. Requires C % 32 == 0 and F % 64 == 0 (and F
// % N == 0); anything else, and a tile the kernel cannot take, is refused with
// cudaErrorInvalidValue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NCW = 8;                 // consumer warps: two warpgroups of 64 pixels
constexpr int NT = NCW * 32 + 128;     // and a producer warpgroup
constexpr int ACT_THREADS = 96;        // the producer's warps 1-3: the GN prologue
constexpr int ACT_ROWS = 4;            // halo pixels a prologue thread has in flight
constexpr int PRODUCER_REGS = 72;      // 2 x 128 x 216 + 128 x 72 = the 168 x 384 of the launch
constexpr int CONSUMER_REGS = 216;
constexpr int BM = 128;                // pixels a block
constexpr int ROW = 128;               // bytes of one halo pixel (64 channels) or filter row
constexpr int BOX = 64 * ROW;          // one 64 x 64 filter box
constexpr size_t MAX_SMEM = 232448;
constexpr int MAX_HS = 3;              // halo stages: three where they fit, else two

template <int BN>
struct Cfg {
  static constexpr int BOXES = (BN + 63) / 64;             // 64-column filter boxes (N = 160 loads 192)
  static constexpr int F_BYTES = BOXES * BOX;              // one filter stage: a tap x 64 channels x BN
  static constexpr int FS = BN == 256 ? 4 : BN == 160 ? 5 : BN == 128 ? 6 : 10;  // filter stages
};

struct ConvTma {
  CUtensorMap x;     // bf16 [B, H, W, C] as (C, W, H, B); box 64 x (CW+2) x (TR+2) x 1
  CUtensorMap filt;  // bf16 [3, 3, C, F] as (F, C, tap); box 64 x 64 x 1
  const float* ga;   // [B, C] (GN prologue only)
  const float* gb;   // [B, C]
  bf16* out;         // [B, H, W, F]
  int h, w, c, f;
  int tr, cw;        // image rows and columns per tile
  int row_tiles, col_tiles;
  int hs;            // halo stages
};

__host__ __device__ inline uint32_t halo_stage_bytes(int tr, int cw) {
  return ((uint32_t)ROW * (tr + 2) * (cw + 2) + 1023u) & ~1023u;
}

template <int BN>
size_t smem_bytes(int tr, int cw, int hs) {
  return 1024 + hs * (size_t)halo_stage_bytes(tr, cw) + (size_t)Cfg<BN>::FS * Cfg<BN>::F_BYTES +
         8 * (3 * MAX_HS + 2 * Cfg<BN>::FS);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// silu(round_bf16(x * a + b)) of two packed bf16, rounded to bf16
__device__ __forceinline__ uint32_t gn_silu_pair(uint32_t v, float a0, float a1, float b0, float b1) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&v);
  const float r0 = __bfloat162float(__float2bfloat16(__low2float(x) * a0 + b0));
  const float r1 = __bfloat162float(__float2bfloat16(__high2float(x) * a1 + b1));
  return pack_bf16(__fdividef(r0, 1.0f + __expf(-r0)), __fdividef(r1, 1.0f + __expf(-r1)));
}

// One 64-channel stage of a consumer warpgroup: nine taps of four k16 steps.
// A fragments alternate between two register buffers (P: the parity of the
// stage's first tap across the run, 9 taps being odd), so that one tap's
// ldmatrix runs while the previous tap's wgmma is in flight.
template <int BN, int P>
__device__ __forceinline__ void conv_stage(int& ft, float (&acc)[BN / 2], uint32_t (&af)[2][4][4],
                                           uint32_t halo, int prow, int hi, int w2, uint64_t* halo_bar,
                                           uint32_t halo_parity, uint64_t* halo_empty, unsigned char* s_filt,
                                           uint64_t* filt_full, uint64_t* filt_empty, int lane) {
  using C = Cfg<BN>;
  mbar_wait(halo_bar, halo_parity);
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int buf = (tap + P) & 1;
    const int hrow = prow + (tap / 3) * w2 + tap % 3;
    const uint32_t row_addr = halo + hrow * ROW;
    const int sw = hrow & 7;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(af[buf][kk], row_addr + (((2 * kk + hi) ^ sw) << 4));
    if (tap == 8) {  // the halo stage is read: hand it back to TMA
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(halo_empty);
    }
    const int s = ft % C::FS;
    mbar_wait(&filt_full[s], (ft / C::FS) & 1);
    const unsigned char* b_tile = s_filt + s * C::F_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      Wgmma<BN>::template rs<1>(acc, af[buf][kk], sw128_desc(b_tile + kk * 16 * ROW, BOX), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous tap's product is done: its A buffer and filter slot are free
    if (ft > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&filt_empty[(ft - 1) % C::FS]);
    }
    ++ft;
  }
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// the prologue on one 16-byte chunk: 8 channels of one halo pixel
__device__ __forceinline__ void gn_silu_chunk(uint4& v, float4 a0, float4 a1, float4 b0, float4 b1) {
  v.x = gn_silu_pair(v.x, a0.x, a0.y, b0.x, b0.y);
  v.y = gn_silu_pair(v.y, a0.z, a0.w, b0.z, b0.w);
  v.z = gn_silu_pair(v.z, a1.x, a1.y, b1.x, b1.y);
  v.w = gn_silu_pair(v.w, a1.z, a1.w, b1.z, b1.w);
}

template <bool GN, int BN>
__global__ void __launch_bounds__(NT, 1) conv3x3_wgmma(const __grid_constant__ ConvTma p) {
  using C = Cfg<BN>;
  extern __shared__ unsigned char smem_raw[];
  const int w2 = p.cw + 2;
  const int halo_rows = w2 * (p.tr + 2);
  const int hs = p.hs;                                          // halo stages, 2 or 3
  const uint32_t halo_stride = halo_stage_bytes(p.tr, p.cw);
  unsigned char* s_halo = align1024(smem_raw);                  // [hs][halo_stride]
  unsigned char* s_filt = s_halo + hs * halo_stride;            // [FS][BOXES]
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(s_filt + C::FS * C::F_BYTES);
  uint64_t* halo_ready = halo_full + MAX_HS;
  uint64_t* halo_empty = halo_ready + MAX_HS;
  uint64_t* filt_full = halo_empty + MAX_HS;
  uint64_t* filt_empty = filt_full + C::FS;

  const int n0 = blockIdx.x * BN;
  const int tiles_per_img = p.row_tiles * p.col_tiles;
  const int b = blockIdx.y / tiles_per_img;
  const int tile = blockIdx.y % tiles_per_img;
  const int h0 = (tile / p.col_tiles) * p.tr;
  const int w0 = (tile % p.col_tiles) * p.cw;
  const int n_cs = (p.c + 63) / 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < hs; ++s) {
      mbar_init(&halo_full[s], 1);
      mbar_init(&halo_ready[s], ACT_THREADS);
      mbar_init(&halo_empty[s], NCW);
    }
    for (int s = 0; s < C::FS; ++s) {
      mbar_init(&filt_full[s], 1);
      mbar_init(&filt_empty[s], NCW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= NCW) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == NCW) {
      // the filter taps stream through their ring
      if (lane == 0) {
        int ft = 0;
        for (int cs = 0; cs < n_cs; ++cs) {
          for (int tap = 0; tap < 9; ++tap, ++ft) {
            const int s = ft % C::FS;
            mbar_wait(&filt_empty[s], ((ft / C::FS) & 1) ^ 1);
            mbar_arrive_tx(&filt_full[s], C::F_BYTES);
#pragma unroll
            for (int j = 0; j < C::BOXES; ++j) {
              tma_load_3d(s_filt + s * C::F_BYTES + j * BOX, &p.filt, &filt_full[s], n0 + 64 * j, 64 * cs, tap);
            }
          }
        }
      }
      return;
    }
    // warps 1-3: thread t == 0 issues the halo stages, and with GN all 96
    // apply the prologue to each landed stage
    const int t = threadIdx.x - (NCW + 1) * 32;
    const uint32_t halo_bytes = (uint32_t)ROW * halo_rows;
    auto issue_halo = [&](int i) {
      const int s = i % hs;
      mbar_wait(&halo_empty[s], ((i / hs) & 1) ^ 1);
      mbar_arrive_tx(&halo_full[s], halo_bytes);
      tma_load_4d(s_halo + s * halo_stride, &p.x, &halo_full[s], 64 * i, w0 - 1, h0 - 1, b);
    };
    if (!GN) {  // as soon as the consumers free a slot
      if (t == 0) {
        for (int i = 0; i < n_cs; ++i) issue_halo(i);
      }
      return;
    }
    // The prologue runs one stage ahead of the consumers: stage cs is activated
    // while they multiply cs-1, and stage cs+hs-2 is issued first, into the
    // slot they left at the end of cs-2. Each thread keeps one 16-byte channel
    // chunk (lc; at lc ^ (row % 8) in the swizzled row) and walks every
    // twelfth halo pixel, ACT_ROWS at a time.
    const int lc = t % 8;
    constexpr int STEP = ACT_THREADS / 8;
    if (t == 0) {
      for (int i = 0; i < hs - 2 && i < n_cs; ++i) issue_halo(i);
    }
    for (int cs = 0; cs < n_cs; ++cs) {
      if (t == 0 && cs + hs - 2 < n_cs) issue_halo(cs + hs - 2);
      const int s = cs % hs;
      mbar_wait(&halo_full[s], (cs / hs) & 1);
      const int ch = 64 * cs + 8 * lc;
      if (ch < p.c) {
        const float4* ga = reinterpret_cast<const float4*>(p.ga + (int64_t)b * p.c + ch);
        const float4* gb = reinterpret_cast<const float4*>(p.gb + (int64_t)b * p.c + ch);
        const float4 a0 = ga[0], a1 = ga[1], b0 = gb[0], b1 = gb[1];
        const uint32_t halo = smem_u32(s_halo + s * halo_stride);
        int row = t / 8, hr = row / w2, hc = row % w2;
        while (row < halo_rows) {
          uint32_t addr[ACT_ROWS];
          bool in[ACT_ROWS];
          uint4 v[ACT_ROWS];
#pragma unroll
          for (int k = 0; k < ACT_ROWS; ++k) {  // the row's chunk, if the pixel is in the image
            const int ih = h0 - 1 + hr, iw = w0 - 1 + hc;
            in[k] = row < halo_rows && (unsigned)ih < (unsigned)p.h && (unsigned)iw < (unsigned)p.w;
            addr[k] = halo + row * ROW + ((lc ^ (row & 7)) << 4);
            row += STEP;
            for (hc += STEP; hc >= w2; hc -= w2) ++hr;
          }
#pragma unroll
          for (int k = 0; k < ACT_ROWS; ++k) v[k] = in[k] ? lds128(addr[k]) : make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int k = 0; k < ACT_ROWS; ++k) gn_silu_chunk(v[k], a0, a1, b0, b1);
#pragma unroll
          for (int k = 0; k < ACT_ROWS; ++k) {
            if (in[k]) sts128(addr[k], v[k]);
          }
        }
      }
      fence_proxy_async();  // these writes come before the next TMA into the slot
      mbar_arrive(&halo_ready[s]);
    }
    return;
  }

  // consumers: warpgroup wg owns pixels wg*64 .. +63 of the tile (pixel m is
  // tile row m / CW, column m % CW); this lane addresses fragment row lane % 16
  // of its warp for ldmatrix, and holds accumulator rows g and g + 8, columns
  // 8 c + 2 qd + {0, 1} (registers 4 c + {0, 1} and 4 c + {2, 3})
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int m_tile = p.tr * p.cw;
  const int m_ld = wg * 64 + (warp % 4) * 16 + (lane & 15);
  const int prow = m_ld < m_tile ? (m_ld / p.cw) * w2 + m_ld % p.cw : 0;  // rows past the tile read row 0
  const int hi = lane >> 4;
  const uint32_t halo0 = smem_u32(s_halo);
  uint64_t* halo_bar = GN ? halo_ready : halo_full;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t af[2][4][4];
  int ft = 0;
  int cs = 0;
  for (; cs + 1 < n_cs; cs += 2) {
    conv_stage<BN, 0>(ft, acc, af, halo0 + (cs % hs) * halo_stride, prow, hi, w2, &halo_bar[cs % hs],
                      (cs / hs) & 1, &halo_empty[cs % hs], s_filt, filt_full, filt_empty, lane);
    const int c1 = cs + 1;
    conv_stage<BN, 1>(ft, acc, af, halo0 + (c1 % hs) * halo_stride, prow, hi, w2, &halo_bar[c1 % hs],
                      (c1 / hs) & 1, &halo_empty[c1 % hs], s_filt, filt_full, filt_empty, lane);
  }
  if (cs < n_cs) {
    conv_stage<BN, 0>(ft, acc, af, halo0 + (cs % hs) * halo_stride, prow, hi, w2, &halo_bar[cs % hs],
                      (cs / hs) & 1, &halo_empty[cs % hs], s_filt, filt_full, filt_empty, lane);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  const int g = lane / 4, qd = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = wg * 64 + (warp % 4) * 16 + g + 8 * half;
    const int ih = h0 + m / p.cw, iw = w0 + m % p.cw;
    if (m >= m_tile || ih >= p.h || iw >= p.w) continue;
    bf16* o = p.out + (((int64_t)b * p.h + ih) * p.w + iw) * p.f + n0 + 2 * qd;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      *reinterpret_cast<uint32_t*>(o + 8 * c) = pack_bf16(acc[4 * c + 2 * half], acc[4 * c + 2 * half + 1]);
    }
  }
}

// ---- host ------------------------------------------------------------------

bool x_map(CUtensorMap* map, const void* x, int64_t batch, int h, int w, int c, int tr, int cw) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)w, (cuuint64_t)h, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)c * 2, (cuuint64_t)w * c * 2, (cuuint64_t)h * w * c * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)(cw + 2), (cuuint32_t)(tr + 2), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool filt_map(CUtensorMap* map, const void* filt, int c, int f) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)f, (cuuint64_t)c, 9};
  const cuuint64_t strides[2] = {(cuuint64_t)f * 2, (cuuint64_t)c * f * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(filt), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool GN, int BN>
int launch_bn(ConvTma& p, int64_t batch, const void* x, const void* filt, cudaStream_t stream) {
  p.hs = smem_bytes<BN>(p.tr, p.cw, MAX_HS) <= MAX_SMEM ? MAX_HS : 2;
  const size_t smem = smem_bytes<BN>(p.tr, p.cw, p.hs);
  if (p.f % BN != 0 || smem > MAX_SMEM || !x_map(&p.x, x, batch, p.h, p.w, p.c, p.tr, p.cw) ||
      !filt_map(&p.filt, filt, p.c, p.f)) {
    return (int)cudaErrorInvalidValue;
  }
  static cudaError_t opted_in =
      cudaFuncSetAttribute(conv3x3_wgmma<GN, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (opted_in != cudaSuccess) return (int)opted_in;
  dim3 grid((unsigned)(p.f / BN), (unsigned)(batch * p.row_tiles * p.col_tiles));
  conv3x3_wgmma<GN, BN><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool GN>
int launch(ConvTma& p, int64_t batch, const void* x, const void* filt, int64_t tr, int64_t cw, int64_t bn,
           void* stream) {
  if (batch < 1 || p.h < 1 || p.w < 1 || p.c < 32 || p.c % 32 != 0 || p.f < 64 || p.f % 64 != 0 || tr < 1 ||
      cw < 1 || tr * cw > BM || tr > p.h || cw > p.w || cw + 2 > 256 || tr + 2 > 256 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  p.tr = (int)tr;
  p.cw = (int)cw;
  p.row_tiles = (p.h + p.tr - 1) / p.tr;
  p.col_tiles = (p.w + p.cw - 1) / p.cw;
  if (batch * p.row_tiles * p.col_tiles > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch_bn<GN, 256>(p, batch, x, filt, s);
  if (bn == 160) return launch_bn<GN, 160>(p, batch, x, filt, s);
  if (bn == 128) return launch_bn<GN, 128>(p, batch, x, filt, s);
  if (bn == 64) return launch_bn<GN, 64>(p, batch, x, filt, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: bf16 [B, H, W, C], w: bf16 [3, 3, C, F], out: bf16 [B, H, W, F], all
// contiguous; the tile: tr image rows by cw columns (tr * cw <= 128) by bn
// (64 or 128) output channels.
int conv3x3_bf16(const void* x, const void* w, void* out, int64_t batch, int64_t h, int64_t width, int64_t c,
                 int64_t f, int64_t tr, int64_t cw, int64_t bn, void* stream) {
  ConvTma p = {};
  p.out = static_cast<bf16*>(out);
  p.h = (int)h; p.w = (int)width; p.c = (int)c; p.f = (int)f;
  return launch<false>(p, batch, x, w, tr, cw, bn, stream);
}

// As conv3x3_bf16 on silu(round_bf16(x * ga + gb)); ga, gb: fp32 [B, C].
int gn_silu_conv3x3_bf16(const void* x, const void* ga, const void* gb, const void* w, void* out, int64_t batch,
                         int64_t h, int64_t width, int64_t c, int64_t f, int64_t tr, int64_t cw, int64_t bn,
                         void* stream) {
  ConvTma p = {};
  p.ga = static_cast<const float*>(ga);
  p.gb = static_cast<const float*>(gb);
  p.out = static_cast<bf16*>(out);
  p.h = (int)h; p.w = (int)width; p.c = (int)c; p.f = (int)f;
  return launch<true>(p, batch, x, w, tr, cw, bn, stream);
}

}  // extern "C"
