// 3x3 stride-1 SAME convolution, NHWC bf16 in, fp32 accumulate, bf16 out,
// with an optional fused GroupNorm-affine + SiLU prologue (sm_90a).
//
// Replaces the Pallas TPU kernels of neurosis_tpu/ops/conv3x3.py:
//   conv3x3_kernel<false> : _kernel (:42) via _conv_fwd (:109), also used as
//                           dgrad with the flipped, in/out-swapped filter
//                           (_vjp_bwd, :382-400)
//   conv3x3_kernel<true>  : _kernel_gn (:179) via _gn_conv_fwd (:231):
//                           conv3x3(silu(round_bf16(x*a + b))) with per-(batch,
//                           channel) fp32 affines a, b (the folded GroupNorm)
//
// What bounds it on the H100: at the UNet's 32x32 and 64x64 levels with
// 640-1280 channels the product is 2*9*C*F flops per pixel against
// 2*(C+F) bytes per pixel, far above the ~295 flops/byte ridge, so it is
// operation-bound. The design is an implicit GEMM (M = pixels, N = output
// channels, K = 9 taps x C): a block owns a tile of TR image rows by CW
// columns (CW a multiple of 16, at most 128; TR*CW of 48-128 pixels) and 64
// output channels; for each 32-channel slice it stages the (TR+2) x (CW+2)
// halo tile in shared memory once and feeds all nine shifted windows
// straight from it to bf16 WMMA products, so every input element is read
// from device memory about once per output-channel block. A WMMA fragment is
// 16 pixels of one tile row; columns past W read zeros from the halo and are
// not stored, so any W works. The halo pixel stride is 48 bf16 (96 bytes)
// so every shifted window starts 32-byte aligned, as WMMA loads require.
// The GN prologue normalizes in fp32, rounds to bf16, applies SiLU in fp32
// and rounds again while filling the tile, and writes zeros at the spatial
// padding after the activation (silu(b) is not zero). Requires C % 32 == 0
// and F % 64 == 0; anything else is refused with cudaErrorInvalidValue.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int CB = 32;        // input channels per K step
constexpr int LDA = 48;       // bf16 stride of a halo-tile pixel (96 bytes)
constexpr int BN = 64;        // output channels per block
constexpr int LDB = BN + 8;   // bf16 row stride of the staged filter
constexpr int LDC = BN + 4;   // fp32 row stride of the epilogue staging
constexpr int MAX_M = 2;      // 16-pixel row fragments per warp (TR*CW <= 128)
constexpr int MAX_CW = 128;   // image columns per tile

struct ConvArgs {
  const bf16* x;     // [B, H, W, C]
  const bf16* filt;  // [3, 3, C, F]
  const float* ga;   // [B, C] (GN prologue only)
  const float* gb;   // [B, C]
  bf16* out;         // [B, H, W, F]
  int h, w, c, f;
  int tr, cw;        // image rows and columns per tile
  int row_tiles, col_tiles;
};

__device__ __forceinline__ bf16 gn_silu(bf16 v, float a, float b) {
  const float pre = __bfloat162float(v) * a + b;
  const float r = __bfloat162float(__float2bfloat16(pre));
  return __float2bfloat16(r / (1.0f + expf(-r)));
}

inline size_t smem_bytes(int tr, int cw) {
  const size_t halo = sizeof(bf16) * (size_t)(tr + 2) * (cw + 2) * LDA;
  const size_t filt = sizeof(bf16) * (size_t)9 * CB * LDB;
  const size_t stage = sizeof(float) * (size_t)tr * cw * LDC;
  const size_t main = ((halo + 127) / 128) * 128 + filt;
  return main > stage ? main : stage;
}

template <bool GN>
__global__ void __launch_bounds__(NTHREADS) conv3x3_kernel(ConvArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int W2 = a.cw + 2;
  const size_t halo_bytes = sizeof(bf16) * (size_t)(a.tr + 2) * W2 * LDA;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = reinterpret_cast<bf16*>(smem + ((halo_bytes + 127) / 128) * 128);
  float* sC = reinterpret_cast<float*>(smem);  // epilogue staging, reuses the tiles

  const int tiles_per_img = a.row_tiles * a.col_tiles;
  const int b = blockIdx.x / tiles_per_img;
  const int tile = blockIdx.x % tiles_per_img;
  const int h0 = (tile / a.col_tiles) * a.tr;
  const int w0 = (tile % a.col_tiles) * a.cw;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int bm = a.tr * a.cw;
  const int m_frags = bm / 16;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_M][BN / 16];
#pragma unroll
  for (int i = 0; i < MAX_M; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const bf16* xb = a.x + (int64_t)b * a.h * a.w * a.c;
  for (int c0 = 0; c0 < a.c; c0 += CB) {
    __syncthreads();  // the previous slice's readers are done
    // halo tile: rows h0-1 .. h0+tr, columns w0-1 .. w0+cw, channels c0 .. c0+CB
    const int halo_chunks = (a.tr + 2) * W2 * (CB / 8);
    for (int i = threadIdx.x; i < halo_chunks; i += NTHREADS) {
      const int pos = i / (CB / 8);
      const int c8 = (i % (CB / 8)) * 8;
      const int ih = h0 + pos / W2 - 1;
      const int iw = w0 + pos % W2 - 1;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (ih >= 0 && ih < a.h && iw >= 0 && iw < a.w) {
        v = *reinterpret_cast<const uint4*>(xb + ((int64_t)ih * a.w + iw) * a.c + c0 + c8);
        if (GN) {
          bf16* e = reinterpret_cast<bf16*>(&v);
          const float* ga = a.ga + (int64_t)b * a.c + c0 + c8;
          const float* gb = a.gb + (int64_t)b * a.c + c0 + c8;
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] = gn_silu(e[j], ga[j], gb[j]);
        }
      }
      *reinterpret_cast<uint4*>(sX + pos * LDA + c8) = v;
    }
    // filter slice: [9][CB][BN] of w[ky][kx][c0 + c][n0 + n]
    const int filt_chunks = 9 * CB * (BN / 8);
    for (int i = threadIdx.x; i < filt_chunks; i += NTHREADS) {
      const int row = i / (BN / 8);  // tap * CB + c
      const int n8 = (i % (BN / 8)) * 8;
      const int tap = row / CB, c = row % CB;
      *reinterpret_cast<uint4*>(sW + row * LDB + n8) = *reinterpret_cast<const uint4*>(
          a.filt + ((int64_t)tap * a.c + c0 + c) * a.f + n0 + n8);
    }
    __syncthreads();

    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CB; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[BN / 16];
#pragma unroll
        for (int j = 0; j < BN / 16; ++j)
          wmma::load_matrix_sync(fb[j], sW + (tap * CB + kk) * LDB + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < MAX_M; ++i) {
          const int mf = warp + i * NWARPS;
          if (mf < m_frags) {
            const int p0 = mf * 16;  // 16 pixels of one tile row
            const int r = p0 / a.cw, col = p0 % a.cw;
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
            wmma::load_matrix_sync(fa, sX + ((r + dy) * W2 + col + dx) * LDA + kk, LDA);
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) wmma::mma_sync(acc[i][j], fa, fb[j], acc[i][j]);
          }
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < MAX_M; ++i) {
    const int mf = warp + i * NWARPS;
    if (mf < m_frags) {
#pragma unroll
      for (int j = 0; j < BN / 16; ++j)
        wmma::store_matrix_sync(sC + mf * 16 * LDC + j * 16, acc[i][j], LDC, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < bm * (BN / 8); i += NTHREADS) {
    const int p = i / (BN / 8);
    const int n8 = (i % (BN / 8)) * 8;
    const int ih = h0 + p / a.cw;
    const int iw = w0 + p % a.cw;
    if (ih >= a.h || iw >= a.w) continue;
    __align__(16) bf16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j] = __float2bfloat16(sC[p * LDC + n8 + j]);
    *reinterpret_cast<uint4*>(a.out + (((int64_t)b * a.h + ih) * a.w + iw) * a.f + n0 + n8) =
        *reinterpret_cast<const uint4*>(o);
  }
}

template <bool GN>
int launch(ConvArgs a, int64_t batch, void* stream) {
  if (a.h < 1 || a.w < 1 || a.c % CB != 0 || a.f % BN != 0) return (int)cudaErrorInvalidValue;
  // columns: the row rounded up to 16, split evenly into tiles of at most MAX_CW
  const int wp = (a.w + 15) / 16 * 16;
  const int n_col = (wp + MAX_CW - 1) / MAX_CW;
  a.cw = ((wp + n_col - 1) / n_col + 15) / 16 * 16;
  a.col_tiles = (a.w + a.cw - 1) / a.cw;
  a.tr = a.cw >= 64 ? 1 : 64 / a.cw;
  a.row_tiles = (a.h + a.tr - 1) / a.tr;
  const size_t smem = smem_bytes(a.tr, a.cw);
  cudaError_t err =
      cudaFuncSetAttribute(conv3x3_kernel<GN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(batch * a.row_tiles * a.col_tiles), a.f / BN);
  conv3x3_kernel<GN><<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: bf16 [B, H, W, C], w: bf16 [3, 3, C, F], out: bf16 [B, H, W, F], all contiguous.
int conv3x3_bf16(const void* x, const void* w, void* out,
                 int64_t batch, int64_t h, int64_t width, int64_t c, int64_t f, void* stream) {
  ConvArgs a = {static_cast<const bf16*>(x), static_cast<const bf16*>(w), nullptr, nullptr,
                static_cast<bf16*>(out), (int)h, (int)width, (int)c, (int)f};
  return launch<false>(a, batch, stream);
}

// As conv3x3_bf16 on silu(round_bf16(x * ga + gb)); ga, gb: fp32 [B, C].
int gn_silu_conv3x3_bf16(const void* x, const void* ga, const void* gb, const void* w, void* out,
                         int64_t batch, int64_t h, int64_t width, int64_t c, int64_t f,
                         void* stream) {
  ConvArgs a = {static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                static_cast<const float*>(ga), static_cast<const float*>(gb),
                static_cast<bf16*>(out), (int)h, (int)width, (int)c, (int)f};
  return launch<true>(a, batch, stream);
}

}  // extern "C"
