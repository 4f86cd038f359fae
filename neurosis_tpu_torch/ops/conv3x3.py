"""3×3 stride-1 SAME convolutions on NHWC tensors (port of neurosis_tpu/ops/conv3x3.py).

Two entry points of one kernel template (``csrc/conv3x3.cu``):
  - ``conv3x3_nhwc(x, w_k)``: implicit-GEMM conv, bf16 in, fp32 accumulate,
    bf16 out. Also the dgrad of both convs below, run on the spatially
    flipped, in/out-swapped filter (JAX ``_vjp_bwd``).
  - ``gn_silu_conv3x3_nhwc(x, a, b, w_k)``: the same kernel with a fused
    prologue, conv3x3(silu(round(x·a + b))) with per-(batch, channel) fp32
    affines (the folded GroupNorm), spatial padding zeroed after SiLU.

``w_k`` is the filter in the kernel's [3, 3, C, F] order; the public
autograd entries ``conv3x3`` and ``gn_silu_conv3x3`` take the torch OIHW
filter and reorder it. ``conv_tile`` picks each launch's tile (image rows,
columns and output channels of a block). Each wrapper runs its plain
PyTorch version for CPU tensors and launches its kernel for CUDA tensors. Weight gradients go to
``torch.nn.grad.conv2d_weight``, as the JAX package leaves wgrad to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _nvcc
from .._device import sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _nvcc.load("conv3x3")
    if not getattr(lib, "_argtypes_set", False):
        lib.conv3x3_bf16.argtypes = [_P] * 3 + [_I] * 8 + [_P]
        lib.gn_silu_conv3x3_bf16.argtypes = [_P] * 5 + [_I] * 8 + [_P]
        lib.conv3x3_bf16.restype = ctypes.c_int
        lib.gn_silu_conv3x3_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _check_cuda(x: torch.Tensor, w_k: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or w_k.dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel takes bf16, got {x.dtype} and {w_k.dtype}")
    if x.ndim != 4 or tuple(w_k.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3 kernel: bad shapes {tuple(x.shape)} and {tuple(w_k.shape)}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def conv3x3_plain(x: torch.Tensor, w_k: torch.Tensor) -> torch.Tensor:
    """The kernel's function in fp32, rounded to x's dtype."""
    y = F.conv2d(_nchw(x.float()), w_k.float().permute(3, 2, 0, 1), padding=1)
    return _nhwc(y).to(x.dtype).contiguous()


def silu_at_rounded(pre: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 SiLU at the out_dtype-rounded pre-activation, rounded again
    (JAX ``_silu_at_rounded``): the op order of the fused prologue."""
    act = pre.to(out_dtype).float()
    return (act * torch.sigmoid(act)).to(out_dtype)


def gn_silu_affine(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unfused normalize + activate on NHWC x with [B, C] affines."""
    pre = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return silu_at_rounded(pre, x.dtype)


def gn_silu_conv3x3_plain(x, a, b, w_k):
    return conv3x3_plain(gn_silu_affine(x, a, b), w_k)


# ---------------------------------------------------------------------------
# the tile
# ---------------------------------------------------------------------------

TILE_PIXELS = 128  # pixels of a block: two consumer warpgroups of 64
MAX_SMEM = 232448  # bytes of shared memory a block may have on the H100
FILTER_STAGES = {256: 4, 160: 5, 128: 6, 64: 10}  # the filter ring's stages at each block width


def conv_smem_bytes(tr: int, cw: int, bn: int) -> int:
    """Shared memory of one block, as the kernel lays it out: 1024 bytes of
    alignment slack, three halo stages of (tr+2)·(cw+2) 128-byte pixel rows
    (each rounded up to 1024 bytes; two where three do not fit), the filter
    ring (FILTER_STAGES[bn] stages of bn·128 bytes) and the mbarriers."""
    halo = -(-128 * (tr + 2) * (cw + 2) // 1024) * 1024
    stages = FILTER_STAGES[bn]
    rest = 1024 + stages * -(-bn // 64) * 8192 + 8 * (3 * 3 + 2 * stages)
    return rest + (3 if rest + 3 * halo <= MAX_SMEM else 2) * halo


def _pixel_tile(h: int, w: int) -> tuple[int, int]:
    """(tr, cw): the fewest tiles of at most 128 pixels over an h × w image,
    then the fewest halo pixels (tr+2)·(cw+2) a tile loads, the wider on a
    tie. Columns split evenly into tiles of cw (ragged W works); rows as many
    as fill 128 pixels, at most h, evened out over the image. Tiles narrower
    than 8 columns are tried only for narrower images: there the 8 pixels an
    ldmatrix reads at once span two tile rows, and their swizzled rows meet
    in the same shared-memory banks."""
    best = None
    for n_col in range(-(-w // TILE_PIXELS), w + 1):
        cw = -(-w // n_col)
        if best is not None and cw < 8:
            break
        tr = max(1, min(TILE_PIXELS // cw, h))
        tr = -(-h // -(-h // tr))
        key = (-(-h // tr) * -(-w // cw), (tr + 2) * (cw + 2))
        if best is None or key < best[0]:
            best = (key, tr, cw)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def conv_tile(b: int, h: int, w: int, f: int, sms: int, prologue: bool = False) -> tuple[int, int, int]:
    """(tr, cw, bn): a block computes tr image rows by cw columns by bn output
    channels; block (n, t) covers channels n·bn.. and, for t = (img, i, j),
    rows i·tr.. and columns j·cw.. of image img, the overhang masked.

    The pixel tile is ``_pixel_tile``'s (8×16 at 64×64 and 32×32: 180 halo
    pixels for 128, against 264 for 2×64). The width bn is 256, 160, 128 or
    64, one that divides f and fits shared memory, whichever costs least as
    waves of one block an SM on ``sms`` SMs times the time of a block, the
    wider on a tie. A block's time, fitted to the H100's device times at the
    SD, SDXL and VAE shapes: bn + 80 (the products, plus what a tap costs
    whatever bn is); with the GroupNorm prologue at least 1.8 per halo pixel
    (the prologue's share of the SM, the same at every bn, so fewer and wider
    blocks win there). At 2×32×32 and 1280 channels 160 gives 128 blocks, one
    wave; 128 gives 160, 1.2 waves."""
    tr, cw = _pixel_tile(h, w)
    tiles = b * -(-h // tr) * -(-w // cw)
    floor = 1.8 * (tr + 2) * (cw + 2) if prologue else 0.0
    cost = lambda bn: (-(-tiles * (f // bn) // sms) * max(bn + 80, floor), -bn)
    fits = [n for n in (256, 160, 128, 64) if f % n == 0 and conv_smem_bytes(tr, cw, n) <= MAX_SMEM]
    return tr, cw, min(fits, key=cost)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def conv3x3_nhwc(x: torch.Tensor, w_k: torch.Tensor) -> torch.Tensor:
    """3×3 SAME conv: x [B,H,W,C], w_k [3,3,C,F] → [B,H,W,F]."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w_k)
    _check_cuda(x, w_k)
    x, w_k = x.contiguous(), w_k.contiguous()
    bsz, h, wd, c = x.shape
    f = w_k.shape[3]
    out = torch.empty((bsz, h, wd, f), dtype=x.dtype, device=x.device)
    status = _lib().conv3x3_bf16(
        x.data_ptr(), w_k.data_ptr(), out.data_ptr(), bsz, h, wd, c, f,
        *conv_tile(bsz, h, wd, f, sm_count(x.device.index)), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _nvcc.check(status, "conv3x3_bf16")
    conv3x3_nhwc.launches += 1
    return out


conv3x3_nhwc.launches = 0


def gn_silu_conv3x3_nhwc(x, a, b, w_k):
    """conv3x3(silu(round(x·a + b))) with a, b fp32 [B, C]."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, a, b, w_k)
    _check_cuda(x, w_k)
    x, w_k = x.contiguous(), w_k.contiguous()
    a, b = a.float().contiguous(), b.float().contiguous()
    bsz, h, wd, c = x.shape
    f = w_k.shape[3]
    if tuple(a.shape) != (bsz, c) or tuple(b.shape) != (bsz, c):
        raise ValueError(f"affines must be [{bsz}, {c}], got {tuple(a.shape)} and {tuple(b.shape)}")
    out = torch.empty((bsz, h, wd, f), dtype=x.dtype, device=x.device)
    status = _lib().gn_silu_conv3x3_bf16(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), w_k.data_ptr(), out.data_ptr(),
        bsz, h, wd, c, f, *conv_tile(bsz, h, wd, f, sm_count(x.device.index), prologue=True),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _nvcc.check(status, "gn_silu_conv3x3_bf16")
    gn_silu_conv3x3_nhwc.launches += 1
    return out


gn_silu_conv3x3_nhwc.launches = 0


# ---------------------------------------------------------------------------
# gates and autograd entries
# ---------------------------------------------------------------------------


def conv3x3_supported(x_shape, w_shape, stride, padding, dtype) -> bool:
    """JAX's gate (ops/conv3x3.py:421-443) without its VMEM term: 3×3, stride
    1, pad 1, bf16, 128-multiple channels, 1024 ≤ H·W ≤ 4096."""
    if tuple(w_shape[:2]) != (3, 3) or stride != 1 or padding != 1:
        return False
    if dtype != torch.bfloat16:
        return False
    _b, h, width, c = x_shape
    feat = w_shape[3]
    if c < 128 or feat < 128 or not (1024 <= h * width <= 4096):
        return False
    return c % 128 == 0 and feat % 128 == 0


def gn_silu_conv3x3_supported(x_shape, w_shape, stride, padding, dtype) -> bool:
    return conv3x3_supported(x_shape, w_shape, stride, padding, dtype)


def _kernel_filter(w: torch.Tensor) -> torch.Tensor:
    """OIHW → the kernel's [3, 3, C, F]."""
    return w.permute(2, 3, 1, 0).contiguous()


def dgrad_uses_kernel(c_in: int, f_out: int) -> bool:
    """JAX's dgrad gate (ops/conv3x3.py:391): the conv kernel computes dx
    while its accumulator width c_in stays ≤ 1280 on 128-multiple channels."""
    return c_in <= 1280 and c_in % 128 == 0 and f_out % 128 == 0


def _dgrad(dy: torch.Tensor, w: torch.Tensor, c_in: int, conv=conv3x3_nhwc) -> torch.Tensor:
    """dx of a 3×3 SAME conv: ``conv`` (the kernel) on the flipped,
    in/out-swapped filter under the dgrad gate, the library's conv2d_input
    otherwise."""
    if dgrad_uses_kernel(c_in, w.shape[0]):
        w_flip = w.flip(2, 3).permute(2, 3, 0, 1).contiguous()  # [3, 3, F, C]
        return conv(dy, w_flip.to(dy.dtype))
    shape = (dy.shape[0], c_in, dy.shape[1], dy.shape[2])
    return _nhwc(torch.nn.grad.conv2d_input(shape, w.to(dy.dtype), _nchw(dy), padding=1))


def _wgrad(act: torch.Tensor, dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.nn.grad.conv2d_weight(_nchw(act), w.shape, _nchw(dy), padding=1).to(w.dtype)


def gn_silu_conv3x3_bwd(x, a, b, w, dy, conv=conv3x3_nhwc):
    """(dx, da, db, dw) of gn_silu_conv3x3 (JAX _gn_vjp_bwd): recompute the
    activation, dgrad through ``conv``, silu' at the same rounded point,
    direct partials for a and b, wgrad through the library."""
    pre = x.float() * a[:, None, None, :] + b[:, None, None, :]
    pre_r = pre.to(x.dtype).float()
    act = silu_at_rounded(pre, x.dtype)
    dact = _dgrad(dy, w, x.shape[-1], conv)
    sig = torch.sigmoid(pre_r)
    dpre = dact.float() * sig * (1.0 + pre_r * (1.0 - sig))
    dx = (dpre * a[:, None, None, :]).to(x.dtype)
    da = (dpre * x.float()).sum(dim=(1, 2))
    db = dpre.sum(dim=(1, 2))
    return dx, da.to(a.dtype), db.to(b.dtype), _wgrad(act, dy, w)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_nhwc(x, _kernel_filter(w))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = _dgrad(dy, w, x.shape[-1]).to(x.dtype)
        return dx, _wgrad(x, dy, w)


class _GnSiluConv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w):
        ctx.save_for_backward(x, a, b, w)
        return gn_silu_conv3x3_nhwc(x, a, b, _kernel_filter(w))

    @staticmethod
    def backward(ctx, dy):
        return gn_silu_conv3x3_bwd(*ctx.saved_tensors, dy)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 stride-1 SAME conv of NHWC x with an OIHW filter, differentiable."""
    return _Conv3x3.apply(x, w)


def gn_silu_conv3x3(x, a, b, w):
    """conv3x3(silu(round(x·a + b)), w) with [B, C] fp32 affines a, b (the
    folded GroupNorm); grads reach a, b, so the GroupNorm statistics chain
    composes outside, as in the JAX custom VJP."""
    return _GnSiluConv3x3.apply(x, a, b, w)
