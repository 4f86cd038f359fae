"""Flash attention over [B, H, S, D] (port of neurosis_tpu/ops/flash_attention.py).

``flash_attention(q, k, v)`` is softmax(q·kᵀ/√d)·v, non-causal, with the JAX
wrapper's contract: q is pre-scaled by scale·log2(e) and rounded to q's
dtype before the kernel (ops/flash_attention.py:1226), scale = 1/√d of the
true head dim, logits are base 2 and the per-row LSE (base 2) is the
backward residual together with the pre-scaled q (:1244).

Four wrappers over the kernels of ``csrc/flash_attention.cu`` stand behind it:
``flash_fwd`` (replaces the four Pallas forward families) and ``flash_bwd``
(replaces the dq and dk/dv families) take bf16 (TMA and wgmma kernels at head
dims 40, 64, 80, 160 and 512); ``flash_fwd_f32`` and ``flash_bwd_f32`` are the
fp32 forward and backward (three TF32 tensor-core products a product, fp32
accuracy; the backward as JAX's two passes, a dQ kernel and a dK/dV kernel), at
head dims 64, 96, 160, 512, for the VAE and the UNets that run in fp32 (the
JAX kernels take fp32 as they take bf16, ops/flash_attention.py:1221-1246). ``flash_fwd`` and ``flash_bwd`` hand fp32
inputs to them. As JAX pads D (:1257-1272), a head dim up to 512 that no
kernel is built for is zero-padded to the next one (``kernel_head_dim``),
after the pre-scaling, and the results are sliced back: zero columns add
nothing to q̃·kᵀ, to Di or to the LSE. Each wrapper runs its plain PyTorch
version for CPU tensors and launches its kernel for CUDA tensors; a dtype or
head dim no kernel takes (fp16, d > 512) raises. ``Di = rowsum(dO∘O)`` is a
plain reduction outside the kernel, as in the JAX backward (:1037).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _nvcc
from .._device import sm_count

LOG2_E = 1.4426950408889634
# the head dims each kernel family is built for; other head dims up to 512 are
# zero-padded to the next one
KERNEL_HEAD_DIMS = (40, 64, 80, 160, 512)
F32_HEAD_DIMS = (64, 96, 160, 512)
# the bf16 backward at d <= 160: kv rows a block owns, q rows of one ring stage
BWD_KV_ROWS = 128
BWD_Q_ROWS = 64
# the fp32 dK/dV kernel: kv rows a block owns (two blocks a kv tile at d = 512,
# one for each half of dK's and dV's columns); its q tiles are BWD_Q_ROWS
F32_BWD_KV_ROWS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _nvcc.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_fwd_bf16.argtypes = [_P] * 5 + [_I] * 14 + [_P]
        lib.flash_bwd_bf16.argtypes = [_P] * 9 + [_I] * 17 + [_P, _P, _I, ctypes.c_double, _P]
        lib.flash_fwd_f32.argtypes = [_P] * 5 + [_I] * 14 + [_P] * 4
        lib.flash_bwd_f32.argtypes = [_P] * 9 + [_I] * 17 + [_P, _I, ctypes.c_double, _P]
        for fn in (lib.flash_fwd_bf16, lib.flash_bwd_bf16, lib.flash_fwd_f32, lib.flash_bwd_f32):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in place (unit stride on D,
    16-byte aligned rows), else a contiguous copy."""
    per_16b = 16 // t.element_size()
    ok = (
        t.stride(-1) == 1
        and all(s % per_16b == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def kernel_head_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim a row of head dim ``d`` runs at in the kernel for ``dtype``:
    the next one that family is built for (bf16: 40, 64, 80, 160, 512; fp32:
    64, 96, 160, 512). fp16 and d > 512 raise: no config reaches either (the
    JAX package's ``apply_precision`` maps every 16-bit precision to bf16; the
    widest VAE mid block has 512 channels)."""
    dims = {torch.bfloat16: KERNEL_HEAD_DIMS, torch.float32: F32_HEAD_DIMS}.get(dtype)
    if dims is None:
        raise TypeError(f"the flash kernels take bf16 or fp32, got {dtype}")
    if not 1 <= d <= dims[-1]:
        raise ValueError(f"the flash kernels take head dims 1 to {dims[-1]}, got {d}")
    return next(dp for dp in dims if dp >= d)


def _check_cuda_inputs(*ts: torch.Tensor, dtype=torch.bfloat16, head_dims=None) -> None:
    """Every input in ``dtype`` on one device, and, given ``head_dims``, a head
    dim among them (kernels that are not padded)."""
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"flash {name} kernel takes {name}, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError("flash kernel inputs must share one device")
    d = ts[0].shape[-1]
    if head_dims is not None and d not in head_dims:
        raise ValueError(f"flash {name} kernel takes head dims {head_dims}, got {d}")


def _pad_head(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t with its last dim zero-padded to ``dp`` (t itself when it is already)."""
    return t if t.shape[-1] == dp else F.pad(t, (0, dp - t.shape[-1]))


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    return t.stride(0), t.stride(1), t.stride(2)


# ---------------------------------------------------------------------------
# forward kernel
# ---------------------------------------------------------------------------


def flash_fwd_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Plain version of the forward kernel: (o, lse) from pre-scaled q,
    fp32 math, o rounded to q's dtype, lse = log2(Σ 2^s) in fp32."""
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p / l, v.float()).to(qs.dtype)
    return o, (m + torch.log2(l)).squeeze(-1)


def _launch_fwd(entry: str, qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The forward kernel at the row's kernel head dim: q̃, k, v zero-padded to
    it, o sliced back to the true one."""
    d_true = qs.shape[-1]
    dp = kernel_head_dim(d_true, qs.dtype)
    qs, k, v = (_kernel_view(_pad_head(t, dp)) for t in (qs, k, v))
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    scratch = []
    if entry == "flash_fwd_f32":  # the tf32 hi and lo parts of q̃, k and vᵀ, written by the kernel's split passes
        # vᵀ's rows hold Skv rounded up to 4 keys, 16-byte aligned for TMA
        n_q, n_k, n_vt = (2 * b * h * n * d for n in (sq, skv, -(-skv // 4) * 4))
        buf = torch.empty(n_q + n_k + n_vt, dtype=torch.float32, device=qs.device)
        scratch = [buf.data_ptr(), buf[n_q:].data_ptr(), buf[n_q + n_k:].data_ptr()]
    status = getattr(_lib(), entry)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v),
        *scratch, torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, entry)
    return o[..., :d_true], lse


def flash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Forward kernel wrapper: qs [B,H,Sq,D] pre-scaled, k/v [B,H,Skv,D] →
    (o [B,H,Sq,D], lse [B,H,Sq] fp32). fp32 inputs go to ``flash_fwd_f32``."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v)
    if qs.dtype == torch.float32:
        return flash_fwd_f32(qs, k, v)
    _check_cuda_inputs(qs, k, v)
    out = _launch_fwd("flash_fwd_bf16", qs, k, v)
    flash_fwd.launches += 1
    return out


flash_fwd.launches = 0


def flash_fwd_f32(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The fp32 forward kernel (split-TF32 wgmma, fp32 accuracy): as
    ``flash_fwd``, with o in fp32."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v)
    _check_cuda_inputs(qs, k, v, dtype=torch.float32)
    out = _launch_fwd("flash_fwd_f32", qs, k, v)
    flash_fwd_f32.launches += 1
    return out


flash_fwd_f32.launches = 0


# ---------------------------------------------------------------------------
# backward kernel
# ---------------------------------------------------------------------------


def flash_bwd_plain(qs, k, v, do, lse, di, scale: float):
    """Plain version of the backward kernel: P from the saved base-2 LSE,
    dS = P∘(dO·vᵀ − Di), dq = dS·k·scale, dk = dSᵀ·q̃/log2(e), dv = Pᵀ·dO."""
    p = torch.exp2(torch.matmul(qs.float(), k.float().transpose(-1, -2)) - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - di[..., None])
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qs.float()) * (1.0 / LOG2_E)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    return dq.to(qs.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _cheapest_split(blocks: int, q_tiles: int, sms: int, fewest: int) -> int:
    """One when the kv blocks alone fill the card or q is one tile; otherwise
    the count from ``fewest`` up that costs the fewest waves x (q tiles a block
    walks + 1, for loading its kv rows and writing dK, dV), the smaller on a tie."""
    if blocks >= sms or q_tiles == 1:
        return 1
    cost = lambda n: -(-blocks * n // sms) * (-(-q_tiles // n) + 1)
    return min(range(fewest, q_tiles + 1), key=lambda n: (cost(n), n))


def bwd_q_splits(b: int, h: int, sq: int, skv: int, sms: int) -> int:
    """Blocks that share one kv tile's walk over q in the bf16 backward (d <= 160):
    from the count that puts a block on every SM (kv = 77 gives one kv tile per
    head). The tiles are the same at every head dim."""
    blocks = -(-skv // BWD_KV_ROWS) * b * h
    q_tiles = -(-sq // BWD_Q_ROWS)
    return _cheapest_split(blocks, q_tiles, sms, min(q_tiles, -(-sms // blocks)))


def bwd_f32_q_splits(b: int, h: int, sq: int, skv: int, d: int, sms: int) -> int:
    """Blocks that share one kv tile's walk over q in the fp32 dK/dV kernel (d
    the kernel head dim), from one: the q range stays whole wherever the kv
    tiles alone nearly fill the card (1x8x1024x1024 gives 128 blocks on 132
    SMs), and every grad is then written once, the same bits from call to call."""
    blocks = -(-skv // F32_BWD_KV_ROWS) * b * h * (2 if d == 512 else 1)
    return _cheapest_split(blocks, -(-sq // BWD_Q_ROWS), sms, 1)


def bwd_q_ranges(sq: int, splits: int) -> list[tuple[int, int]]:
    """The q rows [start, stop) each of ``splits`` blocks walks, as the kernel
    cuts them: q tile t of ceil(Sq/64) goes to block z with
    z·tiles/splits <= t < (z+1)·tiles/splits (integer division)."""
    q_tiles = -(-sq // BWD_Q_ROWS)
    return [(z * q_tiles // splits * BWD_Q_ROWS, min((z + 1) * q_tiles // splits * BWD_Q_ROWS, sq))
            for z in range(splits)]


def _launch_bwd(qs, k, v, do, lse, di, scale: float):
    """The bf16 backward kernel at the row's kernel head dim: q̃, k, v, dO
    zero-padded to it (LSE and Di are unchanged by zero columns), the grads
    sliced back to the true one; ``scale`` is the true head dim's."""
    d_true = qs.shape[-1]
    dp = kernel_head_dim(d_true, qs.dtype)
    qs, k, v, do = (_kernel_view(_pad_head(t, dp)) for t in (qs, k, v, do))
    lse, di = lse.float().contiguous(), di.float().contiguous()
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    lib = _lib()
    n_q, n_kv = b * h * sq * d, b * h * skv * d
    # d <= 160: one zeroed fp32 buffer for what the kernel sums with atomics, dq
    # (scaled) and, where the q range is split, dk and dv; one cast to the
    # grads' dtype at the end. d = 512 (a dQ and a dK/dV kernel, JAX's two
    # passes): every grad written once in bf16, dq scaled.
    splits = 1 if d == 512 else bwd_q_splits(b, h, sq, skv, sm_count(qs.device.index))
    acc = None
    if d != 512:
        acc = torch.zeros(n_q + (2 * n_kv if splits > 1 else 0), dtype=torch.float32, device=qs.device)
    dq = torch.empty((b, h, sq, d), dtype=qs.dtype, device=qs.device) if acc is None else acc
    dk = dv = None  # written in bf16 by the kernel unless split
    if splits == 1:
        dk, dv = (torch.empty((b, h, skv, d), dtype=k.dtype, device=k.device) for _ in range(2))
    ptrs = [acc[n_q:].data_ptr(), acc[n_q + n_kv:].data_ptr()] if splits > 1 else [None, None]
    status = lib.flash_bwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), dk.data_ptr() if dk is not None else None, dv.data_ptr() if dv is not None else None,
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v), *_strides(do),
        *ptrs, splits, scale, torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, "flash_bwd_bf16")
    if acc is not None:
        out = acc.to(qs.dtype)
        dq = out[:n_q].view(b, h, sq, d)
        if splits > 1:
            dk, dv = out[n_q:n_q + n_kv].view(b, h, skv, d), out[n_q + n_kv:].view(b, h, skv, d)
    return tuple(g[..., :d_true] for g in (dq, dk, dv))


def _launch_bwd_f32(qs, k, v, do, lse, di, scale: float):
    """The fp32 backward kernels at the row's kernel head dim, padded and
    sliced as ``_launch_bwd``. The kernels write dq (scaled), dk and dv in
    place; dk and dv are zeroed and summed into when the q range is split."""
    d_true = qs.shape[-1]
    dp = kernel_head_dim(d_true, qs.dtype)
    qs, k, v, do = (_kernel_view(_pad_head(t, dp)) for t in (qs, k, v, do))
    lse, di = lse.float().contiguous(), di.float().contiguous()
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    lib = _lib()
    splits = bwd_f32_q_splits(b, h, sq, skv, d, sm_count(qs.device.index))
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=qs.device)
    new = torch.zeros if splits > 1 else torch.empty
    dk, dv = (new((b, h, skv, d), dtype=torch.float32, device=qs.device) for _ in range(2))
    # the tf32 hi and lo parts of q̃, k, v, dO by rows and of kᵀ, q̃ᵀ, dOᵀ,
    # written by the kernels' split passes; transposed rows hold S rounded up to 4
    r4 = lambda n: -(-n // 4) * 4
    scratch = torch.empty(2 * b * h * d * (2 * sq + 2 * skv + r4(skv) + 2 * r4(sq)), dtype=torch.float32,
                          device=qs.device)
    status = lib.flash_bwd_f32(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v), *_strides(do),
        scratch.data_ptr(), splits, scale, torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, "flash_bwd_f32")
    return tuple(g[..., :d_true] for g in (dq, dk, dv))


def flash_bwd(qs, k, v, do, lse, di, scale: float):
    """Backward kernel wrapper: (dq, dk, dv) from the forward's residuals,
    the output cotangent ``do`` and Di = rowsum(dO∘O) [B,H,Sq] fp32. fp32
    inputs go to ``flash_bwd_f32``. At head dim 512 two kernels run (dQ, then
    dK and dV) and write every grad once, so two calls give the same bits."""
    if qs.device.type == "cpu":
        return flash_bwd_plain(qs, k, v, do, lse, di, scale)
    if qs.dtype == torch.float32:
        return flash_bwd_f32(qs, k, v, do, lse, di, scale)
    _check_cuda_inputs(qs, k, v, do)
    out = _launch_bwd(qs, k, v, do, lse, di, scale)
    flash_bwd.launches += 1
    return out


flash_bwd.launches = 0


def flash_bwd_f32(qs, k, v, do, lse, di, scale: float):
    """The fp32 backward kernels (split-TF32 wgmma: a dQ kernel and a dK/dV
    kernel, JAX's two passes): as ``flash_bwd``, with fp32 grads. Every grad
    is written once, so two calls give the same bits, except where the q range
    is split (``bwd_f32_q_splits``) and dk, dv are summed by fp32 atomics."""
    if qs.device.type == "cpu":
        return flash_bwd_plain(qs, k, v, do, lse, di, scale)
    _check_cuda_inputs(qs, k, v, do, dtype=torch.float32)
    out = _launch_bwd_f32(qs, k, v, do, lse, di, scale)
    flash_bwd_f32.launches += 1
    return out


flash_bwd_f32.launches = 0


# ---------------------------------------------------------------------------
# the dispatcher op and the autograd entry
# ---------------------------------------------------------------------------

# The forward is a dispatcher op (``torch.ops.neurosis.flash_fwd``), so a
# selective-checkpoint policy can name its outputs and keep them: a launch
# through ctypes alone is invisible to it, and the recompute would run the
# kernel again (modules/attention.py's ``names`` remat policies). The op runs
# its wrapper on CPU and CUDA tensors. The Meta dispatch key takes the fake
# version, which gives shapes alone under tracing and, on meta tensors, runs
# the wrapper too, so the package tests' meta walk reaches the (stubbed)
# launch. The backward runs outside the checkpoint's forward and calls its
# wrapper directly.


@torch.library.custom_op("neurosis::flash_fwd", mutates_args=(), device_types=("cpu", "cuda"))
def flash_fwd_op(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_fwd(qs, k, v)


@flash_fwd_op.register_fake
def _(qs, k, v):
    if qs.device.type == "meta":
        return flash_fwd(qs, k, v)
    return torch.empty_like(qs), qs.new_empty(qs.shape[:-1], dtype=torch.float32)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])  # the true head dim: the wrappers pad after this
        qs = (q * (scale * LOG2_E)).to(q.dtype)
        o, lse = flash_fwd_op(qs, k, v)
        ctx.save_for_backward(qs, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        di = (do.float() * o.float()).sum(dim=-1)
        return flash_bwd(qs, k, v, do, lse, di, ctx.scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over [B, H, S, D] tensors, differentiable."""
    return _Flash.apply(q, k, v)
