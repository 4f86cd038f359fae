"""Flash attention over [B, H, S, D] (port of neurosis_tpu/ops/flash_attention.py).

``flash_attention(q, k, v)`` is softmax(q·kᵀ/√d)·v, non-causal, with the JAX
wrapper's contract: q is pre-scaled by scale·log2(e) and rounded to q's
dtype before the kernel (ops/flash_attention.py:1226), scale = 1/√d of the
true head dim, logits are base 2 and the per-row LSE (base 2) is the
backward residual together with the pre-scaled q (:1244).

Two kernels (``csrc/flash_attention.cu``) stand behind it:
``flash_fwd`` (replaces the four Pallas forward families) and ``flash_bwd``
(replaces the dq and dk/dv families). Each wrapper runs its plain PyTorch
version for CPU tensors and launches its kernel for CUDA tensors; the
kernels take bf16 and head dims 40, 64, 80 and 160, and raise otherwise.
``Di = rowsum(dO∘O)`` is a plain reduction outside the kernel, as in the JAX
backward (:1037).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _nvcc

LOG2_E = 1.4426950408889634
KERNEL_HEAD_DIMS = (40, 64, 80, 160)

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _nvcc.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_fwd_bf16.argtypes = [_P] * 5 + [_I] * 14 + [_P]
        lib.flash_bwd_bf16.argtypes = [_P] * 9 + [_I] * 17 + [_P]
        lib.flash_fwd_bf16.restype = ctypes.c_int
        lib.flash_bwd_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _kernel_view(t: torch.Tensor) -> torch.Tensor:
    """t itself when the kernel can read it in place (unit stride on D,
    16-byte aligned rows), else a contiguous copy."""
    ok = (
        t.stride(-1) == 1
        and all(s % 8 == 0 for s in t.stride()[:-1])
        and t.data_ptr() % 16 == 0
    )
    return t if ok else t.contiguous()


def _check_cuda_inputs(*ts: torch.Tensor) -> None:
    d = ts[0].shape[-1]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head dims {KERNEL_HEAD_DIMS}, got {d}")
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, got {t.dtype}")
        if t.device != ts[0].device:
            raise ValueError("flash kernel inputs must share one device")


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


def flash_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Forward kernel wrapper: qs [B,H,Sq,D] pre-scaled, k/v [B,H,Skv,D] →
    (o [B,H,Sq,D], lse [B,H,Sq] fp32)."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v)
    _check_cuda_inputs(qs, k, v)
    qs, k, v = (_kernel_view(t) for t in (qs, k, v))
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    status = _lib().flash_fwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v),
        torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, "flash_fwd_bf16")
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


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


def flash_bwd(qs, k, v, do, lse, di, scale: float):
    """Backward kernel wrapper: (dq, dk, dv) from the forward's residuals,
    the output cotangent ``do`` and Di = rowsum(dO∘O) [B,H,Sq] fp32."""
    if qs.device.type == "cpu":
        return flash_bwd_plain(qs, k, v, do, lse, di, scale)
    _check_cuda_inputs(qs, k, v, do)
    qs, k, v, do = (_kernel_view(t) for t in (qs, k, v, do))
    lse, di = lse.float().contiguous(), di.float().contiguous()
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    dq_acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=qs.device)
    dk = torch.empty((b, h, skv, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, h, skv, d), dtype=v.dtype, device=v.device)
    status = _lib().flash_bwd_bf16(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v), *_strides(do),
        torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, "flash_bwd_bf16")
    flash_bwd.launches += 1
    return (dq_acc * scale).to(qs.dtype), dk, dv


flash_bwd.launches = 0


# ---------------------------------------------------------------------------
# autograd entry
# ---------------------------------------------------------------------------


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])  # true head dim, before any padding
        qs = (q * (scale * LOG2_E)).to(q.dtype)
        o, lse = flash_fwd(qs, k, v)
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
