"""Flash attention over [B, H, S, D] (port of neurosis_tpu/ops/flash_attention.py).

``flash_attention(q, k, v)`` is softmax(q·kᵀ/√d)·v, non-causal, with the JAX
wrapper's contract: q is pre-scaled by scale·log2(e) and rounded to q's
dtype before the kernel (ops/flash_attention.py:1226), scale = 1/√d of the
true head dim, logits are base 2 and the per-row LSE (base 2) is the
backward residual together with the pre-scaled q (:1244).

Three kernels (``csrc/flash_attention.cu``) stand behind it:
``flash_fwd`` (replaces the four Pallas forward families) and ``flash_bwd``
(replaces the dq and dk/dv families) take bf16 at head dims 40, 64, 80, 160
and 512; ``flash_fwd_f32`` is the fp32 forward at head dim 512, for the
VAE's fp32 encode (the JAX kernel takes fp32 there, ops/flash_attention.py:1264).
``flash_fwd`` hands fp32 inputs to it. Each wrapper runs its plain PyTorch
version for CPU tensors and launches its kernel for CUDA tensors; a head dim
or dtype its kernel does not take raises, and so does the backward of an
fp32 forward on the card (no fp32 backward kernel yet). ``Di = rowsum(dO∘O)``
is a plain reduction outside the kernel, as in the JAX backward (:1037).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _nvcc

LOG2_E = 1.4426950408889634
KERNEL_HEAD_DIMS = (40, 64, 80, 160, 512)
F32_HEAD_DIMS = (512,)

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _nvcc.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_fwd_bf16.argtypes = [_P] * 5 + [_I] * 14 + [_P]
        lib.flash_bwd_bf16.argtypes = [_P] * 9 + [_I] * 17 + [_P]
        lib.flash_fwd_f32.argtypes = [_P] * 5 + [_I] * 14 + [_P]
        lib.flash_fwd_bf16.restype = ctypes.c_int
        lib.flash_bwd_bf16.restype = ctypes.c_int
        lib.flash_fwd_f32.restype = ctypes.c_int
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


def _check_cuda_inputs(*ts: torch.Tensor, dtype=torch.bfloat16, head_dims=KERNEL_HEAD_DIMS) -> None:
    d = ts[0].shape[-1]
    name = "bf16" if dtype == torch.bfloat16 else "fp32"
    if d not in head_dims:
        raise ValueError(f"flash {name} kernel takes head dims {head_dims}, got {d}")
    for t in ts:
        if t.dtype != dtype:
            raise TypeError(f"flash {name} kernel takes {name}, got {t.dtype}")
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


def _launch_fwd(entry: str, qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    qs, k, v = (_kernel_view(t) for t in (qs, k, v))
    b, h, sq, d = qs.shape
    skv = k.shape[2]
    o = torch.empty((b, h, sq, d), dtype=qs.dtype, device=qs.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=qs.device)
    status = getattr(_lib(), entry)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, sq, skv, d, *_strides(qs), *_strides(k), *_strides(v),
        torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, entry)
    return o, lse


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
    """The fp32 forward kernel (head dim 512, FFMA): as ``flash_fwd``, with
    o in fp32."""
    if qs.device.type == "cpu":
        return flash_fwd_plain(qs, k, v)
    _check_cuda_inputs(qs, k, v, dtype=torch.float32, head_dims=F32_HEAD_DIMS)
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
        di =(do.float() * o.float()).sum(dim=-1)
        return flash_bwd(qs, k, v, do, lse, di, ctx.scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v over [B, H, S, D] tensors, differentiable."""
    return _Flash.apply(q, k, v)
