"""Flash forward with the next chunk's logits formed ahead of this chunk's
softmax (port of the two Pallas kernels of tools/overlap_bench.py).

``flash_fwd_split2(qs, k, v)`` and ``flash_fwd_chunked(qs, k, v, n_chunks)``
take q pre-scaled by scale·log2(e) (tools/overlap_bench.py:104,130) and return
softmax(q·kᵀ/√d)·v, the kv row cut into 2 or ``n_chunks`` equal chunks with
the online rescale carried from chunk to chunk (:45-63, :74-97). The TPU
kernels also write a natural-log LSE that their callers drop (:110,136); these
return the output only. bf16, head dim 64, as the tool runs them; a kv
length that is no multiple of the chunk count raises (the TPU kernels assume
it, :41,72).

Kernels: ``csrc/flash_overlap.cu``. CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _nvcc
from .flash_attention import _check_cuda_inputs, _kernel_view, _strides

OVERLAP_HEAD_DIMS = (64,)

_P = ctypes.c_void_p
_I = ctypes.c_int64


def _lib():
    lib = _nvcc.load("flash_overlap")
    if not getattr(lib, "_argtypes_set", False):
        lib.flash_fwd_split2.argtypes = [_P] * 4 + [_I] * 14 + [_P]
        lib.flash_fwd_chunked.argtypes = [_P] * 4 + [_I] * 15 + [_P]
        lib.flash_fwd_split2.restype = ctypes.c_int
        lib.flash_fwd_chunked.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check_chunks(k: torch.Tensor, n_chunks: int) -> None:
    if n_chunks < 1 or k.shape[2] % n_chunks:
        raise ValueError(f"kv length {k.shape[2]} is no multiple of {n_chunks} chunks")


def flash_fwd_chunked_plain(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """Plain version of both kernels: the chunk loop of ``_chunked_kernel``
    (tools/overlap_bench.py:74-95) in fp32, P rounded to v's dtype before
    P·V, the output rounded to q's dtype."""
    _check_chunks(k, n_chunks)
    m = l = o = None
    for kc, vc in zip(k.chunk(n_chunks, dim=2), v.chunk(n_chunks, dim=2)):
        st = torch.matmul(qs.float(), kc.float().transpose(-1, -2))
        m_i = st.amax(dim=-1, keepdim=True)
        m_new = m_i if m is None else torch.maximum(m, m_i)
        p = torch.exp2(st - m_new)
        l_i = p.sum(dim=-1, keepdim=True)
        o_i = torch.matmul(p.to(v.dtype).float(), vc.float())
        if m is None:
            l, o = l_i, o_i
        else:
            alpha = torch.exp2(m - m_new)
            l, o = l * alpha + l_i, o * alpha + o_i
        m = m_new
    return (o / l).to(qs.dtype)


def _launch(entry: str, qs, k, v, *chunks: int) -> torch.Tensor:
    _check_cuda_inputs(qs, k, v, head_dims=OVERLAP_HEAD_DIMS)
    qs, k, v = (_kernel_view(t) for t in (qs, k, v))
    b, h, sq, d = qs.shape
    o = torch.empty((b, h, sq, d), dtype=qs.dtype, device=qs.device)
    status = getattr(_lib(), entry)(
        qs.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        b, h, sq, k.shape[2], d, *chunks, *_strides(qs), *_strides(k), *_strides(v),
        torch.cuda.current_stream(qs.device).cuda_stream,
    )
    _nvcc.check(status, entry)
    return o


def flash_fwd_split2(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The kv row as two halves: qs [B,H,Sq,64] pre-scaled, k/v [B,H,Skv,64] → o."""
    _check_chunks(k, 2)
    if qs.device.type == "cpu":
        return flash_fwd_chunked_plain(qs, k, v, 2)
    out = _launch("flash_fwd_split2", qs, k, v)
    flash_fwd_split2.launches += 1
    return out


flash_fwd_split2.launches = 0


def flash_fwd_chunked(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The kv row as ``n_chunks`` equal chunks."""
    _check_chunks(k, n_chunks)
    if qs.device.type == "cpu":
        return flash_fwd_chunked_plain(qs, k, v, n_chunks)
    out = _launch("flash_fwd_chunked", qs, k, v, n_chunks)
    flash_fwd_chunked.launches += 1
    return out


flash_fwd_chunked.launches = 0
