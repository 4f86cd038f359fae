"""The port's CUDA kernels against their plain versions on the card, at small
shapes that reach every code path of each kernel: ragged q tails, q shorter
than a block, the masked kv=77 tail and other kv tails, a backward whose q
range is split over blocks, each head dim the kernel takes (512 with ragged q
and kv tails, in bf16 and in fp32) and head dims padded to them, overlap
chunks that end inside a stage, channel counts
that take one and several tiles,
the GroupNorm prologue's zeroed halo.

These need a CUDA card (a CUDA kernel has no interpreter) and skip without
one. On the card, where JAX is absent (tests/conftest.py imports it):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Tolerances are on max|kernel - plain| / max|plain|, bf16 inputs on both
sides: 2e-2 for outputs (the kernels round P, dS or the activation to bf16
where the plain versions keep fp32), 5e-2 for attention grads. The fp32
flash forward keeps fp32 accuracy: each product is three TF32 tensor-core
products of split operands (hi.hi + hi.lo + lo.hi, each part a tf32), whose
dropped terms are about 2^-22 relative, fp32's own rounding: 2e-5 on O and on
the LSE, as for fp32 sums in another order; the fp32 backward forms its
products the same way in two kernels (dQ; dK and dV), over chains of up to
4096 keys or queries, and sums dK, dV by atomics where the q range is split:
1e-4. The
split2 and chunked forwards round P to bf16 as their plain version does, so
only the output's bf16 rounding and the order of fp32 sums differ: 1e-2.
"""

import math

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator("cuda").manual_seed(0)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


# (B, H, Sq, Skv, D) reaching every path of the bf16 kernels at d = 40, 64, 80,
# 160: a ragged q tail (Sq = 300, 100, 130), Sq shorter than a forward block or
# a backward stage (20, 50), the kv=77 tail and kv tails of 200 and 300 rows,
# several kv tiles, a backward whose q range is split over blocks (kv = 77 with
# few heads; SPLIT, and most small shapes on 132 SMs), one full-size SDXL
# self-attention (one block per kv tile), and d = 512 (the VAE-GAN pair's
# 8x1x1024x1024 among them; for the dQ and the dK/dV kernel at 512, Sq shorter
# than a 64-row block (40), ragged Sq tails (100, 130, 200), the kv = 77 tail
# and Skv that is no multiple of 64 (130, 300)); head dims padded to the next
# kernel head dim: 32 -> 40, 128 -> 160, 256 -> 512
SPLIT = [(2, 3, 300, 77, 40), (2, 5, 1024, 77, 64), (1, 2, 1024, 77, 80), (1, 2, 512, 77, 160)]
FLASH_SHAPES = SPLIT + [(1, 2, 256, 300, 40), (1, 2, 130, 200, 64), (1, 2, 20, 130, 64), (1, 2, 256, 256, 80),
                        (1, 2, 100, 300, 80), (1, 1, 64, 77, 160), (2, 1, 300, 256, 160), (1, 1, 50, 200, 160),
                        (2, 20, 1024, 1024, 64), (2, 1, 200, 300, 512), (1, 1, 1024, 1024, 512),
                        (8, 1, 1024, 1024, 512), (1, 2, 300, 77, 32), (1, 2, 130, 200, 128), (1, 1, 200, 300, 256),
                        (1, 1, 40, 77, 512), (1, 2, 130, 77, 512), (1, 1, 100, 130, 512), (1, 1, 40, 300, 512)]


@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_kernels(cuda, shape):
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    if shape in SPLIT:
        assert fa.bwd_q_splits(b, h, sq, skv, torch.cuda.get_device_properties(0).multi_processor_count) > 1
    q, do = (torch.randn(b, h, sq, d, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qs = (q * (scale * fa.LOG2_E)).to(q.dtype)
    n_fwd, n_bwd = fa.flash_fwd.launches, fa.flash_bwd.launches
    o, lse = fa.flash_fwd(qs, k, v)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
    assert _rel(o, o_ref) < 2e-2
    assert float((lse - lse_ref).abs().max()) < 1e-3
    di = (do.float() * o_ref.float()).sum(-1)
    for got, want in zip(fa.flash_bwd(qs, k, v, do, lse_ref, di, scale),
                         fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale)):
        assert _rel(got, want) < 5e-2
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    assert o.shape == q.shape


# (B, H, Sq, Skv, D) reaching every path of the fp32 forward at each kernel head
# dim: blocks of 128 query rows at 64, 96 (d = 80 padded), 160 and of 64 at 512;
# ragged q tails (300, 100, 130), Sq shorter than a block (20, 50), the kv = 77
# tail and kv tails of 130, 200, 300 keys (tiles of 64), kv shorter than a
# tile, and at 512 tails that leave the second warpgroup's 32 keys of the last
# tile all masked (77 = 64 + 13, 33, 5); the VAE-GAN pair's 2x1x1024x1024x512
F32_FWD_SHAPES = [(2, 1, 100, 130, 512), (1, 1, 1024, 1024, 512), (2, 1, 1024, 1024, 512), (1, 1, 20, 77, 512),
                  (1, 2, 130, 33, 512), (1, 1, 64, 5, 512), (1, 2, 300, 77, 64), (1, 2, 20, 130, 64),
                  (2, 3, 130, 300, 64), (1, 2, 300, 200, 96), (1, 1, 50, 77, 80), (1, 2, 130, 77, 160),
                  (1, 1, 20, 300, 160), (2, 1, 300, 64, 160)]


@pytest.mark.parametrize("shape", F32_FWD_SHAPES)
def test_flash_fwd_f32_kernel(cuda, shape):
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    q = torch.randn(b, h, sq, d, generator=cuda, device="cuda")
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda") for _ in range(2))
    qs = q * (fa.LOG2_E / math.sqrt(d))
    n = fa.flash_fwd_f32.launches
    o, lse = fa.flash_fwd(qs, k, v)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
    torch.cuda.synchronize()
    assert o.dtype == torch.float32 and fa.flash_fwd_f32.launches == n + 1
    assert _rel(o, o_ref) < 2e-5
    assert float((lse - lse_ref).abs().max()) < 2e-5


# (B, H, Sq, Skv, D) reaching every path of the fp32 backward kernels: Sq and
# Skv that are not multiples of 64 (ragged q and kv tiles of both kernels), the
# kv = 77 tail with the q range split over blocks (F32_BWD_SPLIT, and most small
# shapes on 132 SMs), the q range whole where the kv tiles fill the card
# (F32_BWD_WHOLE, with one q tile), the halves of dK and dV at 512, and d = 40,
# 80, 200 padded to 64, 96, 512
F32_BWD_SPLIT = [(1, 2, 300, 77, 64), (1, 8, 1024, 77, 40), (1, 1, 200, 77, 512), (1, 2, 130, 77, 160)]
F32_BWD_WHOLE = [(2, 4, 1000, 1000, 64), (8, 1, 1000, 1000, 512), (1, 1, 20, 130, 160)]
F32_BWD_SHAPES = F32_BWD_SPLIT + F32_BWD_WHOLE + [(2, 1, 100, 130, 512), (1, 1, 1024, 1024, 512),
                                                  (2, 3, 130, 200, 64), (1, 2, 100, 300, 96), (1, 2, 200, 150, 40),
                                                  (1, 2, 130, 77, 80), (1, 1, 100, 200, 200)]


@pytest.mark.parametrize("shape", F32_BWD_SHAPES)
def test_flash_bwd_f32_kernel(cuda, shape):
    """dO is a non-contiguous view (the left half of a wider tensor's rows),
    which the kernels read in place through its row stride."""
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = fa.bwd_f32_q_splits(b, h, sq, skv, fa.kernel_head_dim(d, torch.float32), sms)
    if shape in F32_BWD_SPLIT + F32_BWD_WHOLE:
        assert (splits > 1) == (shape in F32_BWD_SPLIT)
    q = torch.randn(b, h, sq, d, generator=cuda, device="cuda")
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda") for _ in range(2))
    do = torch.randn(b, h, sq, 2 * d, generator=cuda, device="cuda")[..., :d]
    assert not do.is_contiguous()
    scale = 1.0 / math.sqrt(d)
    qs = q * (scale * fa.LOG2_E)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
    di = (do * o_ref).sum(-1)
    n, n_bf16 = fa.flash_bwd_f32.launches, fa.flash_bwd.launches
    got = fa.flash_bwd(qs, k, v, do, lse_ref, di, scale)
    want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_f32.launches, fa.flash_bwd.launches) == (n + 1, n_bf16)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape and _rel(g, w) < 1e-4


@pytest.mark.parametrize("shape", [(1, 8, 1024, 1024, 40), (8, 1, 1024, 1024, 512)])
def test_flash_bwd_f32_is_deterministic(cuda, shape):
    """Where the q range is whole, every fp32 grad is written once by plain
    stores: two calls give the same bits."""
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fa.bwd_f32_q_splits(b, h, sq, skv, fa.kernel_head_dim(d, torch.float32), sms) == 1
    q, do = (torch.randn(b, h, sq, d, generator=cuda, device="cuda") for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda") for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qs = q * (scale * fa.LOG2_E)
    o, lse = fa.flash_fwd(qs, k, v)
    di = (do * o).sum(-1)
    first = fa.flash_bwd(qs, k, v, do, lse, di, scale)
    second = fa.flash_bwd(qs, k, v, do, lse, di, scale)
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("shape", [(8, 1, 1024, 1024, 512), (2, 1, 200, 300, 512)])
def test_flash_bwd_bf16_512_is_deterministic(cuda, shape):
    """The bf16 backward at head dim 512 (a dQ kernel and a dK/dV kernel)
    writes every grad once by plain stores: two calls give the same bits."""
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    q, do = (torch.randn(b, h, sq, d, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qs = (q * (scale * fa.LOG2_E)).to(q.dtype)
    o, lse = fa.flash_fwd(qs, k, v)
    di = (do.float() * o.float()).sum(-1)
    first = fa.flash_bwd(qs, k, v, do, lse, di, scale)
    second = fa.flash_bwd(qs, k, v, do, lse, di, scale)
    for a, b_ in zip(first, second):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b_)


# fp32 at every kernel head dim family, as the fp32 UNets and the small VAEs
# give it: d = 40 (SD1.5's UNet) and 48 run at 64, 80 at 96, 200 at 512, 64 and
# 160 as built; each with a ragged q tail over the kv = 77 tail, self-attention
# over 1024 tokens at d = 40 and 64, and the fp32 SDXL UNet's level-1 rows, the
# longest chains (dQ over 4096 keys, dK and dV over 4096 queries)
F32_SHAPES = [(1, 2, 300, 77, 40), (1, 2, 300, 77, 48), (1, 2, 300, 77, 64), (1, 2, 300, 77, 80),
              (1, 2, 300, 77, 160), (1, 8, 1024, 1024, 40), (2, 1, 1024, 1024, 64), (2, 1, 130, 200, 48),
              (1, 2, 100, 77, 200), (2, 10, 4096, 77, 64), (2, 10, 4096, 4096, 64)]


@pytest.mark.parametrize("shape", F32_SHAPES)
def test_flash_f32_kernels_at_every_head_dim(cuda, shape):
    """Forward and backward through the padded fp32 kernels against the plain
    version at the true head dim, with the true head dim's scale."""
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
    q, do = (torch.randn(b, h, sq, d, generator=cuda, device="cuda") for _ in range(2))
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda") for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qs = q * (scale * fa.LOG2_E)
    n_fwd, n_bwd = fa.flash_fwd_f32.launches, fa.flash_bwd_f32.launches
    o, lse = fa.flash_fwd(qs, k, v)
    o_ref, lse_ref = fa.flash_fwd_plain(qs, k, v)
    di = (do * o_ref).sum(-1)
    got = fa.flash_bwd(qs, k, v, do, lse_ref, di, scale)
    want = fa.flash_bwd_plain(qs, k, v, do, lse_ref, di, scale)
    torch.cuda.synchronize()
    assert (fa.flash_fwd_f32.launches, fa.flash_bwd_f32.launches) == (n_fwd + 1, n_bwd + 1)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert _rel(o, o_ref) < 2e-5
    assert float((lse - lse_ref).abs().max()) < 2e-5
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g, w) < 1e-4


def test_flash_f32_autograd_matches_plain(cuda):
    """fp32 q/k/v through flash_attention on the card: the forward and the
    backward kernels under autograd, with strided head-split views."""
    from neurosis_tpu_torch.ops.attention import plain_attention
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    b, s, d = 2, 600, 512
    x = [torch.randn(b, s, d, generator=cuda, device="cuda").requires_grad_() for _ in range(3)]
    y = [t.detach().clone().requires_grad_() for t in x]
    out = flash_attention(*(t.reshape(b, s, 1, d).transpose(1, 2) for t in x))
    ref = plain_attention(*(t.reshape(b, s, 1, d).transpose(1, 2) for t in y))
    assert _rel(out.detach(), ref.detach()) < 2e-5
    w = torch.randn(out.shape, generator=cuda, device="cuda")
    (out * w).sum().backward()
    (ref * w).sum().backward()
    for a, r in zip(x, y):
        assert _rel(a.grad, r.grad) < 1e-4


@pytest.mark.parametrize("heads,d", [(8, 40), (2, 80), (2, 160), (2, 512), (2, 200)])
def test_flash_f32_autograd_head_split_views(cuda, heads, d):
    """fp32 q/k/v as the attention layer hands them over, head-split views of a
    [B, S, H·D] projection, through flash_attention at each kernel head dim
    (40, 80 and 200 padded), with a ragged q tail and the kv = 77 tail of
    cross-attention."""
    from neurosis_tpu_torch.ops.attention import plain_attention
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    b, s, skv = 2, 600, 77
    xq = torch.randn(b, s, heads * d, generator=cuda, device="cuda").requires_grad_()
    xk, xv = (torch.randn(b, skv, heads * d, generator=cuda, device="cuda").requires_grad_() for _ in range(2))
    x = [xq, xk, xv]
    y = [t.detach().clone().requires_grad_() for t in x]
    split = lambda t: t.reshape(b, t.shape[1], heads, d).transpose(1, 2)
    q = split(xq)
    assert not q.is_contiguous()
    out = flash_attention(q, split(xk), split(xv))
    ref = plain_attention(*(split(t) for t in y))
    assert _rel(out.detach(), ref.detach()) < 2e-5
    w = torch.randn(out.shape, generator=cuda, device="cuda")
    (out * w).sum().backward()
    (ref * w).sum().backward()
    for a, r in zip(x, y):
        assert _rel(a.grad, r.grad) < 1e-4


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
@pytest.mark.parametrize("sq,skv", [(130, 256), (64, 1024), (100, 192)])
def test_flash_overlap_kernels(cuda, sq, skv, n_chunks):
    """Chunks of 24 to 1024 rows: chunks shorter than the kernel's 128-row stage
    (masked; 192 / 8 = 24 is no multiple of 16 either), chunks longer than a
    stage, and a ragged q tail. split2 is the 2-chunk entry."""
    from neurosis_tpu_torch.ops import flash_attention as fa
    from neurosis_tpu_torch.ops import flash_overlap as fo

    b, h, d = 2, 3, 64
    q = torch.randn(b, h, sq, d, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(b, h, skv, d, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    qs = (q * (fa.LOG2_E / math.sqrt(d))).to(q.dtype)
    n = fo.flash_fwd_chunked.launches
    o = fo.flash_fwd_chunked(qs, k, v, n_chunks)
    torch.cuda.synchronize()
    assert fo.flash_fwd_chunked.launches == n + 1
    assert _rel(o, fo.flash_fwd_chunked_plain(qs, k, v, n_chunks)) < 1e-2
    assert _rel(o, fa.flash_fwd_plain(qs, k, v)[0]) < 2e-2
    if n_chunks == 2:
        n = fo.flash_fwd_split2.launches
        o2 = fo.flash_fwd_split2(qs, k, v)
        torch.cuda.synchronize()
        assert fo.flash_fwd_split2.launches == n + 1
        assert torch.equal(o2, o)


@pytest.mark.parametrize("b,h,sq,skv,n_chunks", [(2, 2, 1024, 1024, 1), (2, 2, 1024, 1024, 16),
                                                    (1, 2, 200, 320, 2), (1, 2, 130, 600, 3)])
def test_flash_overlap_kernels_at_more_chunk_counts(cuda, b, h, sq, skv, n_chunks):
    """One chunk and 16 chunks over 1024 keys; chunks that end inside a 128-row
    stage (160 = 128 + 32 rows, 200 = 128 + 72), so a stage's TMA box reaches
    into the next chunk, whose rows are masked."""
    from neurosis_tpu_torch.ops import flash_attention as fa
    from neurosis_tpu_torch.ops import flash_overlap as fo

    q = torch.randn(b, h, sq, 64, generator=cuda, device="cuda").bfloat16()
    k, v = (torch.randn(b, h, skv, 64, generator=cuda, device="cuda").bfloat16() for _ in range(2))
    qs = (q * (fa.LOG2_E / 8.0)).to(q.dtype)
    o = fo.flash_fwd_chunked(qs, k, v, n_chunks)
    torch.cuda.synchronize()
    assert _rel(o, fo.flash_fwd_chunked_plain(qs, k, v, n_chunks)) < 1e-2
    assert _rel(o, fa.flash_fwd_plain(qs, k, v)[0]) < 2e-2
    if n_chunks == 2:
        assert torch.equal(fo.flash_fwd_split2(qs, k, v), o)


def test_flash_overlap_refuses_ragged_chunks(cuda):
    from neurosis_tpu_torch.ops import flash_overlap as fo

    q = torch.zeros(1, 1, 64, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 77, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no multiple"):
        fo.flash_fwd_split2(q, kv, kv)
    with pytest.raises(ValueError, match="no multiple"):
        fo.flash_fwd_chunked(q, kv, kv, 4)
    wide = torch.zeros(1, 1, 64, 80, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fo.flash_fwd_chunked(wide, wide, wide, 2)
    assert fo.flash_fwd_chunked(q, kv, kv, 7).shape == q.shape  # 7 chunks of 11 rows


def test_flash_autograd_through_strided_views(cuda):
    """q/k/v as the attention layer hands them over: head-split views of a
    [B, S, H·D] projection, read in place by the kernel."""
    from neurosis_tpu_torch.ops.attention import plain_attention
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    b, s, h, d = 2, 576, 8, 40
    x = [torch.randn(b, s, h * d, generator=cuda, device="cuda").bfloat16().requires_grad_() for _ in range(3)]
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2) for t in x)
    out = flash_attention(q, k, v)
    ref = plain_attention(*(t.detach().float().reshape(b, s, h, d).transpose(1, 2) for t in x))
    assert _rel(out, ref) < 2e-2
    out.float().square().sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in x)


# (B, H, W, C, F): one and several channel tiles, C = 96 a ragged 64-channel
# stage, each block width (64, 128, 160, 256); W = 28 (the 40x28 level of a
# 640x448 SD1.5 bucket) takes two column tiles of 14; W = 200 twelve of 17,
# with a ragged last one; the SDXL step's 2x32x32x1280->1280 and the VAE's
# 8x64x64x512->512 at full size; C = 1920 (an SDXL output block's input) over
# W = 201, fifteen column tiles of 14, the last ragged
@pytest.mark.parametrize("shape", [(2, 32, 32, 128, 256), (1, 32, 32, 256, 128), (1, 64, 64, 64, 64),
                                   (2, 16, 48, 96, 192), (1, 40, 28, 128, 128), (1, 7, 200, 64, 64),
                                   (2, 32, 32, 1280, 1280), (8, 64, 64, 512, 512), (1, 9, 201, 1920, 192)])
def test_conv_kernels(cuda, shape):
    from neurosis_tpu_torch.ops import conv3x3 as cv

    b, hh, ww, c, f = shape
    x = torch.randn(b, hh, ww, c, generator=cuda, device="cuda").bfloat16()
    w_k = (torch.randn(3, 3, c, f, generator=cuda, device="cuda") / math.sqrt(9 * c)).bfloat16()
    a = 1.0 + 0.2 * torch.randn(b, c, generator=cuda, device="cuda")
    bb = 0.3 * torch.randn(b, c, generator=cuda, device="cuda")
    assert _rel(cv.conv3x3_nhwc(x, w_k), cv.conv3x3_plain(x, w_k)) < 2e-2
    assert _rel(cv.gn_silu_conv3x3_nhwc(x, a, bb, w_k), cv.gn_silu_conv3x3_plain(x, a, bb, w_k)) < 2e-2


def test_gn_silu_halo_is_zero_after_activation(cuda):
    """x = 0 with a bias b > 0: a corner pixel sums 4 non-zero taps of
    silu(b), an inner one 9; a halo activated to silu(b) would give 9 everywhere."""
    from neurosis_tpu_torch.ops.conv3x3 import gn_silu_conv3x3_nhwc

    x = torch.zeros(1, 32, 32, 32, device="cuda", dtype=torch.bfloat16)
    a = torch.ones(1, 32, device="cuda")
    b = torch.full((1, 32), 2.0, device="cuda")
    w = torch.full((3, 3, 32, 64), 1.0 / 64, device="cuda", dtype=torch.bfloat16)
    out = gn_silu_conv3x3_nhwc(x, a, b, w)[0, :, :, 0].float()
    act = float(torch.tensor(2.0).bfloat16().float() * torch.sigmoid(torch.tensor(2.0)))
    assert abs(float(out[5, 5]) - 9 * 32 / 64 * act) < 5e-2
    assert abs(float(out[0, 0]) - 4 * 32 / 64 * act) < 5e-2


def test_gn_silu_conv_backward(cuda):
    from neurosis_tpu_torch.ops import conv3x3 as cv

    x = torch.randn(2, 32, 32, 128, generator=cuda, device="cuda").bfloat16()
    dy = torch.randn(2, 32, 32, 256, generator=cuda, device="cuda").bfloat16()
    w = (torch.randn(256, 128, 3, 3, generator=cuda, device="cuda") / 34.0).bfloat16()
    a = 1.0 + 0.2 * torch.randn(2, 128, generator=cuda, device="cuda")
    b = 0.3 * torch.randn(2, 128, generator=cuda, device="cuda")
    n = cv.conv3x3_nhwc.launches
    got = cv.gn_silu_conv3x3_bwd(x, a, b, w, dy)
    assert cv.conv3x3_nhwc.launches == n + 1  # dgrad through the conv kernel
    want = cv.gn_silu_conv3x3_bwd(x, a, b, w, dy, conv=cv.conv3x3_plain)
    for g, r in zip(got, want):
        assert _rel(g, r) < 2e-2
