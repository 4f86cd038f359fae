"""The port's CUDA kernels against their plain versions on the card, at small
shapes that reach every code path of each kernel: a ragged q tail, the
masked kv=77 tail, each head dim the kernel takes (512 with ragged q and kv
tails, in bf16 and in fp32), channel counts that take one and several tiles,
the GroupNorm prologue's zeroed halo.

These need a CUDA card (a CUDA kernel has no interpreter) and skip without
one. On the card, where JAX is absent (tests/conftest.py imports it):
    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
Tolerances are on max|kernel - plain| / max|plain|, bf16 inputs on both
sides: 2e-2 for outputs (the kernels round P, dS or the activation to bf16
where the plain versions keep fp32), 5e-2 for attention grads. The fp32
flash forward computes in fp32 throughout, as its plain version does: 2e-5
(the same fp32 sums in another order).
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


@pytest.mark.parametrize("shape", [(2, 3, 300, 77, 40), (1, 2, 256, 256, 80), (1, 2, 130, 200, 64),
                                   (1, 1, 64, 77, 160), (2, 1, 200, 300, 512), (1, 1, 1024, 1024, 512)])
def test_flash_kernels(cuda, shape):
    from neurosis_tpu_torch.ops import flash_attention as fa

    b, h, sq, skv, d = shape
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


@pytest.mark.parametrize("shape", [(2, 1, 100, 130, 512), (1, 1, 1024, 1024, 512)])
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


# (B, H, W, C, F): one and several channel tiles; W = 28 is a ragged tile
# row (the 40x28 level of a 640x448 SD1.5 bucket); W = 200 takes two
# column tiles, with a ragged last one
@pytest.mark.parametrize("shape", [(2, 32, 32, 128, 256), (1, 32, 32, 256, 128), (1, 64, 64, 64, 64),
                                   (2, 16, 48, 96, 192), (1, 40, 28, 128, 128), (1, 7, 200, 64, 64)])
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
