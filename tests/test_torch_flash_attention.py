"""neurosis_tpu_torch flash attention (plain version, CPU) against the JAX
Pallas flash attention in interpret mode: forward and grads, with the
tolerances of tests/test_flash_attention.py (fp32: 3e-6/1e-4 forward,
2e-5/1e-3 grads); plain-torch models of the fp32 kernels' split-TF32
arithmetic and of the bf16 head-dim-512 backward's rounding against the
same JAX kernels."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402


@pytest.fixture()
def interpreted_flash(monkeypatch):
    import jax.experimental.pallas as pl

    import neurosis_tpu.ops.flash_attention as fa

    orig = pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(fa.pl, "pallas_call", interp)
    return fa


@pytest.mark.parametrize(
    "shape",
    [
        (1, 2, 256, 256, 40),  # SD1.5 level-0 head dim, self-attention
        (1, 2, 256, 256, 80),  # SD1.5 level-1 head dim
        (1, 2, 300, 77, 40),  # cross-attention: kv=77 tail, ragged q
        (1, 2, 128, 77, 80),
        (1, 1, 256, 256, 512),  # the VAE's single-head mid attention
        (2, 1, 200, 128, 512),  # ragged q and kv at head dim 512
        (1, 1, 1024, 1024, 64),  # the smoke VAEs' mid attention (ch 32 x 2), 1024 tokens
        (1, 2, 200, 77, 48),  # a head dim no kernel is built for (padded to 64 on the card)
    ],
)
def test_flash_matches_jax(interpreted_flash, shape):
    from neurosis_tpu_torch.ops.flash_attention import flash_attention

    fa = interpreted_flash
    b, h, sq, skv, d = shape
    rng = np.random.RandomState(0)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, h, skv, d).astype(np.float32)
    v = rng.randn(b, h, skv, d).astype(np.float32)

    jq, jk, jv = (jnp.asarray(a.copy()) for a in (q, k, v))
    run = lambda *a: fa.flash_attention(*a, block_q=128, block_k=128)
    out_j = run(jq, jk, jv)
    g_j = jax.grad(lambda *a: jnp.sum(run(*a) ** 2), argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.tensor(a.copy(), requires_grad=True) for a in (q, k, v))
    out_t = flash_attention(tq, tk, tv)
    (out_t**2).sum().backward()

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), atol=3e-6, rtol=1e-4)
    for gt, gj in zip((tq.grad, tk.grad, tv.grad), g_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("s,d", [(256, 512), (1024, 64), (200, 48)])
def test_fp32_backward_matches_jax(interpreted_flash, s, d):
    """The fp32 backward entry (on the CPU: the plain version that the fp32
    kernel is held against on the card) from the forward's own residuals
    and a given cotangent, against the VJP of JAX's kernels at the VAE's head
    dim, the smoke VAEs' (64) and one no kernel is built for (48), with the
    JAX suite's grad tolerance (2e-5 / 1e-3)."""
    import math

    from neurosis_tpu_torch.ops import flash_attention as tfa

    fa = interpreted_flash
    b, h = 1, 1
    rng = np.random.RandomState(1)
    q, k, v, do = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(4))
    run = lambda *a: fa.flash_attention(*a, block_q=128, block_k=128)
    out_j, vjp = jax.vjp(run, *(jnp.asarray(a.copy()) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do.copy()))

    tq, tk, tv, tdo = (torch.tensor(a.copy()) for a in (q, k, v, do))
    scale = 1.0 / math.sqrt(d)
    qs = tq * (scale * tfa.LOG2_E)
    o, lse = tfa.flash_fwd_f32(qs, tk, tv)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_j), atol=3e-6, rtol=1e-4)
    grads = tfa.flash_bwd_f32(qs, tk, tv, tdo, lse, (tdo * o).sum(-1), scale)
    for gt, gj in zip(grads, g_j):
        assert gt.dtype == torch.float32
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=2e-5, rtol=1e-3)


def _tf32_rna(x: "torch.Tensor") -> "torch.Tensor":
    """x rounded to the nearest tf32 (ties away from zero) with its low 13 bits
    clear, as the kernel's cvt.rna.tf32.f32 and mask give it."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _split_tf32_flash(qs, k, v, passes: int, block_k: int = 64):
    """A plain-torch model of the fp32 forward kernel's arithmetic: every
    product a·bᵀ as hi·hiᵀ + hi·loᵀ + lo·hiᵀ of the operands' tf32 splits (or,
    with ``passes=1``, hi·hiᵀ alone, one TF32 product), P split the same way
    for P·V, and the online softmax over kv tiles of ``block_k`` keys."""

    def mm(a, b):
        ah, al = _tf32_split(a)
        bh, bl = _tf32_split(b)
        out = ah @ bh.transpose(-1, -2)
        if passes == 3:
            out = out + ah @ bl.transpose(-1, -2) + al @ bh.transpose(-1, -2)
        return out

    vt = v.transpose(-1, -2)
    m = torch.full(qs.shape[:-1], -torch.inf)
    l = torch.zeros(qs.shape[:-1])
    o = torch.zeros(qs.shape[:-1] + (v.shape[-1],))
    for t0 in range(0, k.shape[-2], block_k):
        s = mm(qs, k[..., t0:t0 + block_k, :])
        mx = torch.maximum(m, s.amax(-1))
        a = torch.exp2(m - mx)
        p = torch.exp2(s - mx[..., None])
        l = l * a + p.sum(-1)
        o = o * a[..., None] + mm(p, vt[..., t0:t0 + block_k])
        m = mx
    return o / l[..., None], m + torch.log2(l)


@pytest.mark.parametrize("passes", [3, 1])
@pytest.mark.parametrize("shape", [(1, 2, 256, 256, 64), (1, 1, 256, 256, 512), (1, 2, 200, 77, 48)])
def test_split_tf32_arithmetic_matches_jax(interpreted_flash, shape, passes):
    """The card's fp32 forward computes every product with three TF32 tensor-core
    products of split operands. Its arithmetic, modelled in plain torch at the
    kernel head dim (48 padded to 64, a kv = 77 tail), against JAX's fp32 flash
    attention interpreted, at the fp32 parity tolerance (3e-6 / 1e-4): three
    passes meet it, and one pass (plain TF32) does not."""
    import math

    import torch.nn.functional as F

    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, kernel_head_dim

    fa = interpreted_flash
    b, h, sq, skv, d = shape
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (sq, skv, skv))
    out_j = np.asarray(fa.flash_attention(*(jnp.asarray(a.copy()) for a in (q, k, v)), block_q=128, block_k=128))

    dp = kernel_head_dim(d, torch.float32)
    pad = lambda a: F.pad(torch.tensor(a.copy()), (0, dp - d))
    qs = pad(q) * (LOG2_E / math.sqrt(d))
    o, lse = _split_tf32_flash(qs, pad(k), pad(v), passes)
    assert bool((o[..., d:] == 0).all())
    o = o[..., :d].numpy()
    if passes == 3:
        np.testing.assert_allclose(o, out_j, atol=3e-6, rtol=1e-4)
        s = torch.tensor(q.copy()) @ torch.tensor(k.copy()).transpose(-1, -2) * (LOG2_E / math.sqrt(d))
        torch.testing.assert_close(lse, torch.logsumexp(s * math.log(2.0), -1) / math.log(2.0), atol=2e-5, rtol=0)
    else:
        assert not np.allclose(o, out_j, atol=3e-6, rtol=1e-4)


def _split_tf32_bwd(qs, k, v, do, lse, di, scale: float, splits: int = 1, block: int = 64):
    """A plain-torch model of the fp32 backward kernels' arithmetic, JAX's two
    passes: every product a·bᵀ as lo·hi + hi·lo + hi·hi of the operands' tf32
    splits (the small ones first), each tile's product in a fresh sum added
    into its grad in fp32. The dQ pass walks kv in tiles of ``block`` keys
    (S, dP, P from the saved LSE, dS, dQ += dS·K); the dK/dV pass walks q in
    tiles of ``block`` rows (Sᵀ, Pᵀ, dPᵀ, dSᵀ from Pᵀ read back as hi + lo,
    dV += Pᵀ·dO, dK += dSᵀ·q̃), over ``splits`` q ranges whose partial dK
    and dV are summed, as the kernel's split blocks add theirs."""
    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, bwd_q_ranges

    def mm(a, b):
        ah, al = _tf32_split(a)
        bh, bl = _tf32_split(b)
        return al @ bh.transpose(-1, -2) + ah @ bl.transpose(-1, -2) + ah @ bh.transpose(-1, -2)

    dq = torch.zeros_like(qs)
    for t0 in range(0, k.shape[-2], block):
        kt, vt = k[..., t0:t0 + block, :], v[..., t0:t0 + block, :]
        p = torch.exp2(mm(qs, kt) - lse[..., None])
        ds = p * (mm(do, vt) - di[..., None])
        dq = dq + mm(ds, kt.transpose(-1, -2))
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for start, stop in bwd_q_ranges(qs.shape[-2], splits):
        dk_part, dv_part = torch.zeros_like(k), torch.zeros_like(v)
        for t0 in range(start, stop, block):
            qt, dot = qs[..., t0:t0 + block, :], do[..., t0:t0 + block, :]
            pt = torch.exp2(mm(k, qt) - lse[..., None, t0:t0 + block])
            pt_read = sum(_tf32_split(pt))
            dst = pt_read * (mm(v, dot) - di[..., None, t0:t0 + block])
            dv_part = dv_part + mm(pt, dot.transpose(-1, -2))
            dk_part = dk_part + mm(dst, qt.transpose(-1, -2))
        dk, dv = dk + dk_part, dv + dv_part
    return dq * scale, dk / LOG2_E, dv


@pytest.mark.parametrize("shape,splits", [((1, 2, 256, 256, 64), 1), ((1, 1, 256, 256, 512), 1),
                                          ((1, 2, 200, 77, 48), 1), ((1, 2, 200, 77, 48), 3)])
def test_split_tf32_backward_matches_jax(interpreted_flash, shape, splits):
    """The card's fp32 backward (a dQ kernel and a dK/dV kernel, each product
    three TF32 tensor-core products of split operands), modelled in plain torch
    at the kernel head dim (48 padded to 64, a kv = 77 tail), against the VJP of
    JAX's fp32 flash attention interpreted (its _bwd), at the fp32 grad
    tolerance (2e-5 / 1e-3); with the q range whole and split over 3 blocks."""
    import math

    import torch.nn.functional as F

    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, flash_fwd_plain, kernel_head_dim

    fa = interpreted_flash
    b, h, sq, skv, d = shape
    rng = np.random.RandomState(4)
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    run = lambda *a: fa.flash_attention(*a, block_q=128, block_k=128)
    _, vjp = jax.vjp(run, *(jnp.asarray(a.copy()) for a in (q, k, v)))
    g_j = vjp(jnp.asarray(do.copy()))

    dp = kernel_head_dim(d, torch.float32)
    pad = lambda a: F.pad(torch.tensor(a.copy()), (0, dp - d))
    scale = 1.0 / math.sqrt(d)
    qs, tk, tv, tdo = pad(q) * (scale * LOG2_E), pad(k), pad(v), pad(do)
    o, lse = flash_fwd_plain(qs, tk, tv)
    grads = _split_tf32_bwd(qs, tk, tv, tdo, lse, (tdo * o).sum(-1), scale, splits)
    for gt, gj in zip(grads, g_j):
        assert bool((gt[..., d:] == 0).all())
        np.testing.assert_allclose(gt[..., :d].numpy(), np.asarray(gj), atol=2e-5, rtol=1e-3)


def _bf16_two_pass_bwd(qs, k, v, do, lse, di, scale: float, block: int = 64):
    """A plain-torch model of the bf16 head-dim-512 backward kernels' arithmetic,
    JAX's two passes, in the kernels' order: the dQ pass walks kv in tiles of
    ``block`` keys (S and dP in fp32, P from the saved LSE, dS rounded to bf16,
    dQ += dS·K in fp32, written once, scaled); the dK/dV pass walks q in tiles
    of ``block`` rows (Sᵀ, dPᵀ, Pᵀ and dSᵀ rounded to bf16, dV += Pᵀ·dO, dK +=
    dSᵀ·q̃ in fp32); every grad rounded to bf16 once."""
    from neurosis_tpu_torch.ops.flash_attention import LOG2_E

    q32, k32, v32, do32 = (t.float() for t in (qs, k, v, do))
    rnd = lambda t: t.to(torch.bfloat16).float()
    dq = torch.zeros_like(q32)
    for t0 in range(0, k.shape[-2], block):
        kt, vt = k32[..., t0:t0 + block, :], v32[..., t0:t0 + block, :]
        p = torch.exp2(q32 @ kt.transpose(-1, -2) - lse[..., None])
        ds = rnd(p * (do32 @ vt.transpose(-1, -2) - di[..., None]))
        dq = dq + ds @ kt
    dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
    for t0 in range(0, qs.shape[-2], block):
        qt, dot = q32[..., t0:t0 + block, :], do32[..., t0:t0 + block, :]
        pt = torch.exp2(k32 @ qt.transpose(-1, -2) - lse[..., None, t0:t0 + block])
        dst = pt * (v32 @ dot.transpose(-1, -2) - di[..., None, t0:t0 + block])
        dv = dv + rnd(pt) @ dot
        dk = dk + rnd(dst) @ qt
    return tuple(g.to(torch.bfloat16) for g in (dq * scale, dk / LOG2_E, dv))


@pytest.mark.parametrize("shape", [(1, 1, 128, 128, 512), (1, 1, 100, 77, 512)])
def test_bf16_two_pass_backward_matches_jax(interpreted_flash, shape):
    """The card's bf16 backward at head dim 512 (a dQ kernel and a dK/dV kernel,
    P and dS rounded to bf16 per 64-row tile, fp32 sums, each grad rounded to
    bf16 once), modelled in plain torch, against the VJP of JAX's flash
    attention interpreted in bf16 (its _bwd), a ragged q and the kv = 77 tail
    included. Both sides round the same P and dS and each grad once, and sum
    in fp32 in another order: a grad may differ by a few of its bf16 rounding
    steps (2^-8 relative), so 2e-2 relative to the grad's largest entry."""
    import math

    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, flash_fwd_plain

    fa = interpreted_flash
    b, h, sq, skv, d = shape
    rng = np.random.RandomState(5)
    q, do = (rng.randn(b, h, sq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, skv, d).astype(np.float32) for _ in range(2))
    bf = lambda a: jnp.asarray(a.copy()).astype(jnp.bfloat16)
    run = lambda *a: fa.flash_attention(*a, block_q=128, block_k=128)
    _, vjp = jax.vjp(run, bf(q), bf(k), bf(v))
    g_j = vjp(bf(do))

    tb = lambda a: torch.tensor(a.copy()).to(torch.bfloat16)
    tq, tk, tv, tdo = tb(q), tb(k), tb(v), tb(do)
    scale = 1.0 / math.sqrt(d)
    qs = (tq * (scale * LOG2_E)).to(torch.bfloat16)
    o, lse = flash_fwd_plain(qs, tk, tv)
    grads = _bf16_two_pass_bwd(qs, tk, tv, tdo, lse, (tdo.float() * o.float()).sum(-1), scale)
    for gt, gj in zip(grads, g_j):
        want = np.asarray(gj.astype(jnp.float32))
        got = gt.float().numpy()
        assert gt.dtype == torch.bfloat16 and got.shape == want.shape
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_tf32_split_is_exact_to_fp32():
    """hi + lo recovers x to 2^-22 relative, hi and lo are tf32 (low 13 bits
    clear), and |lo| <= 2^-11 |x|: the split the kernel's passes write."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(100_000, generator=g) * torch.exp2(torch.randint(-20, 20, (100_000,), generator=g).float())
    hi, lo = _tf32_split(x)
    for part in (hi, lo):
        assert bool((part.view(torch.int32) & 0x1FFF == 0).all())
    assert bool(((x - hi).abs() <= x.abs() * 2.0**-11).all())
    assert bool(((x - hi - lo).abs() <= x.abs() * 2.0**-22).all())
    assert bool(((x - hi).abs() > x.abs() * 2.0**-14).any())  # lo carries real bits


def test_plain_lse_is_base2():
    """The forward's residual is log2 Σ 2^s over the pre-scaled logits, the
    statistic the backward kernel rebuilds P from."""
    from neurosis_tpu_torch.ops.flash_attention import flash_fwd

    g = torch.Generator().manual_seed(0)
    qs, k, v = (torch.randn(1, 2, 64, 40, generator=g) for _ in range(3))
    _, lse = flash_fwd(qs, k, v)
    s = qs @ k.transpose(-1, -2)
    want = torch.logsumexp(s * np.log(2.0), dim=-1) / np.log(2.0)
    torch.testing.assert_close(lse, want, atol=1e-5, rtol=1e-5)


def test_dispatch_routes_long_rows_to_flash(monkeypatch):
    """q ≥ 512 and no mask → flash (JAX _PALLAS_MIN_SEQ); masked or short
    rows → plain."""
    import neurosis_tpu_torch.ops.attention as attn

    calls = []
    monkeypatch.setattr(attn, "flash_attention", lambda q, k, v: calls.append(q.shape) or attn.plain_attention(q, k, v))
    long_bf16 = torch.zeros(1, 1, 512, 40, dtype=torch.bfloat16)
    kv = torch.zeros(1, 1, 77, 40, dtype=torch.bfloat16)
    attn.dot_product_attention(long_bf16, kv, kv)
    assert calls == [long_bf16.shape]
    attn.dot_product_attention(long_bf16[:, :, :511], kv, kv)
    attn.dot_product_attention(long_bf16, kv, kv, mask=torch.ones(512, 77, dtype=torch.bool))
    assert len(calls) == 1


@pytest.mark.parametrize("b,h,sq,skv", [(2, 10, 4096, 77), (2, 20, 1024, 77), (4, 8, 4096, 77), (4, 8, 1024, 77),
                                        (2, 10, 4096, 4096), (2, 20, 1024, 1024), (4, 8, 1024, 1024),
                                        (2, 3, 300, 77), (1, 2, 20, 77), (1, 1, 64, 77)])
def test_bwd_q_split_geometry(b, h, sq, skv):
    """The bf16 backward's split of the q range (a launch argument): one block
    per kv tile when the kv tiles fill the 132 SMs of an H100; at kv = 77 enough
    blocks for every SM (SDXL's 2x10x4096 and 2x20x1024 included); the ranges
    cut [0, Sq) into consecutive non-empty pieces on 64-row stage boundaries."""
    from neurosis_tpu_torch.ops.flash_attention import BWD_KV_ROWS, BWD_Q_ROWS, bwd_q_ranges, bwd_q_splits

    n = bwd_q_splits(b, h, sq, skv, 132)
    kv_blocks = -(-skv // BWD_KV_ROWS) * b * h
    q_tiles = -(-sq // BWD_Q_ROWS)
    assert 1 <= n <= q_tiles
    if kv_blocks >= 132 or q_tiles == 1:
        assert n == 1
    else:
        assert kv_blocks * n >= 132 or n == q_tiles
    ranges = bwd_q_ranges(sq, n)
    assert len(ranges) == n and ranges[0][0] == 0 and ranges[-1][1] == sq
    assert all(start < stop and start % BWD_Q_ROWS == 0 for start, stop in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


def test_bwd_q_splits_at_sdxl_cross_attention():
    from neurosis_tpu_torch.ops.flash_attention import bwd_q_splits

    assert bwd_q_splits(2, 10, 4096, 4096, 132) == 1
    assert bwd_q_splits(2, 20, 1024, 1024, 132) == 1
    assert 20 * bwd_q_splits(2, 10, 4096, 77, 132) >= 132
    assert 40 * bwd_q_splits(2, 20, 1024, 77, 132) >= 132


@pytest.mark.parametrize("b,h,sq,skv,d,whole", [(8, 1, 1024, 1024, 512, True), (1, 8, 1024, 1024, 64, True),
                                                (2, 10, 4096, 4096, 64, True), (2, 20, 1024, 1024, 64, True),
                                                (1, 8, 1024, 77, 64, False), (2, 10, 4096, 77, 64, False),
                                                (2, 20, 1024, 77, 64, False), (1, 1, 200, 77, 512, False)])
def test_bwd_f32_q_split_geometry(b, h, sq, skv, d, whole):
    """The fp32 dK/dV kernel's split of the q range on the 132 SMs of an H100:
    whole at the paths' self-attention rows (the fp32 pair's 8x1x1024x1024x512,
    128 blocks at SD1.5 fp32's 1x8x1024x1024), so their grads are written once;
    split at kv = 77, with no more blocks a kv tile than q tiles."""
    from neurosis_tpu_torch.ops.flash_attention import BWD_Q_ROWS, bwd_f32_q_splits, bwd_q_ranges

    n = bwd_f32_q_splits(b, h, sq, skv, d, 132)
    assert (n == 1) == whole and n <= -(-sq // BWD_Q_ROWS)
    ranges = bwd_q_ranges(sq, n)
    assert ranges[0][0] == 0 and ranges[-1][1] == sq and all(a < b_ for a, b_ in ranges)


@pytest.mark.parametrize("d,dp", [(40, 64), (48, 64), (80, 96), (33, 40), (200, 512)])
def test_padding_the_head_dim_is_exact(d, dp):
    """What the wrappers do on the card, in plain versions: q̃, k, v (and dO)
    zero-padded to the kernel's head dim, with the scale of the true head dim,
    give the true head dim's O, LSE and grads once sliced back."""
    import math

    import torch.nn.functional as F

    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, flash_bwd_plain, flash_fwd_plain

    g = torch.Generator().manual_seed(d)
    q, do = (torch.randn(2, 3, 70, d, generator=g) for _ in range(2))
    k, v = (torch.randn(2, 3, 77, d, generator=g) for _ in range(2))
    scale = 1.0 / math.sqrt(d)
    qs = q * (scale * LOG2_E)
    pad = lambda t: F.pad(t, (0, dp - d))
    o, lse = flash_fwd_plain(qs, k, v)
    o_p, lse_p = flash_fwd_plain(pad(qs), pad(k), pad(v))
    torch.testing.assert_close(o_p[..., :d], o, atol=1e-6, rtol=1e-6)
    assert bool((o_p[..., d:] == 0).all())
    torch.testing.assert_close(lse_p, lse, atol=1e-6, rtol=1e-6)
    di = (do * o).sum(-1)
    di_p = (pad(do) * o_p).sum(-1)
    torch.testing.assert_close(di_p, di, atol=1e-5, rtol=1e-6)
    grads = flash_bwd_plain(qs, k, v, do, lse, di, scale)
    grads_p = flash_bwd_plain(pad(qs), pad(k), pad(v), pad(do), lse_p, di_p, scale)
    for got, want in zip(grads_p, grads):
        torch.testing.assert_close(got[..., :d], want, atol=1e-5, rtol=1e-5)
        assert bool((got[..., d:] == 0).all())


def test_kernel_head_dim_over_every_head_dim():
    """Each head dim 1..512 runs at the smallest kernel head dim that holds it:
    bf16 at 40, 64, 80, 160 or 512, fp32 at 64, 96, 160 or 512; past 512 and in
    fp16 nothing takes it."""
    from neurosis_tpu_torch.ops.flash_attention import kernel_head_dim

    for dtype, dims in ((torch.bfloat16, (40, 64, 80, 160, 512)), (torch.float32, (64, 96, 160, 512))):
        got = [kernel_head_dim(d, dtype) for d in range(1, 513)]
        assert got == [min(dp for dp in dims if dp >= d) for d in range(1, 513)]
        assert set(got) == set(dims)
        for bad in (0, 513, 1024):
            with pytest.raises(ValueError, match="head dims"):
                kernel_head_dim(bad, dtype)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        kernel_head_dim(64, torch.float16)
