"""neurosis_tpu_torch flash attention (plain version, CPU) against the JAX
Pallas flash attention in interpret mode: forward and grads, with the
tolerances of tests/test_flash_attention.py (fp32: 3e-6/1e-4 forward,
2e-5/1e-3 grads)."""

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


def test_fp32_backward_matches_jax(interpreted_flash):
    """The fp32 backward entry (on the CPU: the plain version that the fp32
    kernel is held against on the card) from the forward's own residuals
    and a given cotangent, against the VJP of JAX's kernels at the VAE's head
    dim, with the JAX suite's grad tolerance (2e-5 / 1e-3)."""
    import math

    from neurosis_tpu_torch.ops import flash_attention as tfa

    fa = interpreted_flash
    b, h, s, d = 1, 1, 256, 512
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
