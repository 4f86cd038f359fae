"""neurosis_tpu_torch modules against their JAX twins at tiny sizes on the CPU.

Parameters come from the JAX init (perturbed so zero-init layers count),
move through jax_params_to_state_dict and load with strict=True; inputs are
seeded numpy. fp32 comparisons hold the algorithm: forward within 1e-5 of
the largest value for single layers, 1e-4 through the whole UNet; grads
within 1e-4 (layers) and 2e-4 (UNet, ~40 layers of reordered fp32 sums).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import check_grads, load_into, perturb, rel_err, t  # noqa: E402

os.environ.setdefault("NEUROSIS_PALLAS_INTERPRET", "1")
CPU = "cpu"


def test_groupnorm32_and_fold():
    from neurosis_tpu.modules.layers import GroupNorm32 as JGN
    from neurosis_tpu_torch.modules.layers import GroupNorm32

    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 64).astype(np.float32) * 3 + 1
    jgn = JGN(32)
    p = perturb(jgn.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 1, 0.3)
    gn = GroupNorm32(64, 32, device=CPU)
    load_into(gn, p)

    want = jgn.apply({"params": p}, jnp.asarray(x.copy()))
    assert rel_err(gn(t(x)).detach().numpy(), want) < 1e-5
    ja, jb = jgn.apply({"params": p}, jnp.asarray(x.copy()), fold=True)
    a, b = gn(t(x), fold=True)
    assert rel_err(a.detach().numpy(), ja) < 1e-5
    assert rel_err(b.detach().numpy(), jb) < 1e-5
    # bf16 in → bf16 out, computed in fp32
    assert gn(t(x, torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    from neurosis_tpu.modules.attention import CrossAttention as JCA
    from neurosis_tpu_torch.modules.attention import CrossAttention

    rng = np.random.RandomState(2)
    x = rng.randn(2, 24, 64).astype(np.float32)
    ctx = rng.randn(2, 77, 32).astype(np.float32) if cross else None
    jm = JCA(query_dim=64, context_dim=32 if cross else None, heads=4, dim_head=16)
    jargs = (jnp.asarray(x.copy()),) + ((jnp.asarray(ctx.copy()),) if cross else ())
    p = perturb(jm.init(jax.random.PRNGKey(0), *jargs)["params"], 3)
    m = CrossAttention(64, 32 if cross else None, 4, 16, device=CPU)
    load_into(m, p)

    want = jm.apply({"params": p}, *jargs)
    got = m(t(x), t(ctx) if cross else None)
    assert rel_err(got.detach().numpy(), want) < 1e-5


def test_spatial_transformer_checkpointed():
    from neurosis_tpu.modules.attention import SpatialTransformer as JST
    from neurosis_tpu_torch.modules.attention import SpatialTransformer

    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    ctx = rng.randn(2, 77, 48).astype(np.float32)
    jm = JST(in_channels=64, n_heads=2, d_head=32, depth=1, context_dim=48, use_checkpoint=True)
    jx, jc = jnp.asarray(x.copy()), jnp.asarray(ctx.copy())
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, jc)["params"], 5)
    m = SpatialTransformer(64, 2, 32, 1, 48, use_checkpoint=True, device=CPU)
    load_into(m, p)

    loss = lambda p_, a: jnp.sum(jm.apply({"params": p_}, a, jc) ** 2)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, jx)
    tx = t(x, requires_grad=True)
    out = m(tx, t(ctx))
    assert rel_err(out.detach().numpy(), jm.apply({"params": p}, jx, jc)) < 1e-5
    (out**2).sum().backward()
    assert rel_err(tx.grad.numpy(), gx) < 1e-4
    check_grads(m, gp, 1e-4)


def test_resblock_fp32():
    from neurosis_tpu.models.unet import ResBlock as JRB
    from neurosis_tpu_torch.models.unet import ResBlock

    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 32).astype(np.float32)
    emb = rng.randn(2, 16).astype(np.float32)
    jm = JRB(channels=32, emb_channels=16, out_channels=64)
    jx, je = jnp.asarray(x.copy()), jnp.asarray(emb.copy())
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, je)["params"], 7)
    m = ResBlock(32, 16, 64, device=CPU)
    load_into(m, p)

    gp = jax.grad(lambda p_: jnp.sum(jm.apply({"params": p_}, jx, je) ** 2))(p)
    out = m(t(x), t(emb))
    assert rel_err(out.detach().numpy(), jm.apply({"params": p}, jx, je)) < 1e-5
    (out**2).sum().backward()
    check_grads(m, gp, 1e-4)


def test_resblock_bf16_fused(monkeypatch):
    """At 32×32×128 in bf16 both packages route the GN→SiLU→conv pairs to
    the fused kernel (JAX interpreted, the port's plain version); bf16
    noise bound as in tests/test_fused_gn_conv.py."""
    from neurosis_tpu.models.unet import ResBlock as JRB
    from neurosis_tpu_torch.models.unet import ResBlock

    monkeypatch.setenv("NEUROSIS_FUSED_GN_CONV", "1")
    rng = np.random.RandomState(8)
    x = rng.randn(1, 32, 32, 128).astype(np.float32)
    emb = rng.randn(1, 32).astype(np.float32)
    jm = JRB(channels=128, emb_channels=32, dtype=jnp.bfloat16)
    jx, je = jnp.asarray(x.copy(), jnp.bfloat16), jnp.asarray(emb.copy(), jnp.bfloat16)
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, je)["params"], 9)
    m = ResBlock(128, 32, dtype=torch.bfloat16, device=CPU)
    load_into(m, p)
    assert m._fuse_ok(t(x, torch.bfloat16))

    want = np.asarray(jm.apply({"params": p}, jx, je), np.float32)
    got = m(t(x, torch.bfloat16), t(emb, torch.bfloat16)).float().detach().numpy()
    assert rel_err(got, want) < 1.5e-2


TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                 attention_resolutions=[2], channel_mult=[1, 2], num_heads=2, context_dim=64,
                 use_checkpoint=True)


def test_unet_tiny():
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu_torch.models.unet import UNetModel

    rng = np.random.RandomState(10)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ts = np.array([3, 41], np.int32)
    ctx = rng.randn(2, 77, 64).astype(np.float32)
    jm = JUNet(**TINY_UNET)
    jx, jt, jc = jnp.asarray(x.copy()), jnp.asarray(ts.copy()), jnp.asarray(ctx.copy())
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, jt, jc)["params"], 11)
    m = UNetModel(**TINY_UNET, device=CPU)
    load_into(m, p)

    gp = jax.jit(jax.grad(lambda p_: jnp.sum(jm.apply({"params": p_}, jx, jt, jc) ** 2)))(p)
    out = m(t(x), torch.tensor(ts), t(ctx))
    assert out.shape == (2, 16, 16, 4)
    assert rel_err(out.detach().numpy(), jax.jit(jm.apply)({"params": p}, jx, jt, jc)) < 1e-4
    (out**2).sum().backward()
    check_grads(m, gp, 2e-4)


def _token_ids(rng, b):
    ids = rng.randint(1, 49000, size=(b, 77)).astype(np.int64)
    ids[:, 0] = 49406
    ids[np.arange(b), rng.randint(5, 77, size=b)] = 49407  # EOS, the largest id
    return ids


def test_clip_text_tower():
    from neurosis_tpu.models.text_encoder.clip import CLIPTextTower as JCLIP
    from neurosis_tpu_torch.models.text_encoder.clip import CLIPTextTower

    ids = _token_ids(np.random.RandomState(12), 2)
    jm = JCLIP(width=64, layers=2, heads=2)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 13)
    m = CLIPTextTower(width=64, layers=2, heads=2, device=CPU)
    load_into(m, p)

    want = jm.apply({"params": p}, jnp.asarray(ids.copy()))
    got = m(torch.tensor(ids))
    for key in ("last_hidden_state", "pooler_output"):
        assert rel_err(got[key].detach().numpy(), want[key]) < 1e-5, key
    assert rel_err(got["hidden_states"][1].detach().numpy(), want["hidden_states"][1]) < 1e-5


def test_conditioner_crossattn():
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, GeneralConditioner

    ids = _token_ids(np.random.RandomState(14), 2)
    jm = JCond(embedders=with_embedder_names([JEmb(width=64, layers=2, heads=2)]))
    jbatch = {"caption_ids": jnp.asarray(ids.copy())}
    p = perturb(jm.init(jax.random.PRNGKey(0), jbatch, rng=None)["params"], 15)
    m = GeneralConditioner([FrozenCLIPEmbedder(width=64, layers=2, heads=2, device=CPU)])
    load_into(m, p)
    assert not any(q.requires_grad for q in m.parameters())  # frozen embedder

    want = jm.apply({"params": p}, jbatch, rng=None)
    got = m({"caption_ids": torch.tensor(ids)})
    assert set(got) == set(want) == {"crossattn"}
    assert rel_err(got["crossattn"].numpy(), want["crossattn"]) < 1e-5
    zero = m({"caption_ids": torch.tensor(ids)}, force_zero_embeddings=("caption",))
    assert not zero["crossattn"].any()
    with pytest.raises(NotImplementedError, match="ucg_rate"):  # UCG draws are not ported
        FrozenCLIPEmbedder(ucg_rate=0.1, width=64, layers=1, heads=2, device=CPU)
