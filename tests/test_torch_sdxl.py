"""The SDXL path of neurosis_tpu_torch against the JAX package on the CPU at
tiny sizes: the open_clip text tower and its embedder, the CLIP-L embedder's
layer selection, the size embedder, the five-embedder conditioner, the UNet
with the ADM label embedding, and one whole SDXL-layout train step.

Parameters come from the JAX init (perturbed so zero-init layers count), move
through jax_params_to_state_dict and load with strict=True; inputs are seeded
numpy, copied into both frameworks. fp32 throughout, so the comparisons hold
the algorithm: towers and embedders within 1e-5 of the largest value, the
UNet forward 1e-4 and its grads 2e-4 (~40 layers of reordered fp32 sums); the
train step's loss and grad norm 1e-5 relative, each grad 2e-4 of its own
largest value (or of 1e-3 of the largest grad anywhere, for tensors whose
true grad is ~0), each updated parameter 1e-5, as tests/test_torch_engine.py.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import check_grads, grads_by_key, load_into, one_torch_thread, perturb, rel_err, t  # noqa: E402,F401

CPU = "cpu"
TINY_CLIP = dict(width=64, layers=2, heads=2)
TINY_BIGG = dict(width=64, layers=2, heads=4)
# SDXL's layout at tiny widths: linear transformer projections, head channels
# given, per-level depths, the sequential label embedding of a
# (64 pooled + 3 x 2 x 16 size features) = 160-wide vector
TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=[2],
                 channel_mult=[1, 2], num_head_channels=16, transformer_depth=[1, 2], context_dim=128,
                 use_linear_in_transformer=True, num_classes="sequential", adm_in_channels=160,
                 use_checkpoint=True)
SIZE_KEYS = ("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple")
NUM_IDX = 50


def _token_ids(rng, b):
    ids = rng.randint(1, 49000, size=(b, 77)).astype(np.int64)
    ids[:, 0] = 49406
    for i, e in enumerate(rng.randint(5, 77, size=b)):
        ids[i, e:] = 49407  # EOS, the largest id, then padding
    return ids


def _batch(rng, b=2):
    batch = {"caption_ids": _token_ids(rng, b), "latents": rng.randn(b, 16, 16, 4).astype(np.float32)}
    batch["original_size_as_tuple"] = rng.randint(256, 2048, size=(b, 2)).astype(np.float32)
    batch["crop_coords_top_left"] = rng.randint(0, 256, size=(b, 2)).astype(np.float32)
    batch["target_size_as_tuple"] = np.full((b, 2), 1024, np.float32)
    return batch


def _to_jax(batch):
    return {k: jnp.asarray(v.copy()) for k, v in batch.items()}


def _to_torch(batch):
    return {k: torch.tensor(v.copy()) for k, v in batch.items()}


def test_openclip_text_tower():
    from neurosis_tpu.models.text_encoder.clip import OpenCLIPTextTower as JTower
    from neurosis_tpu_torch.models.text_encoder.clip import OpenCLIPTextTower

    ids = _token_ids(np.random.RandomState(0), 2)
    jm = JTower(**TINY_BIGG)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 1)
    m = OpenCLIPTextTower(**TINY_BIGG, device=CPU)
    load_into(m, p)

    want = jm.apply({"params": p}, jnp.asarray(ids.copy()))
    got = m(torch.tensor(ids))
    assert set(got) == set(want) == {"penultimate", "last", "last_ln", "pooled"}
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert rel_err(got[key].detach().numpy(), want[key]) < 1e-5, key


def test_openclip_fused_qkv_split_round_trips():
    """An open_clip state dict (fused in_proj) splits into the tower's keys,
    loads with strict=True, computes what nn.MultiheadAttention computes, and
    the tower's q/k/v put back together are the fused tensors."""
    from neurosis_tpu_torch.models.text_encoder.clip import OpenCLIPTextTower, split_openclip_qkv

    width, heads, layers = 32, 4, 2
    m = OpenCLIPTextTower(vocab_size=100, width=width, layers=layers, heads=heads, max_positions=16, device=CPU)
    g = torch.Generator().manual_seed(3)
    fused = {}
    for key, val in m.state_dict().items():
        if ".attn.q_proj." in key:
            base, suffix = key.split("attn.q_proj.")
            fused[f"{base}attn.in_proj_{suffix}"] = 0.2 * torch.randn(3 * width, *val.shape[1:], generator=g)
        elif ".attn.k_proj." not in key and ".attn.v_proj." not in key:
            fused[key] = val + 0.05 * torch.randn(val.shape, generator=g)
    m.load_state_dict(split_openclip_qkv(fused), strict=True)

    sd = m.state_dict()
    for key, val in fused.items():
        if "in_proj_" in key:
            base, suffix = key.split("attn.in_proj_")
            back = torch.cat([sd[f"{base}attn.{n}_proj.{suffix}"] for n in "qkv"], dim=0)
            assert torch.equal(back, val), key

    # block 0's attention against torch's fused-qkv MultiheadAttention
    mha = torch.nn.MultiheadAttention(width, heads, batch_first=True)
    mha.load_state_dict({"in_proj_weight": fused["transformer.resblocks.0.attn.in_proj_weight"],
                         "in_proj_bias": fused["transformer.resblocks.0.attn.in_proj_bias"],
                         "out_proj.weight": fused["transformer.resblocks.0.attn.out_proj.weight"],
                         "out_proj.bias": fused["transformer.resblocks.0.attn.out_proj.bias"]})
    x = torch.randn(2, 16, width, generator=g)
    mask = torch.full((16, 16), float("-inf")).triu_(1)
    want = mha(x, x, x, need_weights=False, attn_mask=mask)[0]
    got = m.transformer.resblocks[0].attn(x)
    assert rel_err(got.detach().numpy(), want.detach().numpy()) < 1e-5


@pytest.mark.parametrize("layer", ["last", "penultimate"])
@pytest.mark.parametrize("legacy", [False, True])
def test_openclip_embedder(layer, legacy):
    from neurosis_tpu.modules.encoders.embedding import FrozenOpenCLIPEmbedder2 as JEmb
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenOpenCLIPEmbedder2

    ids = _token_ids(np.random.RandomState(2), 2)
    cfg = dict(layer=layer, legacy=legacy, always_return_pooled=True, **TINY_BIGG)
    jm = JEmb(**cfg)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 3)
    m = FrozenOpenCLIPEmbedder2(**cfg, device=CPU)
    load_into(m, p)
    assert not any(q.requires_grad for q in m.parameters())

    want = jm.apply({"params": p}, jnp.asarray(ids.copy()))
    got = m(torch.tensor(ids))
    assert len(got) == len(want) == (1 if legacy else 2)  # legacy never returns the pooled vector
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert rel_err(g_.numpy(), w_) < 1e-5


@pytest.mark.parametrize("layer,layer_idx,layers", [("hidden", 1, 2), ("hidden", -1, 3), ("penultimate", None, 12),
                                                    ("pooled", None, 2), ("last", None, 2)])
def test_clip_embedder_layers(layer, layer_idx, layers):
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder

    ids = _token_ids(np.random.RandomState(4), 2)
    cfg = dict(layer=layer, layer_idx=layer_idx, width=32, layers=layers, heads=2)
    jm = JEmb(**cfg)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 5)
    m = FrozenCLIPEmbedder(**cfg, device=CPU)
    load_into(m, p)

    want = jm.apply({"params": p}, jnp.asarray(ids.copy()))
    got = m(torch.tensor(ids))
    assert len(got) == len(want) == 1
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape
        assert rel_err(g_.numpy(), w_) < 1e-5


def test_embedders_refuse_what_is_not_ported():
    from neurosis_tpu_torch.modules.encoders.embedding import (
        ConcatTimestepEmbedderND,
        FrozenCLIPEmbedder,
        FrozenOpenCLIPEmbedder2,
    )

    with pytest.raises(ValueError, match="layer_idx"):
        FrozenCLIPEmbedder(layer="hidden", width=32, layers=1, heads=2, device=CPU)
    assert ConcatTimestepEmbedderND(ucg_rate=0.1).ucg_rate == 0.1  # UCG is ported
    # ids are [B, 77] or, for extended prompts, [B, chunks, 77]; no other rank
    for m in (FrozenCLIPEmbedder(width=32, layers=1, heads=2, device=CPU),
              FrozenOpenCLIPEmbedder2(width=32, layers=1, heads=2, device=CPU)):
        assert m(torch.zeros(2, 3, 77, dtype=torch.long))[0].shape[:2] == (2, 3 * 77)
        with pytest.raises(ValueError, match="chunks"):
            m(torch.zeros(2, 3, 1, 77, dtype=torch.long))


def test_concat_timestep_embedder():
    from neurosis_tpu.modules.encoders.embedding import ConcatTimestepEmbedderND as JEmb
    from neurosis_tpu_torch.modules.encoders.embedding import ConcatTimestepEmbedderND

    x = np.random.RandomState(6).randint(0, 2048, size=(3, 2)).astype(np.float32)
    (want,) = JEmb(outdim=256, input_key="original_size_as_tuple").apply({}, jnp.asarray(x.copy()))
    m = ConcatTimestepEmbedderND(outdim=256, input_key="original_size_as_tuple")
    assert m.token_key() is None and not list(m.parameters())
    (got,) = m(torch.tensor(x))
    assert got.shape == (3, 512)
    # cos and sin of arguments up to 2048 in fp32: the argument's rounding (1e-4) bounds the error
    assert float(np.abs(got.numpy() - np.asarray(want)).max()) < 5e-4
    (row,) = m(torch.tensor(x[:, 0]))  # a [B] tensor is one scalar a row
    assert torch.equal(row, got[:, :256])


def _conditioners(jbatch, seed):
    from neurosis_tpu.modules.encoders import embedding as je
    from neurosis_tpu_torch.modules.encoders import embedding as te

    jembs = [je.FrozenCLIPEmbedder(layer="hidden", layer_idx=1, **TINY_CLIP),
             je.FrozenOpenCLIPEmbedder2(layer="penultimate", always_return_pooled=True, legacy=False, **TINY_BIGG)]
    tembs = [te.FrozenCLIPEmbedder(layer="hidden", layer_idx=1, **TINY_CLIP, device=CPU),
             te.FrozenOpenCLIPEmbedder2(layer="penultimate", always_return_pooled=True, legacy=False, **TINY_BIGG,
                                        device=CPU)]
    for key in SIZE_KEYS:
        jembs.append(je.ConcatTimestepEmbedderND(outdim=16, input_key=key))
        tembs.append(te.ConcatTimestepEmbedderND(outdim=16, input_key=key))
    jcond = je.GeneralConditioner(embedders=je.with_embedder_names(jembs))
    p_cond = perturb(jcond.init(jax.random.PRNGKey(1), jbatch, rng=None)["params"], seed)
    tcond = te.GeneralConditioner(tembs)
    load_into(tcond, p_cond)
    return jcond, p_cond, tcond


def test_five_embedder_conditioner():
    batch = _batch(np.random.RandomState(7))
    jbatch = _to_jax(batch)
    jcond, p_cond, tcond = _conditioners(jbatch, 8)
    assert not any(q.requires_grad for q in tcond.parameters())

    want = jcond.apply({"params": p_cond}, jbatch, rng=None)
    got = tcond(_to_torch(batch))
    assert set(got) == set(want) == {"crossattn", "vector"}
    assert got["crossattn"].shape == (2, 77, 64 + 64)  # CLIP-L hidden ⊕ bigG penultimate
    assert got["vector"].shape == (2, 64 + 3 * 2 * 16)  # bigG pooled ⊕ three size embeddings
    assert rel_err(got["crossattn"].numpy(), want["crossattn"]) < 1e-5
    assert float(np.abs(got["vector"].numpy() - np.asarray(want["vector"])).max()) < 5e-4
    zero = tcond(_to_torch(batch), force_zero_embeddings=("caption",))
    assert not zero["crossattn"].any() and not zero["vector"][:, :64].any() and zero["vector"][:, 64:].any()


@pytest.mark.parametrize("force_uc,force_c", [((), ()), (("caption",), ()), (("original_size_as_tuple",),
                                                                              ("crop_coords_top_left",))])
def test_get_unconditional_conditioning(force_uc, force_c):
    """(cond, uncond) of the five-embedder conditioner as JAX's: both text
    embedders read the empty prompt's ids (one row, broadcast to the batch),
    the size embedders keep their values; force_uc_zero_embeddings and
    force_cond_zero_embeddings zero their embedders' outputs on one side."""
    batch = _batch(np.random.RandomState(12))
    batch["uncond_ids"] = _token_ids(np.random.RandomState(13), 1)
    jbatch = _to_jax(batch)
    jcond, p_cond, tcond = _conditioners(jbatch, 14)
    want_c, want_uc = jcond.get_unconditional_conditioning({"params": p_cond}, jbatch,
                                                           force_uc_zero_embeddings=force_uc,
                                                           force_cond_zero_embeddings=force_c)
    got_c, got_uc = tcond.get_unconditional_conditioning(_to_torch(batch), force_uc_zero_embeddings=force_uc,
                                                         force_cond_zero_embeddings=force_c)
    for got, want in ((got_c, want_c), (got_uc, want_uc)):
        assert set(got) == set(want) == {"crossattn", "vector"}
        assert rel_err(got["crossattn"].numpy(), want["crossattn"]) < 1e-5
        assert float(np.abs(got["vector"].numpy() - np.asarray(want["vector"])).max()) < 5e-4
    # the two rows of uncond's crossattn are the empty prompt's, the same row twice
    assert torch.equal(got_uc["crossattn"][0], got_uc["crossattn"][1])
    assert not torch.equal(got_uc["vector"][0], got_uc["vector"][1])  # the sizes differ


def test_unet_sequential_label_embedding():
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu_torch.models.unet import UNetModel

    rng = np.random.RandomState(9)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ts = np.array([3, 41], np.int32)
    ctx = rng.randn(2, 77, 128).astype(np.float32)
    y = rng.randn(2, 160).astype(np.float32)
    jm = JUNet(**TINY_UNET)
    jx, jt, jc, jy = (jnp.asarray(a.copy()) for a in (x, ts, ctx, y))
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, jt, jc, jy)["params"], 10)
    m = UNetModel(**TINY_UNET, device=CPU)
    load_into(m, p)
    assert {"label_emb.0.0.weight", "label_emb.0.2.bias"} <= set(m.state_dict())

    gp, gy = jax.jit(jax.grad(lambda p_, y_: jnp.sum(jm.apply({"params": p_}, jx, jt, jc, y_) ** 2),
                              argnums=(0, 1)))(p, jy)
    ty = t(y, requires_grad=True)
    out = m(t(x), torch.tensor(ts), t(ctx), ty)
    assert rel_err(out.detach().numpy(), jax.jit(jm.apply)({"params": p}, jx, jt, jc, jy)) < 1e-4
    (out**2).sum().backward()
    check_grads(m, gp, 2e-4)
    assert rel_err(ty.grad.numpy(), gy) < 2e-4

    with pytest.raises(ValueError, match="iff num_classes"):
        m(t(x), torch.tensor(ts), t(ctx))
    plain = dict(TINY_UNET, num_classes=None, adm_in_channels=None)
    with pytest.raises(ValueError, match="iff num_classes"):
        UNetModel(**plain, device=CPU)(t(x), torch.tensor(ts), t(ctx), t(y))
    with pytest.raises(ValueError, match="num_classes"):  # the other forms are held in test_torch_unet_variants.py
        UNetModel(**dict(TINY_UNET, num_classes="ordinal"), device=CPU)
    with pytest.raises(ValueError, match="adm_in_channels"):
        UNetModel(**dict(TINY_UNET, adm_in_channels=None), device=CPU)


def test_sdxl_train_step_matches_jax():
    """One DiffusionEngine.train_step in SDXL's layout (five embedders,
    crossattn and vector conditioning, the label embedding, eps loss,
    Adafactor with relative_step and warmup_init, no EMA) against the JAX
    components composed into the same step, with explicit t and noise."""
    import optax

    from neurosis_tpu.diffusion.denoiser import DiscreteDenoiser as JDenoiser
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu.diffusion.loss import StandardDiffusionLoss as JLoss
    from neurosis_tpu.diffusion.preconditioning import EpsPreconditioning as JPre
    from neurosis_tpu.diffusion.sigma_generators import DiscreteSigmaGenerator as JSigma
    from neurosis_tpu.diffusion.weighting import EpsWeighting as JWeight
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu.optimizers.adafactor import Adafactor as JAdafactor
    from neurosis_tpu.optimizers.stacked import stacked_global_norm
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    rng = np.random.RandomState(11)
    batch = _batch(rng)
    ts, noise = np.array([0.2, 0.75], np.float32), rng.randn(2, 16, 16, 4).astype(np.float32)
    jbatch = _to_jax(batch)
    jcond, p_cond, tcond = _conditioners(jbatch, 12)
    cond = jcond.apply({"params": p_cond}, jbatch, rng=None)
    junet = JUNet(**TINY_UNET)
    p_unet = perturb(junet.init(jax.random.PRNGKey(0), jbatch["latents"], jnp.zeros((2,)), cond["crossattn"],
                                cond["vector"])["params"], 13)

    jdisc = JDisc()
    jloss_fn = JLoss(JSigma(jdisc, NUM_IDX), JWeight())
    jdenoiser = JDenoiser(JPre(), NUM_IDX, jdisc)
    tx = JAdafactor(scale_parameter=True, relative_step=True, warmup_init=True)

    def jloss(params, t_, noise_):
        # engine.loss (trainer/engine.py:172-173: the net takes y = cond['vector']) with the given t and noise
        c = jcond.apply({"params": p_cond}, jbatch, rng=None)
        latents = jbatch["latents"]
        sig = jloss_fn.sigma_generator(latents.shape[0], t_)
        z = latents + sig[:, None, None, None] * noise_

        def net(x, c_noise, c_):
            return junet.apply({"params": params}, x, c_noise, c_.get("crossattn"), c_.get("vector"),
                               deterministic=False)

        d = jdenoiser(net, z, sig, c, "D")
        return jloss_fn.get_loss(d, latents, jloss_fn.loss_weighting(sig)).mean()

    @jax.jit
    def jstep(params, opt_state, t_, noise_):
        val, grads = jax.value_and_grad(jloss)(params, t_, noise_)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), val, grads, stacked_global_norm(grads)

    jparams = jax.tree_util.tree_map(jnp.asarray, p_unet)
    jparams, jval, jgrads, jnorm = jstep(jparams, tx.init(jparams), jnp.asarray(ts.copy()), jnp.asarray(noise.copy()))

    unet = UNetModel(**TINY_UNET, device=CPU)
    load_into(unet, p_unet)
    disc = LegacyDDPMDiscretization()
    engine = DiffusionEngine(
        model=unet, denoiser=DiscreteDenoiser(EpsPreconditioning(), NUM_IDX, disc, device=CPU),
        loss_fn=StandardDiffusionLoss(DiscreteSigmaGenerator(disc, NUM_IDX, device=CPU), EpsWeighting()),
        conditioner=tcond, scale_factor=0.13025, use_ema=False, device=CPU,
        optimizer=lambda ps: Adafactor(ps, scale_parameter=True, relative_step=True, warmup_init=True))
    state = engine.init(seed=0)
    assert state.ema is None
    assert len(engine.trainable_parameters()) == len(list(unet.parameters()))  # both towers are frozen
    state, metrics = engine.train_step(state, _to_torch(batch), t=torch.tensor(ts.copy()),
                                       noise=torch.tensor(noise.copy()))
    np.testing.assert_allclose(float(metrics["loss"]), float(jval), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-5)
    want_g, want_p = grads_by_key(jgrads), grads_by_key(jparams)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want_g.values())
    assert float(np.abs(want_g["label_emb.0.0.weight"]).max()) > floor  # the vector conditioning takes part
    for n, prm in unet.named_parameters():
        scale = max(float(np.abs(want_g[n]).max()), floor)
        assert float(np.abs(prm.grad.numpy() - want_g[n]).max()) / scale < 2e-4, n
        assert rel_err(prm.detach().numpy(), want_p[n]) < 1e-5, n
