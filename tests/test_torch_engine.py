"""The port's whole slice on the CPU: two DiffusionEngine.train_steps at the
sd15-tiny config's dims (UNet 32 channels, [1, 2], 2 heads, context 64;
CLIP 64 wide, 2 layers; 50-entry σ tables; Adafactor with relative_step,
with and without the config's warmup_init; EMA on) against the JAX package's components composed into the
same step with the same explicit t and noise.

fp32 throughout, so the comparison holds the algorithm: loss and grad norm
to 1e-5 relative; each grad to 2e-4 of its own largest value (or of 1e-3 of
the largest grad anywhere, for tensors whose true grad is ~0: a conv bias
right before a one-channel-per-group GroupNorm); each parameter and EMA
shadow to 1e-5 of its largest value. Without warmup_init the step size is
1e-2: a ~0 grad's first Adafactor update is its sign, which is noise, so
parameters and shadows are compared where the grad is real, and there the
update of each matrix-shaped parameter is held to 1e-3 of its largest
element (at warmup_init's 1e-6 an update is below the fp32 resolution of
the parameter it moves).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import grads_by_key, load_into, one_torch_thread, perturb, rel_err  # noqa: E402,F401

TINY_UNET = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1,
                 attention_resolutions=[2], channel_mult=[1, 2], num_heads=2, context_dim=64,
                 use_checkpoint=True)
TINY_CLIP = dict(width=64, layers=2, heads=2)
NUM_IDX = 50
TINY_VAE = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=32, z_channels=4,
                double_z=True, in_channels=3, out_ch=3, dropout=0.0)
EMA_DECAY = 0.9999


def _batch(rng, b=2):
    ids = rng.randint(1, 49000, size=(b, 77)).astype(np.int64)
    ids[:, 0] = 49406
    for i, e in enumerate(rng.randint(5, 77, size=b)):
        ids[i, e:] = 49407
    return {"latents": rng.randn(b, 16, 16, 4).astype(np.float32), "caption_ids": ids}


def _jax_step(junet, jcond, cond_params, warmup_init):
    import optax

    from neurosis_tpu.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu.diffusion.weighting import EpsWeighting
    from neurosis_tpu.modules.ema import ema_update
    from neurosis_tpu.optimizers.adafactor import Adafactor
    from neurosis_tpu.optimizers.stacked import stacked_global_norm

    disc = LegacyDDPMDiscretization()
    loss_fn = StandardDiffusionLoss(DiscreteSigmaGenerator(disc, NUM_IDX), EpsWeighting())
    denoiser = DiscreteDenoiser(EpsPreconditioning(), NUM_IDX, disc)
    tx = Adafactor(scale_parameter=True, relative_step=True, warmup_init=warmup_init)

    def loss(params, batch, t, noise):
        # engine.loss with the loss's t/noise draws (loss.py:93-97) replaced by the given ones
        cond = jcond.apply({"params": cond_params}, batch, rng=None)
        latents = batch["latents"]
        sig = loss_fn.sigma_generator(latents.shape[0], t)
        z = latents + sig[:, None, None, None] * noise

        def net(x, c_noise, c):
            return junet.apply({"params": params}, x, c_noise, c.get("crossattn"), deterministic=False)

        d = denoiser(net, z, sig, cond, "D")
        return loss_fn.get_loss(d, latents, loss_fn.loss_weighting(sig)).mean()

    @jax.jit
    def step(params, opt_state, ema, batch, t, noise):
        val, grads = jax.value_and_grad(loss)(params, batch, t, noise)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, ema_update(ema, params, EMA_DECAY), val, grads, stacked_global_norm(grads)

    return tx, step


def _torch_engine(p_unet, p_cond, warmup_init=True, p_vae=None):
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, GeneralConditioner
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    unet = UNetModel(**TINY_UNET, device="cpu")
    load_into(unet, p_unet)
    cond = GeneralConditioner([FrozenCLIPEmbedder(**TINY_CLIP, device="cpu")])
    load_into(cond, p_cond)
    first_stage = None
    if p_vae is not None:
        from neurosis_tpu_torch.models.autoencoder import AutoencoderKL

        first_stage = AutoencoderKL(TINY_VAE, embed_dim=4, device="cpu")
        load_into(first_stage, p_vae)
    disc = LegacyDDPMDiscretization()
    return DiffusionEngine(
        model=unet,
        first_stage=first_stage,
        denoiser=DiscreteDenoiser(EpsPreconditioning(), NUM_IDX, disc, device="cpu"),
        loss_fn=StandardDiffusionLoss(DiscreteSigmaGenerator(disc, NUM_IDX, device="cpu"), EpsWeighting()),
        conditioner=cond,
        optimizer=lambda ps: Adafactor(ps, scale_parameter=True, relative_step=True, warmup_init=warmup_init),
        use_ema=True,
        ema_decay=EMA_DECAY,
        device="cpu",
    )


@pytest.mark.parametrize("warmup_init", [True, False])
def test_two_train_steps_match_jax(warmup_init):
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu.modules.ema import ema_init
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names

    rng = np.random.RandomState(0)
    batch = _batch(rng)
    draws = [(np.array(ts, np.float32), rng.randn(2, 16, 16, 4).astype(np.float32))
             for ts in ([0.1, 0.7], [0.45, 0.02])]
    jbatch = {k: jnp.asarray(v.copy()) for k, v in batch.items()}

    junet = JUNet(**TINY_UNET)
    jcond = JCond(embedders=with_embedder_names([JEmb(**TINY_CLIP)]))
    p_cond = perturb(jcond.init(jax.random.PRNGKey(1), jbatch, rng=None)["params"], 2)
    ctx = jcond.apply({"params": p_cond}, jbatch, rng=None)["crossattn"]
    p_unet = perturb(junet.init(jax.random.PRNGKey(0), jbatch["latents"], jnp.zeros((2,)), ctx)["params"], 3)

    tx, jstep = _jax_step(junet, jcond, p_cond, warmup_init)
    jparams = jax.tree_util.tree_map(jnp.asarray, p_unet)
    jopt, jema = tx.init(jparams), ema_init(jparams)

    engine = _torch_engine(p_unet, p_cond, warmup_init)
    state = engine.init(seed=0)
    names = [n for n, _ in engine.model.named_parameters()]
    assert len(engine.trainable_parameters()) == len(names)  # the frozen CLIP trains nothing
    tbatch = {k: torch.tensor(v.copy()) for k, v in batch.items()}
    prev, jprev = {n: p.detach().clone() for n, p in engine.model.named_parameters()}, grads_by_key(jparams)

    for i, (ts, noise) in enumerate(draws):
        jparams, jopt, jema, jloss, jgrads, jnorm = jstep(
            jparams, jopt, jema, jbatch, jnp.asarray(ts.copy()), jnp.asarray(noise.copy()))
        state, metrics = engine.train_step(state, tbatch, t=torch.tensor(ts.copy()), noise=torch.tensor(noise.copy()))
        assert state.step == i + 1
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-5)

        want_g, want_p, want_ema = grads_by_key(jgrads), grads_by_key(jparams), grads_by_key(jema.params)
        floor = 1e-3 * max(float(np.abs(g).max()) for g in want_g.values())
        params = dict(engine.model.named_parameters())
        for n, shadow in zip(names, state.ema.params):
            g = params[n].grad.numpy()
            scale = max(float(np.abs(want_g[n]).max()), floor)
            assert float(np.abs(g - want_g[n]).max()) / scale < 2e-4, (i, n, "grad")
            p = params[n].detach()
            real_grad = float(np.abs(want_g[n]).max()) >= floor
            if warmup_init or real_grad:  # a ~0 grad's sign is noise, and at 1e-2 so is its update
                assert rel_err(p.numpy(), want_p[n]) < 1e-5, (i, n, "param")
                assert rel_err(shadow.numpy(), want_ema[n]) < 1e-5, (i, n, "ema")
            if not warmup_init and p.ndim >= 2 and real_grad:
                assert rel_err((p - prev[n]).numpy(), want_p[n] - jprev[n]) < 1e-3, (i, n, "update")
        prev, jprev = {n: p.detach().clone() for n, p in params.items()}, want_p


def test_train_step_draws_from_the_state_generator():
    """Without explicit t and noise, a step draws them from the run's
    generator: two engines from one seed take identical steps."""
    rng = np.random.RandomState(5)
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names

    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v.copy()) for k, v in batch.items()}
    jcond = JCond(embedders=with_embedder_names([JEmb(**TINY_CLIP)]))
    p_cond = perturb(jcond.init(jax.random.PRNGKey(1), jbatch, rng=None)["params"], 6)
    ctx = jcond.apply({"params": p_cond}, jbatch, rng=None)["crossattn"]
    p_unet = perturb(JUNet(**TINY_UNET).init(jax.random.PRNGKey(0), jbatch["latents"], jnp.zeros((2,)), ctx)["params"], 7)

    losses = []
    for _ in range(2):
        engine = _torch_engine(p_unet, p_cond)
        state = engine.init(seed=11)
        tbatch = {k: torch.tensor(v.copy()) for k, v in batch.items()}
        state, m = engine.train_step(state, tbatch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]) and np.isfinite(float(m["grad_norm"]))
    assert losses[0] == losses[1]


def test_images_in_train_step_matches_jax():
    """One step from uint8 images: the frozen encode (JAX AutoencoderKL.encode,
    DiagonalGaussian, scale 0.18215, as engine.encode_first_stage) feeds the
    same step as above, with explicit t, noise and posterior noise."""
    from neurosis_tpu.models.autoencoder import AutoencoderKL as JAE
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu.modules.distributions import DiagonalGaussian
    from neurosis_tpu.modules.ema import ema_init
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names
    from neurosis_tpu.ops.dequant import dequant_image

    rng = np.random.RandomState(9)
    batch = _batch(rng)
    images = rng.randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    post_eps = rng.randn(2, 16, 16, 4).astype(np.float32)
    ts, noise = np.array([0.3, 0.85], np.float32), rng.randn(2, 16, 16, 4).astype(np.float32)

    jae = JAE(ddconfig=TINY_VAE, embed_dim=4)
    jimg = dequant_image(jnp.asarray(images.copy()))
    p_vae = perturb(jae.init(jax.random.PRNGKey(4), jimg)["params"], 5)
    dist = DiagonalGaussian.from_moments(jae.apply({"params": p_vae}, jimg, method="encode"))
    jlatents = 0.18215 * (dist.mean + dist.std * jnp.asarray(post_eps.copy()))
    jbatch = {"latents": jlatents, "caption_ids": jnp.asarray(batch["caption_ids"].copy())}

    junet = JUNet(**TINY_UNET)
    jcond = JCond(embedders=with_embedder_names([JEmb(**TINY_CLIP)]))
    p_cond = perturb(jcond.init(jax.random.PRNGKey(1), jbatch, rng=None)["params"], 6)
    ctx = jcond.apply({"params": p_cond}, jbatch, rng=None)["crossattn"]
    p_unet = perturb(junet.init(jax.random.PRNGKey(0), jlatents, jnp.zeros((2,)), ctx)["params"], 7)
    tx, jstep = _jax_step(junet, jcond, p_cond, True)
    jparams = jax.tree_util.tree_map(jnp.asarray, p_unet)
    jparams, _, _, jloss, jgrads, jnorm = jstep(jparams, tx.init(jparams), ema_init(jparams), jbatch,
                                                jnp.asarray(ts.copy()), jnp.asarray(noise.copy()))

    engine = _torch_engine(p_unet, p_cond, p_vae=p_vae)
    assert not any(p.requires_grad for p in engine.first_stage.parameters())
    state = engine.init(seed=0)
    tbatch = {"image": torch.tensor(images.copy()), "caption_ids": torch.tensor(batch["caption_ids"].copy())}
    latents = engine.encode_first_stage(tbatch["image"], posterior_noise=torch.tensor(post_eps.copy()))
    assert rel_err(latents.numpy(), jlatents) < 1e-5
    state, metrics = engine.train_step(state, tbatch, t=torch.tensor(ts.copy()), noise=torch.tensor(noise.copy()),
                                       posterior_noise=torch.tensor(post_eps.copy()))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-5)
    want_g, want_p = grads_by_key(jgrads), grads_by_key(jparams)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want_g.values())
    for n, prm in engine.model.named_parameters():
        scale = max(float(np.abs(want_g[n]).max()), floor)
        assert float(np.abs(prm.grad.numpy() - want_g[n]).max()) / scale < 2e-4, n
        assert rel_err(prm.detach().numpy(), want_p[n]) < 1e-5, n
