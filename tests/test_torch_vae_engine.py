"""The port's AutoencodingEngine against the JAX package's on the CPU: four
scheduled steps (g, d, g, d) at vae-tiny widths (ch 32, [1, 2], 1 block,
64 px, disc_n_layers 1, LPIPS alex at weight 0.1, disc_start 1, kl_weight
1e-6, AdamW at 1e-4 with optax's defaults), from the same weights and
uint8 images, with the posterior mode (sample_posterior=False) so that no
random draw differs between the frameworks.

fp32 throughout. Each step's logged losses within 1e-5 relative (or 1e-6
absolute: the mean logits sum terms of both signs to near 0) and the
BatchNorm running statistics within 1e-5. Grads are held to a share of
their own largest value (or of 1e-3 of the largest grad anywhere, for a
conv bias before a GroupNorm). The two reconstructions differ by fp32 noise
(~1e-5), and once the GAN term is on, that noise flips a few of the
discriminator's LeakyReLU and hinge kinks, which moves some grads by a
discrete amount. So the D steps' grads are held to JAX's grads at the
port's own reconstruction and the port's own discriminator weights
(identical inputs, 5e-4: the first D step moves a weight whose grad is fp32
noise by ±lr on either side, and the first conv bias' grad, which nearly
cancels through the BatchNorm, feels that), the first G step (gate closed)
to 5e-4 and the second (gate open) to 5e-3. AdamW's first steps
move each weight by about ±lr whatever the grad's size, so a grad near 0
moves it by the sign of fp32 noise: each framework's update is held to
2e-2·lr (5e-2·lr in the last step) where the grad is at least 1e-2 (first
step) or 1e-1 (later steps) of the scale its grad is held to, and to
2.1·lr everywhere.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import grads_by_key, load_into, one_torch_thread, perturb, to_np  # noqa: E402,F401

CPU = "cpu"
TINY_DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=64, z_channels=2,
               dropout=0.0)
LOSS_CFG = dict(perceptual_weight=0.1, disc_start=1, disc_n_layers=1, disc_weight=0.5)
LR = 1e-4
KL_WEIGHT = 1e-6


def _jax_engine():
    import optax

    from neurosis_tpu.losses.vae_loss import AutoencoderLPIPSWithDiscr
    from neurosis_tpu.models.vae import Decoder, Encoder
    from neurosis_tpu.trainer.vae_engine import AutoencodingEngine

    return AutoencodingEngine(
        encoder=Encoder(**TINY_DD, double_z=True, in_channels=3), decoder=Decoder(**TINY_DD, out_ch=3),
        loss=AutoencoderLPIPSWithDiscr(**LOSS_CFG), g_optimizer=optax.adamw(LR), d_optimizer=optax.adamw(LR),
        kl_weight=KL_WEIGHT, disc_start=1, sample_posterior=False)


def _jax_grads(engine, state, batch, idx, recons=None):
    """The grads JAX's g_step / d_step take, through the engine's own
    forward and loss application; the D step's at ``recons`` if given."""
    from neurosis_tpu.ops.dequant import dequant_image

    x = dequant_image(batch["image"])
    g_grads, d_grads = _jitted_grads(engine)
    if idx == 0:
        return g_grads(state.params, state.batch_stats, x, state.step)
    if recons is None:
        _, recons, _ = engine.forward(state.params, x, None)
    return {"loss": d_grads(state.params["loss"], state.batch_stats, x, recons, state.step)}


_JITTED: dict = {}


def _jitted_grads(engine):
    """The G and D steps' grads as functions of the state's arrays, compiled
    once an engine (the engine kept alive beside them)."""
    if id(engine) not in _JITTED:
        @jax.jit
        def g_grads(all_params, batch_stats, x, step):
            def loss_fn(g):
                params = dict(all_params, **g)
                _, recons, reg_log, _ = engine.forward_with_stats(params, x, None, None, train=True)
                (loss, _), _ = engine._loss_apply(params["loss"], batch_stats, x, recons, step, 0)
                return jnp.mean(loss) + KL_WEIGHT * jnp.mean(reg_log["kl_loss"])

            return jax.grad(loss_fn)({k: all_params[k] for k in ("encoder", "decoder")})

        @jax.jit
        def d_grads(loss_params, batch_stats, x, recons, step):
            def d_loss_fn(lp):
                (d_loss, _), _ = engine._loss_apply(lp, batch_stats, x, jax.lax.stop_gradient(recons), step, 1)
                return d_loss

            return jax.grad(d_loss_fn)(loss_params)

        _JITTED[id(engine)] = (engine, g_grads, d_grads)
    return _JITTED[id(engine)][1:]


def _with_port_discr(loss_params, engine) -> dict:
    """JAX's loss tree with the discriminator's weights replaced by the
    port's, in JAX's layout."""
    from neurosis_tpu_torch.checkpoint.convert import flax_path_to_torch_key

    port = dict(engine.loss.discr.named_parameters())

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
            elif path and path[0] == "discr":
                w = port[flax_path_to_torch_key(path[1:] + (k,))].detach().numpy()
                if k == "kernel":
                    w = w.transpose(2, 3, 1, 0) if w.ndim == 4 else w.T
                out[k] = jnp.asarray(w.copy())
            else:
                out[k] = v
        return out

    return walk(loss_params, ())


def _torch_engine(params, batch_stats):
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderLPIPSWithDiscr
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.optimizers.adamw import adamw
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    enc = Encoder(**TINY_DD, double_z=True, in_channels=3, device=CPU)
    dec = Decoder(**TINY_DD, out_ch=3, device=CPU)
    loss = AutoencoderLPIPSWithDiscr(**LOSS_CFG, device=CPU)
    load_into(enc, params["encoder"])
    load_into(dec, params["decoder"])
    loss.load_state_dict({**jax_params_to_state_dict(to_np(params["loss"])),
                          **jax_params_to_state_dict(to_np(batch_stats))}, strict=True)
    return AutoencodingEngine(enc, dec, loss, g_optimizer=lambda ps: adamw(ps, LR),
                              d_optimizer=lambda ps: adamw(ps, LR), kl_weight=KL_WEIGHT, sample_posterior=False,
                              disc_start=1, device=CPU)


def _named(engine):
    """{key in the JAX tree's torch naming: parameter} of the trained modules."""
    out = {f"encoder.{k}": p for k, p in engine.encoder.named_parameters()}
    out.update({f"decoder.{k}": p for k, p in engine.decoder.named_parameters()})
    out.update({f"loss.discr.{k}": p for k, p in engine.loss.discr.named_parameters()})
    return out


def test_scheduled_g_and_d_steps_match_jax():
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.ops.dequant import dequant_image

    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    jbatch = {"image": jnp.asarray(images.copy())}
    tbatch = {"image": torch.tensor(images.copy())}

    jeng = _jax_engine()
    jstate = jeng.init(jax.random.PRNGKey(0), jbatch)
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, perturb(jstate.params, 1, 0.01)))
    teng = _torch_engine(to_np(jstate.params), jstate.batch_stats)
    tstate = teng.init(seed=0)
    g_step, d_step = jax.jit(jeng.g_step), jax.jit(jeng.d_step)
    named = _named(teng)

    # per step: grad tolerance, update mask (share of the grad's scale), update tolerance (in lr)
    tols = {0: (5e-4, 1e-2, 2e-2), 1: (5e-4, 1e-1, 2e-2), 2: (5e-3, 1e-1, 2e-2), 3: (5e-4, 1e-1, 5e-2)}
    for i in range(4):
        idx = jeng.train_step_schedule(i, int(jstate.step))
        assert idx == teng.train_step_schedule(i, tstate.step) == i % 2
        recons, at = None, jstate
        if idx == 1:
            with torch.no_grad():
                recons = jnp.asarray(teng.forward(dequant_image(tbatch["image"]))[1].numpy())
            at = dataclasses.replace(jstate, params=dict(jstate.params,
                                                         loss=_with_port_discr(jstate.params["loss"], teng)))
        want_g = grads_by_key(_jax_grads(jeng, at, jbatch, idx, recons))
        frozen = [k for k in want_g if k not in named]  # LPIPS: in JAX's loss tree, with zero grads
        assert all(not np.any(want_g.pop(k)) for k in frozen)
        tol_g, mask, tol_u = tols[i]
        prev = {k: p.detach().clone() for k, p in named.items()}
        jprev = grads_by_key(jstate.params)
        jstate, jlog = (g_step if idx == 0 else d_step)(jstate, jbatch)
        tstate, tlog = (teng.g_step if idx == 0 else teng.d_step)(tstate, tbatch)
        assert tstate.step == int(jstate.step) == i + 1

        assert set(tlog) == set(jlog)
        for k, v in jlog.items():
            np.testing.assert_allclose(float(tlog[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=(i, k))
        floor = 1e-3 * max(float(np.abs(g).max()) for g in want_g.values())
        want_p = grads_by_key(jstate.params)
        for k, g in want_g.items():
            got = named[k].grad.numpy()
            scale = max(float(np.abs(g).max()), floor)
            assert float(np.abs(got - g).max()) / scale < tol_g, (i, k, "grad")
            delta, jdelta = (named[k].detach() - prev[k]).numpy(), want_p[k] - jprev[k]
            real = np.abs(g) >= mask * scale
            assert float(np.abs(delta - jdelta)[real].max(initial=0.0)) <= tol_u * LR, (i, k, "update")
            assert float(np.abs(delta - jdelta).max()) <= 2.1 * LR, (i, k, "update bound")
        untouched = [k for k in named if k not in want_g]  # the other step's weights do not move
        assert all(torch.equal(named[k].detach(), prev[k]) for k in untouched), i
        for k, v in jax_params_to_state_dict(to_np(jstate.batch_stats), "loss.").items():
            np.testing.assert_allclose(teng.loss.get_buffer(k[len("loss."):]).numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=(i, k))


def test_fp32_pair_takes_the_fp32_flash_backward(monkeypatch):
    """configs/vae/vae.example.yaml as written has no precision key: fp32
    encoder and decoder. One generator and one discriminator step in fp32
    against JAX, watching the attention entry: the mid attention (1024
    tokens) of the encoder and of the decoder goes through the flash forward
    in both steps and through the flash backward, with fp32 tensors, in the
    generator step only. Logged losses within 1e-5 relative, as above."""
    import neurosis_tpu_torch.ops.flash_attention as fa

    calls = {"fwd": [], "bwd": []}
    fwd, bwd = fa.flash_fwd, fa.flash_bwd
    monkeypatch.setattr(fa, "flash_fwd", lambda qs, k, v: calls["fwd"].append(qs.dtype) or fwd(qs, k, v))
    monkeypatch.setattr(fa, "flash_bwd", lambda qs, *a: calls["bwd"].append((qs.dtype, a[2].dtype)) or bwd(qs, *a))

    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    jbatch, tbatch = {"image": jnp.asarray(images.copy())}, {"image": torch.tensor(images.copy())}
    jeng = _jax_engine()
    jstate = jeng.init(jax.random.PRNGKey(0), jbatch)
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, perturb(jstate.params, 4, 0.01)))
    teng = _torch_engine(to_np(jstate.params), jstate.batch_stats)
    assert all(p.dtype == torch.float32 for p in teng.g_parameters())
    tstate = teng.init(seed=0)

    jstate, jlog = jax.jit(jeng.g_step)(jstate, jbatch)
    tstate, tlog = teng.g_step(tstate, tbatch)
    assert calls == {"fwd": [torch.float32] * 2, "bwd": [(torch.float32, torch.float32)] * 2}
    for k, v in jlog.items():
        np.testing.assert_allclose(float(tlog[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    jstate, jlog = jax.jit(jeng.d_step)(jstate, jbatch)
    tstate, tlog = teng.d_step(tstate, tbatch)
    assert len(calls["fwd"]) == 4 and len(calls["bwd"]) == 2  # the D step's reconstruction runs without grad
    for k, v in jlog.items():
        np.testing.assert_allclose(float(tlog[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_sampled_posterior_draws_from_the_state_generator():
    """With sample_posterior, the g step's z comes from the run's generator
    (one seed, one step), or from an explicit posterior_noise."""
    rng = np.random.RandomState(2)
    jeng = _jax_engine()
    images = rng.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    jstate = jeng.init(jax.random.PRNGKey(0), {"image": jnp.asarray(images.copy())})
    params, stats = to_np(jstate.params), jstate.batch_stats
    batch = {"image": torch.tensor(images.copy())}

    totals = []
    for _ in range(2):
        eng = _torch_engine(params, stats)
        eng.sample_posterior = True
        _, log = eng.g_step(eng.init(seed=7), batch)
        totals.append(float(log["total"]))
    assert totals[0] == totals[1] and np.isfinite(totals[0])

    eng = _torch_engine(params, stats)
    eng.sample_posterior = True
    x = batch["image"].float() * (2 / 255) - 1
    eps = torch.randn(2, 32, 32, 2, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        z, _, _ = eng.forward(x, posterior_noise=eps)
        mean, logvar = eng.encoder(x).chunk(2, dim=-1)
    torch.testing.assert_close(z, mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps)
