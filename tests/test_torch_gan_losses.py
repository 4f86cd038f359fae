"""The port's sgm GAN losses (neurosis_tpu_torch/losses/discriminator_loss.py),
ActNorm, LatentLPIPS and the adaptive d_weight against the JAX package on
the CPU, at 32 px with the vgg LPIPS (seeded random trunk, the packaged
lin heads) and a 1-layer PatchGAN.

fp32: losses and logs within 1e-5, the grads of recons within 1e-4 (LPIPS'
conv stack sums in another order), the discriminator's grads within 5e-4
(the first conv bias' grad nearly cancels through the BatchNorm, as in
test_torch_losses.py), BatchNorm statistics within 1e-6, the adaptive
d_weight within 1e-5, ActNorm's init and forward within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, one_torch_thread, perturb, rel_err, t, to_np  # noqa: E402,F401

CPU = "cpu"
CFG = dict(disc_start=1, disc_num_layers=1, perceptual_weight=0.1, disc_weight=0.7, logvar_init=0.3)


def _images(seed: int, size: int = 32):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, size=(2, size, size, 3)).astype(np.float32)
    return x, (x + 0.4 * rng.randn(*x.shape)).astype(np.float32)


def _pair(vq: bool, **kw):
    from neurosis_tpu.losses import discriminator_loss as jd
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses import discriminator_loss as td

    name = "VQLPIPSWithDiscriminator" if vq else "GeneralLPIPSWithDiscriminator"
    cfg = dict(CFG, **kw)
    jm = getattr(jd, name)(**cfg)
    x, _ = _images(0)
    v = jax.jit(lambda k, a: jm.init(k, a, a, jnp.asarray(0), optimizer_idx=0))(jax.random.PRNGKey(0), jnp.asarray(x))
    p = perturb(v["params"], 1, 0.01)
    m = getattr(td, name)(**cfg, device=CPU)
    m.load_state_dict({**jax_params_to_state_dict(to_np(p)), **jax_params_to_state_dict(to_np(v["batch_stats"]))},
                      strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, p), v["batch_stats"], m


CASES = [  # (vq, optimizer_idx, learn_logvar, disc_loss, train)
    (False, 0, False, "hinge", True), (False, 0, True, "hinge", True), (False, 1, False, "vanilla", True),
    (True, 0, True, "hinge", True), (True, 1, False, "hinge", True), (False, 0, False, "hinge", False),
    (True, 1, False, "vanilla", False)]


@pytest.mark.parametrize("vq,idx,learn_logvar,disc_loss,train", CASES)
def test_sgm_gan_losses_match_jax(vq, idx, learn_logvar, disc_loss, train):
    """Both optimizer indices and both disc losses, with and without
    learn_logvar, the eval split (train=False: running statistics, gate
    open), and the regularizer's terms: regularization_weights' kl_loss, or
    the VQ loss's codebook term and perplexity."""
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict

    kw = dict(learn_logvar=learn_logvar, disc_loss=disc_loss)
    kw.update({"codebook_weight": 0.8} if vq else {"regularization_weights": {"kl_loss": 0.5}})
    jm, p, bs, m = _pair(vq, **kw)
    x, r = _images(2)
    reg = {"loss/vq": np.float32(0.37), "perplexity": np.float32(5.5)} if vq \
        else {"kl_loss": np.array([1.5, 2.5], np.float32)}
    split = "train" if train else "val"
    step = 0 if not train else 3  # the eval gate opens before disc_start

    def jloss(p_, rec):
        (loss, log), upd = jm.apply({"params": p_, "batch_stats": bs}, jnp.asarray(x), rec, jnp.asarray(step),
                                    optimizer_idx=idx, regularization_log={k: jnp.asarray(v) for k, v in reg.items()},
                                    split=split, train=train, mutable=["batch_stats"])
        return loss, (log, upd)

    (want, (jlog, upd)), (gp, gr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(r))
    tr = t(r, requires_grad=True)
    loss, log = m(t(x), tr, step, optimizer_idx=idx, regularization_log={k: t(v) for k, v in reg.items()},
                  split=split, train=train)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert set(log) == set(jlog)
    for k, val in jlog.items():
        np.testing.assert_allclose(float(log[k]), float(val), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, val in jax_params_to_state_dict(to_np(upd["batch_stats"])).items():
        np.testing.assert_allclose(m.get_buffer(k).numpy(), val.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    loss.backward()
    want_g = jax_params_to_state_dict(to_np(gp))
    if idx == 0:
        assert rel_err(tr.grad.numpy(), gr) < 1e-4
        if learn_logvar:
            assert rel_err(m.logvar.grad.numpy(), want_g["logvar"].numpy()) < 1e-5
        else:
            assert m.logvar.grad is None and not np.any(want_g["logvar"].numpy())
    else:
        for k, prm in m.discriminator.named_parameters():
            assert rel_err(prm.grad.numpy(), want_g[f"discriminator.{k}"].numpy()) < 5e-4, k


def test_adaptive_disc_weight_matches_jax_s_engine():
    """‖∂nll/∂w‖ / (‖∂g/∂w‖ + 1e-4) at the decoder's last conv, both grads
    taken on one graph, against JAX's ``_compute_adaptive_weight`` (two
    decoder backwards, the discriminator on its running statistics)."""
    import optax

    from neurosis_tpu.losses.discriminator_loss import GeneralLPIPSWithDiscriminator as JL
    from neurosis_tpu.models.vae import Decoder as JDec
    from neurosis_tpu.models.vae import Encoder as JEnc
    from neurosis_tpu.trainer.vae_engine import AutoencodingEngine as JEngine
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.discriminator_loss import GeneralLPIPSWithDiscriminator
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.ops.dequant import dequant_image
    from neurosis_tpu_torch.optimizers.adamw import adam
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    dd = dict(ch=32, ch_mult=[1], num_res_blocks=1, attn_resolutions=[], resolution=32, z_channels=4)
    cfg = dict(CFG, lpips_type="alex")  # the nll's LPIPS trunk: vgg is held above
    jeng = JEngine(encoder=JEnc(**dd), decoder=JDec(out_ch=3, **dd), loss=JL(**cfg), g_optimizer=optax.adam(1e-3),
                   d_optimizer=optax.adam(1e-3), sample_posterior=False, adaptive_disc_weight=True)
    images = np.random.RandomState(4).randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)
    jstate = jax.jit(jeng.init)(jax.random.PRNGKey(0), {"image": jnp.asarray(images.copy())})
    params = perturb(jstate.params, 5, 0.02)
    from neurosis_tpu.ops.dequant import dequant_image as jdequant

    want = jax.jit(lambda st, x: jeng._compute_adaptive_weight(st, x, None))(
        jstate.replace(params=jax.tree_util.tree_map(jnp.asarray, params)), jdequant(jnp.asarray(images.copy())))

    enc, dec = Encoder(**dd, device=CPU), Decoder(out_ch=3, **dd, device=CPU)
    loss = GeneralLPIPSWithDiscriminator(**cfg, device=CPU)
    load_into(enc, params["encoder"])
    load_into(dec, params["decoder"])
    loss.load_state_dict({**jax_params_to_state_dict(params["loss"]),
                          **jax_params_to_state_dict(to_np(jstate.batch_stats))}, strict=True)
    eng = AutoencodingEngine(enc, dec, loss, lambda ps: adam(ps, 1e-3), sample_posterior=False,
                             adaptive_disc_weight=True, device=CPU)
    x = dequant_image(torch.tensor(images))
    _, recons, _ = eng.forward(x)
    got = eng._adaptive_weight(x, recons)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(got) > 0 and not got.requires_grad


def test_actnorm_init_and_forward_match_jax():
    from neurosis_tpu.losses.patchgan import ActNorm as JAN
    from neurosis_tpu_torch.losses.patchgan import ActNorm

    rng = np.random.RandomState(6)
    x = (2.0 + 3.0 * rng.randn(3, 5, 5, 8)).astype(np.float32)
    x2 = rng.randn(3, 5, 5, 8).astype(np.float32)
    for logdet in (False, True):
        jm = JAN(logdet=logdet)
        out, v = jm.init_with_output(jax.random.PRNGKey(0), jnp.asarray(x.copy()))
        m = ActNorm(8, logdet=logdet, device=CPU)
        got = m(t(x))
        np.testing.assert_allclose(m.loc.detach().numpy(), np.asarray(v["params"]["loc"]), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(m.scale.detach().numpy(), np.asarray(v["params"]["scale"]), rtol=1e-6)
        for g, w in zip(got if logdet else (got,), out if logdet else (out,)):
            assert rel_err(g.detach().numpy(), w) < 1e-6
        # later batches use the initialised loc/scale; reverse inverts
        want = jm.apply(v, jnp.asarray(x2.copy()))
        got = m(t(x2))
        assert rel_err((got[0] if logdet else got).detach().numpy(), want[0] if logdet else want) < 1e-6
        back = m((got[0] if logdet else got), reverse=True)
        assert rel_err(back.detach().numpy(), x2) < 1e-5
    m = ActNorm(8, device=CPU)
    assert rel_err(m(t(x[:, 0, 0])).detach().numpy(),
                   JAN().init_with_output(jax.random.PRNGKey(0), jnp.asarray(x[:, 0, 0].copy()))[0]) < 1e-6


def test_actnorm_discriminator_initialises_from_its_first_batch():
    """use_actnorm: ActNorm in each BatchNorm's place and the convs before
    them with a bias. The port's ActNorm layers set loc/scale from the
    first batch they see, as JAX's ``init`` on that batch does."""
    from neurosis_tpu.losses.patchgan import NLayerDiscriminator as JD
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.patchgan import NLayerDiscriminator

    x = np.random.RandomState(7).randn(2, 32, 32, 3).astype(np.float32)
    jm = JD(ndf=8, n_layers=2, use_actnorm=True)
    out, v = jax.jit(jm.init_with_output)(jax.random.PRNGKey(0), jnp.asarray(x.copy()))
    assert "batch_stats" not in v
    m = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True, device=CPU)
    state = jax_params_to_state_dict(to_np(v["params"]))
    norm = {k: w for k, w in state.items() if k.endswith((".loc", ".scale"))}
    assert sorted(norm) == ["layers.3.loc", "layers.3.scale", "layers.6.loc", "layers.6.scale"]
    missing, unexpected = m.load_state_dict({k: w for k, w in state.items() if k not in norm}, strict=False)
    assert sorted(missing) == sorted(norm) and not unexpected
    got = m(t(x))
    assert rel_err(got.detach().numpy(), out) < 1e-5
    for k, w in norm.items():
        assert rel_err(m.get_parameter(k).detach().numpy(), w.numpy()) < 1e-5, k
    m2 = NLayerDiscriminator(ndf=8, n_layers=2, use_actnorm=True, device=CPU)
    m2.load_state_dict(state, strict=True)  # a loaded ActNorm is initialised: the data do not reset it
    m2(t(x[:1] * 3.0))
    assert torch.equal(m2.layers[3].loc, state["layers.3.loc"])


def test_latent_lpips_matches_jax():
    from neurosis_tpu.losses.vae_loss import LatentLPIPS as JLL
    from neurosis_tpu_torch.losses.vae_loss import LatentLPIPS

    rng = np.random.RandomState(8)
    a = rng.randn(2, 4, 4, 3).astype(np.float32)
    b = (a + 0.5 * rng.randn(*a.shape)).astype(np.float32)

    def jdecode(z):
        return jnp.repeat(jnp.repeat(jnp.tanh(z), 8, axis=1), 8, axis=2)

    def tdecode(z):
        return torch.tanh(z).repeat_interleave(8, dim=1).repeat_interleave(8, dim=2)

    jm = JLL(perceptual_weight=0.5, latent_weight=2.0)
    p = perturb(jax.jit(lambda k, aa, bb: jm.init(k, jdecode, aa, bb))(jax.random.PRNGKey(0), jnp.asarray(a),
                                                                          jnp.asarray(b))["params"], 9, 0.01)
    m = LatentLPIPS(perceptual_weight=0.5, latent_weight=2.0, device=CPU)
    load_into(m, p)
    (want, jlog), gb = jax.jit(jax.value_and_grad(lambda bb: (lambda o: (jnp.mean(o[0]), o[1]))(
        jm.apply({"params": p}, jdecode, jnp.asarray(a), bb)), has_aux=True))(jnp.asarray(b))
    tb = t(b, requires_grad=True)
    loss, log = m(tdecode, t(a), tb)
    np.testing.assert_allclose(float(loss.mean()), float(want), rtol=1e-5)
    for k, val in jlog.items():
        np.testing.assert_allclose(float(log[k]), float(val), rtol=1e-5, err_msg=k)
    loss.mean().backward()
    assert rel_err(tb.grad.numpy(), gb) < 1e-4
