"""The port's VAE-GAN losses against the JAX package on the CPU: the
elementary losses, LPIPS (alex and vgg trunks, seeded random as the JAX
tests make them; lin heads from the packaged v0.1 weights), the PatchGAN
discriminator with its BatchNorm running statistics, and
AutoencoderLPIPSWithDiscr's generator and discriminator terms.

fp32 throughout: forwards within 1e-5 of the largest value, grads within
1e-4 (a few dozen conv layers of fp32 sums in another order), the
discriminator's weight grads within 5e-4 (its first conv bias's grad sums
every position of two batches through a BatchNorm, and those terms nearly
cancel); BatchNorm running statistics within 1e-6.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, one_torch_thread, perturb, rel_err, t, to_np  # noqa: E402,F401

CPU = "cpu"


def test_elementary_losses_match_jax():
    from neurosis_tpu.losses import functions as jf
    from neurosis_tpu_torch.losses import functions as f

    rng = np.random.RandomState(0)
    a, b = rng.randn(3, 4, 5, 2).astype(np.float32), rng.randn(3, 4, 5, 2).astype(np.float32)
    ja, jb = jnp.asarray(a.copy()), jnp.asarray(b.copy())
    for name in ("batch_l1_loss", "batch_mse_loss"):
        for red in ("mean", "sum"):
            got = getattr(f, name)(t(a), t(b), red).numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(jf, name)(ja, jb, red)), rtol=1e-6)
    lr, lf = rng.randn(3, 6, 6, 1).astype(np.float32), rng.randn(3, 6, 6, 1).astype(np.float32)
    for name in ("hinge", "vanilla"):
        got = float(f.get_discr_loss_fn(name)(t(lr), t(lf)))
        want = float(jf.get_discr_loss_fn(name)(jnp.asarray(lr.copy()), jnp.asarray(lf.copy())))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    with pytest.raises(ValueError):
        f.get_discr_loss_fn("wgan")


def test_safetensors_reader_matches_the_package():
    from safetensors.numpy import load_file as ref_load

    from neurosis_tpu_torch.checkpoint.safetensors import load_file
    from neurosis_tpu_torch.losses.lpips import ASSETS

    for net in ("alex", "vgg"):
        got = load_file(ASSETS / f"{net}_lpips_v0.1.safetensors")
        want = ref_load(f"neurosis_tpu/assets/lpips/{net}_lpips_v0.1.safetensors")
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax(net):
    from safetensors.numpy import load_file as ref_load

    from neurosis_tpu.losses.lpips import LPIPS as JLPIPS
    from neurosis_tpu_torch.losses.lpips import ASSETS, LPIPS

    m = LPIPS(net, device=CPU)
    heads = ref_load(str(ASSETS / f"{net}_lpips_v0.1.safetensors"))
    for k, v in heads.items():  # the packaged heads load at construction
        np.testing.assert_array_equal(m.get_parameter(k).detach().numpy(), v)

    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.3 * rng.randn(*x.shape), -1, 1).astype(np.float32)
    jm = JLPIPS(pnet_type=net)
    jx, jy = jnp.asarray(x.copy()), jnp.asarray(y.copy())
    p = perturb(jm.init(jax.random.PRNGKey(0), jx, jy)["params"], 2, 0.01)
    load_into(m, p)

    want = jm.apply({"params": p}, jx, jy)
    gy = jax.jit(jax.grad(lambda p_, a: jnp.sum(jm.apply({"params": p_}, jx, a)), argnums=1))(p, jy)
    ty = t(y, requires_grad=True)
    got = m(t(x), ty)
    assert tuple(got.shape) == (2, 1, 1, 1)
    assert rel_err(got.detach().numpy(), want) < 1e-5
    got.sum().backward()
    assert rel_err(ty.grad.numpy(), gy) < 1e-4


@pytest.mark.parametrize("n_layers", [1, 3])
def test_discriminator_and_batchnorm_stats(n_layers):
    """Logits in train mode (batch statistics) and eval mode (running ones),
    and the running statistics after one train-mode call: flax keeps the
    biased variance and moves 0.1 of the way to the batch's."""
    from neurosis_tpu.losses.patchgan import NLayerDiscriminator as JD
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.patchgan import NLayerDiscriminator

    rng = np.random.RandomState(3)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    jx = jnp.asarray(x.copy())
    jm = JD(ndf=16, n_layers=n_layers)
    v = jm.init(jax.random.PRNGKey(0), jx, train=False)
    p = perturb(v["params"], 4)
    m = NLayerDiscriminator(ndf=16, n_layers=n_layers, device=CPU)
    # a conv bias only where no BatchNorm follows: the first and last convs
    assert [m.layers[2 + 3 * i].bias for i in range(n_layers)] == [None] * n_layers
    assert m.layers[0].bias is not None and m.layers[2 + 3 * n_layers].bias is not None
    state = {**jax_params_to_state_dict(to_np(p)), **jax_params_to_state_dict(to_np(v["batch_stats"]))}
    m.load_state_dict(state, strict=True)

    want, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jx, train=True, mutable=["batch_stats"])
    tx = t(x, requires_grad=True)
    got = m(tx, train=True)
    assert rel_err(got.detach().numpy(), want) < 1e-5
    for k, val in jax_params_to_state_dict(to_np(upd["batch_stats"])).items():
        np.testing.assert_allclose(m.get_buffer(k).numpy(), val.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    gx = jax.jit(jax.grad(lambda p_, s_, a: jnp.sum(jm.apply({"params": p_, "batch_stats": s_}, a, train=True,
                                                             mutable=["batch_stats"])[0] ** 2), argnums=2))(
        p, v["batch_stats"], jx)
    (got**2).sum().backward()
    assert rel_err(tx.grad.numpy(), gx) < 1e-4

    want_eval = jm.apply({"params": p, "batch_stats": upd["batch_stats"]}, jx, train=False)
    assert rel_err(m(t(x), train=False).detach().numpy(), want_eval) < 1e-5


def test_discriminator_init_follows_weights_init():
    from neurosis_tpu_torch.losses.patchgan import BatchNorm, NLayerDiscriminator

    m = NLayerDiscriminator(n_layers=3, device=CPU, generator=torch.Generator().manual_seed(0))
    convs = [l for l in m.layers if hasattr(l, "weight") and not isinstance(l, BatchNorm)]
    bns = [l for l in m.layers if isinstance(l, BatchNorm)]
    assert len(convs) == 5 and len(bns) == 3
    w = torch.cat([c.weight.flatten() for c in convs])
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3
    s = torch.cat([b.weight for b in bns])
    assert abs(float(s.mean()) - 1.0) < 5e-3 and float(s.std()) < 0.03


@pytest.mark.parametrize("idx", [0, 1])
def test_lpips_with_discr_matches_jax(idx):
    """The generator term (idx 0: recon + LPIPS + gated −E[D(recons)]) and
    the discriminator term (idx 1), gate open, with the BatchNorm updates
    they make and the grads each step takes (recons for 0, D for 1)."""
    from neurosis_tpu.losses.vae_loss import AutoencoderLPIPSWithDiscr as JL
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderLPIPSWithDiscr

    cfg = dict(perceptual_weight=0.1, disc_start=1, disc_n_layers=1, disc_weight=0.5)
    rng = np.random.RandomState(5)
    x = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    r = (x + 0.4 * rng.randn(*x.shape)).astype(np.float32)  # partly outside [-1, 1]: the clip matters
    jx, jr = jnp.asarray(x.copy()), jnp.asarray(r.copy())
    jm = JL(**cfg)
    v = jm.init(jax.random.PRNGKey(0), jx, jr, jnp.asarray(0), optimizer_idx=0)
    p = perturb(v["params"], 6, 0.01)
    m = AutoencoderLPIPSWithDiscr(**cfg, device=CPU)
    m.load_state_dict({**jax_params_to_state_dict(to_np(p)), **jax_params_to_state_dict(to_np(v["batch_stats"]))},
                      strict=True)

    def jloss(p_, rec):
        (loss, log), upd = jm.apply({"params": p_, "batch_stats": v["batch_stats"]}, jx, rec, jnp.asarray(3),
                                    optimizer_idx=idx, mutable=["batch_stats"])
        return jnp.mean(loss), (log, upd)

    (want, (jlog, upd)), (gp, gr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(p, jr)
    tr = t(r, requires_grad=True)
    loss, log = m(t(x), tr, 3, optimizer_idx=idx)
    np.testing.assert_allclose(float(loss.mean()), float(want), rtol=1e-5)
    for k, val in jlog.items():
        np.testing.assert_allclose(float(log[k]), float(val), rtol=1e-5, atol=1e-7, err_msg=k)
    for k, val in jax_params_to_state_dict(to_np(upd["batch_stats"])).items():
        np.testing.assert_allclose(m.get_buffer(k).numpy(), val.numpy(), rtol=1e-6, atol=1e-6, err_msg=k)
    loss.mean().backward()
    if idx == 0:
        assert rel_err(tr.grad.numpy(), gr) < 1e-4
    else:
        want_g = jax_params_to_state_dict(to_np(gp))
        for k, prm in m.discr.named_parameters():
            assert rel_err(prm.grad.numpy(), want_g[f"discr.{k}"].numpy()) < 5e-4, k
    assert all(q.grad is None for q in m.perceptual_loss.parameters())  # LPIPS is frozen


def test_autoencoder_perceptual_matches_jax():
    """recon (l1 and l2) + weighted LPIPS, with the clip to [-1, 1]."""
    from neurosis_tpu.losses.vae_loss import AutoencoderPerceptual as JP
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderPerceptual

    rng = np.random.RandomState(7)
    x = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    r = (x + 0.5 * rng.randn(*x.shape)).astype(np.float32)
    jx, jr = jnp.asarray(x.copy()), jnp.asarray(r.copy())
    for recon_type in ("l1", "l2"):
        jm = JP(recon_type=recon_type, perceptual_weight=0.3)
        p = perturb(jm.init(jax.random.PRNGKey(0), jx, jr)["params"], 8, 0.01)
        m = AutoencoderPerceptual(recon_type=recon_type, perceptual_weight=0.3, device=CPU)
        load_into(m, p)
        jloss, jlog = jm.apply({"params": p}, jx, jr)
        gr = jax.jit(jax.grad(lambda p_, a: jnp.mean(jm.apply({"params": p_}, jx, a)[0]), argnums=1))(p, jr)
        tr = t(r, requires_grad=True)
        loss, log = m(t(x), tr)
        np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss), rtol=1e-5)
        for k, v in jlog.items():
            np.testing.assert_allclose(float(log[k]), float(v), rtol=1e-5, err_msg=k)
        loss.mean().backward()
        assert rel_err(tr.grad.numpy(), gr) < 1e-4


def test_gate_and_r1():
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderLPIPSWithDiscr

    m = AutoencoderLPIPSWithDiscr(perceptual_weight=0.0, disc_start=5, disc_n_layers=1, disc_lambda_r1=0.1,
                                  device=CPU)
    assert (m.gate(4), m.gate(5)) == (0.0, 1.0)
    assert AutoencoderLPIPSWithDiscr(perceptual_weight=0.0, disc_n_layers=1, device=CPU).gate(10**6) == 0.0
    x = torch.rand(2, 32, 32, 3) * 2 - 1
    loss, log = m(x, x.flip(1), 5, optimizer_idx=0)
    assert float(log["train/loss/r1_penalty"]) > 0 and torch.isfinite(loss).all()
