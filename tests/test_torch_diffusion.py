"""neurosis_tpu_torch diffusion maths against the JAX package on the same
seeded inputs: the LegacyDDPM σ table, DiscreteSigmaGenerator (exclude_zero),
EpsPreconditioning through DiscreteDenoiser, EpsWeighting and
StandardDiffusionLoss with explicit t and noise, and timestep_embedding.
All fp32; tables match to 1e-6 relative, network compositions to 1e-6 of the
largest value (the same fp32 elementwise formulas on both sides), the loss to
1e-5 relative."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import rel_err, t  # noqa: E402


def _toy_net(xp):
    """A network_apply both frameworks can run: depends on x, c_noise and
    the cross-attention context, so every input of the denoiser matters."""

    def net(x, c_noise, cond):
        ctx = cond["crossattn"].mean(axis=(1, 2)) if xp is jnp else cond["crossattn"].mean(dim=(1, 2))
        scale = 1.0 + 1e-3 * c_noise.astype(jnp.float32) if xp is jnp else 1.0 + 1e-3 * c_noise.float()
        return xp.tanh(x) * scale[:, None, None, None] + ctx[:, None, None, None]

    return net


@pytest.mark.parametrize("n,flip", [(1000, False), (1000, True), (50, False), (50, True)])
def test_legacy_ddpm_table(n, flip):
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization

    want = np.asarray(JDisc()(n, flip=flip))
    got = LegacyDDPMDiscretization()(n, flip=flip, device="cpu").numpy()
    assert got.shape == want.shape == (n + 1,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_discrete_sigma_generator_excludes_zero():
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu.diffusion.sigma_generators import DiscreteSigmaGenerator as JGen
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator

    ts = np.concatenate([np.random.RandomState(0).rand(64), [0.0, 0.9999, 1.0, 7.0, 999.0]]).astype(np.float32)
    jgen = JGen(JDisc(), num_idx=1000)
    gen = DiscreteSigmaGenerator(LegacyDDPMDiscretization(), 1000, device="cpu")
    assert float(gen.sigmas[0]) > 0.0 and gen.sigmas.shape[0] == 1000
    want = np.asarray(jgen(len(ts), jnp.asarray(ts.copy())))
    got = gen(len(ts), t(ts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("quantize", [True, False])
@pytest.mark.parametrize("mode", ["D", "F"])
def test_discrete_denoiser(quantize, mode):
    from neurosis_tpu.diffusion.denoiser import DiscreteDenoiser as JDen
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu.diffusion.preconditioning import EpsPreconditioning as JEps
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning

    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(3, 77, 16).astype(np.float32)
    sigma = np.array([0.03, 1.7, 14.0], np.float32)  # off-table: quantized to the nearest entry
    jden = JDen(JEps(), 1000, JDisc(), quantize_c_noise=quantize)
    den = DiscreteDenoiser(EpsPreconditioning(), 1000, LegacyDDPMDiscretization(), quantize_c_noise=quantize,
                           device="cpu")
    want = jden(_toy_net(jnp), jnp.asarray(x.copy()), jnp.asarray(sigma.copy()),
                {"crossattn": jnp.asarray(ctx.copy())}, mode)
    got = den(_toy_net(torch), t(x), t(sigma), {"crossattn": t(ctx)}, mode)
    assert rel_err(got.numpy(), want) < 1e-6


def test_standard_loss_explicit_t_and_noise():
    """The port's loss with t and noise passed in equals JAX's loss built
    from the same components on the same draws (JAX draws them inside,
    loss.py:93-97, so the JAX side composes the steps by hand)."""
    from neurosis_tpu.diffusion.denoiser import DiscreteDenoiser as JDen
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu.diffusion.loss import StandardDiffusionLoss as JLoss
    from neurosis_tpu.diffusion.preconditioning import EpsPreconditioning as JEps
    from neurosis_tpu.diffusion.sigma_generators import DiscreteSigmaGenerator as JGen
    from neurosis_tpu.diffusion.weighting import EpsWeighting as JW
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting

    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 8, 4).astype(np.float32)
    noise = rng.randn(4, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 16).astype(np.float32)
    ts = np.array([0.0, 0.25, 0.5, 0.999], np.float32)

    jloss = JLoss(JGen(JDisc(), 1000), JW())
    jden = JDen(JEps(), 1000, JDisc())
    sig = jloss.sigma_generator(4, jnp.asarray(ts.copy()))
    z = jnp.asarray(x.copy()) + sig[:, None, None, None] * jnp.asarray(noise.copy())
    d = jden(_toy_net(jnp), z, sig, {"crossattn": jnp.asarray(ctx.copy())}, "D")
    want = jloss.get_loss(d, jnp.asarray(x.copy()), jloss.loss_weighting(sig))

    disc = LegacyDDPMDiscretization()
    loss = StandardDiffusionLoss(DiscreteSigmaGenerator(disc, 1000, device="cpu"), EpsWeighting())
    den = DiscreteDenoiser(EpsPreconditioning(), 1000, disc, device="cpu")
    got = loss(_toy_net(torch), den, {"crossattn": t(ctx)}, t(x), t=t(ts), noise=t(noise))
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def test_loss_draws_from_the_generator():
    """Without explicit t and noise the loss draws both from the generator:
    the same seed gives the same loss, another seed another loss."""
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting

    disc = LegacyDDPMDiscretization()
    loss = StandardDiffusionLoss(DiscreteSigmaGenerator(disc, 1000, device="cpu"), EpsWeighting())
    den = DiscreteDenoiser(EpsPreconditioning(), 1000, disc, device="cpu")
    x = torch.randn(2, 4, 4, 4, generator=torch.Generator().manual_seed(0))
    cond = {"crossattn": torch.zeros(2, 77, 8)}
    run = lambda seed: loss(_toy_net(torch), den, cond, x, torch.Generator().manual_seed(seed))
    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all()


@pytest.mark.parametrize("dim", [32, 320, 33])
def test_timestep_embedding(dim):
    from neurosis_tpu.modules.layers import timestep_embedding as jemb
    from neurosis_tpu_torch.modules.layers import timestep_embedding

    ts = np.array([0, 1, 17, 500, 999], np.int32)
    want = np.asarray(jemb(jnp.asarray(ts.copy()), dim))
    got = timestep_embedding(torch.tensor(ts), dim).numpy()
    assert got.dtype == np.float32 and got.shape == (5, dim)
    # arguments reach ~1e3 rad, where one fp32 ulp of exp's frequency moves
    # the angle by ~1e-4: cos/sin agree to that, not to 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
