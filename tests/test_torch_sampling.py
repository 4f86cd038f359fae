"""The port's EulerEDMSampler (with VanillaCFG, and with the identity
guider) against the JAX package's over a toy denoiser, from the same
initial noise, on the LegacyDDPM schedule: fp32 on both sides, 1e-5 of the
result's largest value. The toy denoiser mixes x, σ and both conditioning
keys, so the guider's batch doubling and key routing are exercised.

Without churn (s_churn = 0, the configs' setting) the churn noise is scaled
by √(σ̂² − σ²) = 0, and the port draws none. The JAX sampler draws it and
multiplies: inside its fused loop XLA leaves a residual of σ̂² − σ² (about
1e-5 at σ = 14.6), whose root moves x by ~1e-3 a step. So the JAX side runs
with that draw zeroed, the value it is meant to have."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import rel_err  # noqa: E402


def _toy(xp, x, sigma, cond):
    s = sigma.reshape(-1, 1, 1, 1)
    vec = cond["vector"][:, None, None, :]
    ctx = cond["crossattn"].mean(axis=1) if xp is jnp else cond["crossattn"].mean(dim=1)
    return 0.9 * x / xp.sqrt(1.0 + s**2) + 0.1 * vec + 0.05 * ctx[:, None, None, :] * xp.tanh(x)


@pytest.mark.parametrize("guided,num_steps", [(True, 8), (False, 8), (True, 3)])
def test_euler_edm_sampler_equals_jax(guided, num_steps, monkeypatch):
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc
    from neurosis_tpu.sampling import EulerEDMSampler as JSampler
    from neurosis_tpu.sampling import VanillaCFG as JCFG

    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.sampling.guidance import VanillaCFG
    from neurosis_tpu_torch.sampling.samplers import EulerEDMSampler

    rng = np.random.RandomState(num_steps + guided)
    x0 = rng.randn(2, 8, 8, 4).astype(np.float32)
    cond = {"vector": rng.randn(2, 4).astype(np.float32), "crossattn": rng.randn(2, 5, 4).astype(np.float32)}
    uc = {k: (0.3 * v).astype(np.float32) for k, v in cond.items()}

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    jsampler = JSampler(discretization=JDisc(), guider=JCFG(scale=7.5) if guided else None, num_steps=num_steps)
    want = jsampler(lambda x, s, c: _toy(jnp, x, s, c), jnp.asarray(x0.copy()),
                    {k: jnp.asarray(v.copy()) for k, v in cond.items()},
                    {k: jnp.asarray(v.copy()) for k, v in uc.items()}, rng=jax.random.PRNGKey(0))
    sampler = EulerEDMSampler(discretization=LegacyDDPMDiscretization(), guider=VanillaCFG(7.5) if guided else None,
                              num_steps=num_steps)
    got = sampler(lambda x, s, c: _toy(torch, x, s, c), torch.tensor(x0.copy()),
                  {k: torch.tensor(v.copy()) for k, v in cond.items()},
                  {k: torch.tensor(v.copy()) for k, v in uc.items()})
    assert got.dtype == torch.float32 and got.shape == x0.shape
    assert rel_err(got.numpy(), np.asarray(want)) < 1e-5


def test_churn_draws_from_the_generator():
    """With s_churn the noise comes from the generator passed in: the same
    seed gives the same samples, another seed others."""
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.sampling.samplers import EulerEDMSampler

    sampler = EulerEDMSampler(discretization=LegacyDDPMDiscretization(), num_steps=4, s_churn=1.0)
    x = torch.randn(1, 4, 4, 2, generator=torch.Generator().manual_seed(0))
    cond = {"vector": torch.zeros(1, 2), "crossattn": torch.zeros(1, 3, 2)}
    run = [sampler(lambda x, s, c: _toy(torch, x, s, c), x, cond, generator=torch.Generator().manual_seed(seed))
           for seed in (1, 1, 2)]
    assert torch.equal(run[0], run[1]) and not torch.equal(run[0], run[2])
