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


# -- every sampler and guider (the rest of sampling) -----------------------------

SAMPLERS = ["EulerEDMSampler", "HeunEDMSampler", "EulerAncestralSampler", "DPMPP2SAncestralSampler",
            "DPMPP2MSampler", "LinearMultistepSampler"]


def _python_fori_loop(lower, upper, body, init):
    """lax.fori_loop as a Python loop, so an injected noise sampler is
    called once a step on the JAX side too."""
    carry = init
    for i in range(lower, upper):
        carry = body(i, carry)
    return carry


def _run_both(name, guider, num_steps, x0, cond, uc, monkeypatch, **kwargs):
    """The JAX sampler and the port's, of class ``name``, from the same x0,
    each step's ancestral noise the same seeded numpy draw on both sides, the
    EDM churn draw zeroed on the JAX side (see the module doc)."""
    import neurosis_tpu.sampling.samplers as jmod
    from neurosis_tpu.diffusion.discretization import LegacyDDPMDiscretization as JDisc

    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.sampling import samplers as tmod

    noise_rng = np.random.RandomState(11)
    noise = [noise_rng.randn(*x0.shape).astype(np.float32) for _ in range(num_steps)]
    jnoise, tnoise = iter(noise), iter(noise)
    monkeypatch.setattr(jax.lax, "fori_loop", _python_fori_loop)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    extra = {"noise_sampler": None} if "Ancestral" in name else {}
    jguider, tguider = guider
    jkw = dict(kwargs, **({"noise_sampler": lambda key, shape, dtype: jnp.asarray(next(jnoise).copy())}
                          if extra else {}))
    tkw = dict(kwargs, **({"noise_sampler": lambda g, shape, dtype, device: torch.tensor(next(tnoise).copy())}
                          if extra else {}))
    jsampler = getattr(jmod, name)(discretization=JDisc(), guider=jguider, num_steps=num_steps, **jkw)
    want = jsampler(lambda x, s, c: _toy(jnp, x, s, c), jnp.asarray(x0.copy()),
                    {k: jnp.asarray(v.copy()) for k, v in cond.items()},
                    {k: jnp.asarray(v.copy()) for k, v in uc.items()}, rng=jax.random.PRNGKey(0))
    sampler = getattr(tmod, name)(discretization=LegacyDDPMDiscretization(), guider=tguider, num_steps=num_steps,
                                  **tkw)
    got = sampler(lambda x, s, c: _toy(torch, x, s, c), torch.tensor(x0.copy()),
                  {k: torch.tensor(v.copy()) for k, v in cond.items()},
                  {k: torch.tensor(v.copy()) for k, v in uc.items()}, generator=torch.Generator().manual_seed(0))
    return got, np.asarray(want)


def _inputs(seed: int, batch: int = 2):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(batch, 8, 8, 4).astype(np.float32)
    cond = {"vector": rng.randn(batch, 4).astype(np.float32), "crossattn": rng.randn(batch, 5, 4).astype(np.float32)}
    uc = {k: (0.3 * v).astype(np.float32) for k, v in cond.items()}
    return x0, cond, uc


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("name", SAMPLERS)
def test_every_sampler_equals_jax(name, guided, monkeypatch):
    """Each sampler of neurosis_tpu/sampling/samplers.py with the identity
    guider and with VanillaCFG(7.5), 6 steps on the toy denoiser from the
    same noise, fp32 on both sides: within 1e-5 of the result's largest
    value (1e-4 for LMS, whose quadrature coefficients the two sides compute
    from their own fp32 tables)."""
    from neurosis_tpu.sampling import VanillaCFG as JCFG

    from neurosis_tpu_torch.sampling.guidance import VanillaCFG

    x0, cond, uc = _inputs(SAMPLERS.index(name) + 10 * guided)
    guider = (JCFG(scale=7.5), VanillaCFG(7.5)) if guided else (None, None)
    got, want = _run_both(name, guider, 6, x0, cond, uc, monkeypatch)
    assert got.dtype == torch.float32 and got.shape == x0.shape and np.isfinite(want).all()
    assert rel_err(got.numpy(), want) < (1e-4 if name == "LinearMultistepSampler" else 1e-5)


def test_samplers_with_churn_and_eta_options_equal_jax(monkeypatch):
    """HeunEDMSampler with its s_tmin/s_tmax window (churn still 0) and the
    ancestral samplers at eta 0.5 and s_noise 0.8, 4 steps with CFG."""
    from neurosis_tpu.sampling import VanillaCFG as JCFG

    from neurosis_tpu_torch.sampling.guidance import VanillaCFG

    x0, cond, uc = _inputs(3)
    for name, kw in (("HeunEDMSampler", dict(s_tmin=0.5, s_tmax=5.0)),
                     ("EulerAncestralSampler", dict(eta=0.5, s_noise=0.8)),
                     ("DPMPP2SAncestralSampler", dict(eta=0.5, s_noise=0.8))):
        got, want = _run_both(name, (JCFG(scale=3.0), VanillaCFG(3.0)), 4, x0, cond, uc, monkeypatch, **kw)
        assert rel_err(got.numpy(), want) < 1e-5, name


def test_linear_prediction_guider_equals_jax(monkeypatch):
    """LinearPredictionGuider over 2 clips of 3 frames with an extra cond key:
    its batch doubling and per-frame scale ramp, and a guided Euler run."""
    from neurosis_tpu.sampling.guidance import LinearPredictionGuider as JLPG

    from neurosis_tpu_torch.sampling.guidance import LinearPredictionGuider

    rng = np.random.RandomState(5)
    jg = JLPG(max_scale=2.5, num_frames=3, min_scale=1.0, additional_cond_keys="extra")
    tg = LinearPredictionGuider(max_scale=2.5, num_frames=3, min_scale=1.0, additional_cond_keys="extra")
    x = rng.randn(12, 4, 4, 2).astype(np.float32)
    np.testing.assert_allclose(tg(torch.tensor(x.copy()), None).numpy(), np.asarray(jg(jnp.asarray(x.copy()), None)),
                               rtol=1e-6, atol=1e-6)
    c = {"crossattn": rng.randn(6, 3, 2).astype(np.float32), "extra": rng.randn(6, 2).astype(np.float32),
         "other": rng.randn(6, 2).astype(np.float32)}
    uc = {k: -v for k, v in c.items()}
    xin = x[:6]
    jx, js, jc = jg.prepare_inputs(jnp.asarray(xin.copy()), jnp.ones(6), {k: jnp.asarray(v) for k, v in c.items()},
                                   {k: jnp.asarray(v) for k, v in uc.items()})
    tx, ts, tc = tg.prepare_inputs(torch.tensor(xin.copy()), torch.ones(6), {k: torch.tensor(v) for k, v in c.items()},
                                   {k: torch.tensor(v) for k, v in uc.items()})
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert sorted(tc) == sorted(jc)
    for k in c:
        np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]), err_msg=k)
    x0, cond, ucond = _inputs(6, batch=6)
    got, want = _run_both("EulerEDMSampler", (jg, tg), 4, x0, cond, ucond, monkeypatch)
    assert rel_err(got.numpy(), want) < 1e-5


def test_sampling_utils_equal_jax():
    """The ancestral step (eta 1, 0.3 and 0), the log-σ maps and the LMS
    coefficients against the JAX package's, fp32."""
    import neurosis_tpu.sampling.utils as J

    from neurosis_tpu_torch.sampling import utils as T

    s_from, s_to = np.array([14.6, 3.0, 0.5], np.float32), np.array([3.0, 0.5, 0.0], np.float32)
    for eta in (1.0, 0.3, 0.0):
        got = T.get_ancestral_step(torch.tensor(s_from), torch.tensor(s_to), eta)
        want = J.get_ancestral_step(jnp.asarray(s_from), jnp.asarray(s_to), eta)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(T.to_neg_log_sigma(torch.tensor(s_from)).numpy(),
                               np.asarray(J.to_neg_log_sigma(jnp.asarray(s_from))), rtol=1e-6)
    np.testing.assert_allclose(T.to_sigma(torch.tensor(-s_to)).numpy(), np.asarray(J.to_sigma(jnp.asarray(-s_to))),
                               rtol=1e-6)
    table = np.array([14.6, 6.0, 2.5, 1.0, 0.3, 0.0], np.float32)
    for order, i, j in ((1, 0, 0), (2, 1, 1), (3, 4, 2), (4, 4, 0)):
        assert T.linear_multistep_coeff(order, table, i, j) == J.linear_multistep_coeff(order, table, i, j)
    noise = T.default_noise_sampler(torch.Generator().manual_seed(3), (2, 3), device="cpu")
    assert noise.dtype == torch.float32 and noise.shape == (2, 3)
    assert torch.equal(noise, T.default_noise_sampler(torch.Generator().manual_seed(3), (2, 3), device="cpu"))


def test_sampling2_equals_jax():
    """sampling2: the discrete and continuous σ tables, the four schedulers,
    σ↔timestep and the three noise scalings against the JAX package's."""
    import neurosis_tpu.sampling.sampling2 as J

    from neurosis_tpu_torch.sampling import sampling2 as T

    for jsam, tsam in ((J.DiscreteSampler(), T.DiscreteSampler()),
                       (J.DiscreteSampler("cosine", 500), T.DiscreteSampler("cosine", 500)),
                       (J.ContinuousEDMSampler(), T.ContinuousEDMSampler()), (J.TanEDMSampler(), T.TanEDMSampler())):
        np.testing.assert_array_equal(tsam.sigmas, jsam.sigmas)
        # the tan table starts at σ = 0, where the log-σ maps have no value (on both sides)
        logs = tsam.sigma_min > 0
        for name in ("simple", "ddim") + (("uniform", "sgm_uniform") if logs else ()):
            np.testing.assert_array_equal(T.get_sigma_scheduler(name, tsam)(8), J.get_sigma_scheduler(name, jsam)(8))
        sig = np.asarray([0.5, 2.0], np.float32)
        np.testing.assert_array_equal(tsam.timestep(sig), jsam.timestep(sig))
        np.testing.assert_array_equal(tsam.sigma(np.asarray([3.5, 700.0])), jsam.sigma(np.asarray([3.5, 700.0])))
        if logs:
            assert tsam.percent_to_sigma(0.3) == jsam.percent_to_sigma(0.3)
    with pytest.raises(ValueError, match="Unknown scheduler"):
        T.get_sigma_scheduler("karras", T.DiscreteSampler())
    rng = np.random.RandomState(2)
    sigma, out, inp = rng.rand(2).astype(np.float32) + 0.5, rng.randn(2, 3, 3, 4), rng.randn(2, 3, 3, 4)
    out, inp = out.astype(np.float32), inp.astype(np.float32)
    for cls in ("EpsilonScaling", "VScaling", "EDMScaling"):
        j, t = getattr(J, cls)(0.5), getattr(T, cls)(0.5)
        np.testing.assert_allclose(t.calculate_denoised(torch.tensor(sigma), torch.tensor(out), torch.tensor(inp)),
                                   np.asarray(j.calculate_denoised(jnp.asarray(sigma), jnp.asarray(out),
                                                                   jnp.asarray(inp))), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(t.calculate_input(torch.tensor(sigma), torch.tensor(out)),
                                   np.asarray(j.calculate_input(jnp.asarray(sigma), jnp.asarray(out))), rtol=1e-6)
        for max_denoise in (False, True):
            np.testing.assert_allclose(
                t.noise_scaling(torch.tensor(sigma[:1]), torch.tensor(out), torch.tensor(inp), max_denoise),
                np.asarray(j.noise_scaling(jnp.asarray(sigma[:1]), jnp.asarray(out), jnp.asarray(inp), max_denoise)),
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("path", [f"neurosis.modules.diffusion.sampling.{n}" for n in SAMPLERS] +
                         [f"neurosis.modules.guidance.{n}" for n in ("VanillaCFG", "IdentityGuider",
                                                                     "LinearPredictionGuider")])
def test_every_sampler_and_guider_builds_from_a_config(path):
    """Each sampler and guider class path builds from a config node, a
    sampler with its discretization and a CFG guider nested as the configs
    nest them."""
    from neurosis_tpu_torch.config.loader import instantiate
    from neurosis_tpu_torch.sampling import guidance, samplers

    if "guidance" in path:
        args = {"VanillaCFG": {"scale": 7.5}, "IdentityGuider": {},
                "LinearPredictionGuider": {"max_scale": 2.0, "num_frames": 2}}[path.rsplit(".", 1)[1]]
        obj = instantiate({"class_path": path, "init_args": args})
        assert isinstance(obj, guidance.Guider) and type(obj).__name__ == path.rsplit(".", 1)[1]
        return
    obj = instantiate({"class_path": path, "init_args": {
        "num_steps": 5, "discretization": {"class_path": "neurosis.modules.diffusion.LegacyDDPMDiscretization"},
        "guider": {"class_path": "neurosis.modules.guidance.VanillaCFG", "init_args": {"scale": 5.0}}}},
        {"device": torch.device("cpu")})
    assert type(obj).__name__ == path.rsplit(".", 1)[1] and isinstance(obj, samplers.BaseDiffusionSampler)
    assert obj.num_steps == 5 and obj.guider.scale == 5.0
