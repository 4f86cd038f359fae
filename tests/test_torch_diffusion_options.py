"""The SD training path's objectives against the JAX package on the CPU:
every discretization's table, every σ generator on a t grid with its ends,
every preconditioning's four coefficients and every weighting on the σ
grids JAX's own generators and tables give (rtol 1e-6), the continuous and
discrete denoisers, and StandardDiffusionLoss over l1/l2 × edm/rf × the
noise offset (chance 0, 1 and a drawn chance) with JAX's own draws replayed
(1e-6 of the largest value). fp32, as the training path computes.

Where a weighting passes σ through a log-exp chain (the rectified-flow
weightings and min-SNR over them), fp32 log and exp of the two libraries
differ by an ulp, and the chain carries that on: by the weighting's
condition number κ = |d ln w / d ln σ| (up to 14 at σ ≈ 1000), and through
exp by the size of its argument, about |ln w| (up to ~100). There an element
is held to 1e-6·max(1, κ, |ln w|) relative (κ from the port's own weighting
in fp64), plus 1e-30 absolute where exp underflows (XLA flushes a subnormal
intermediate to zero, torch keeps it: a weight of 1e-36 against 0), and the same
comparison in fp64 (JAX with x64) holds the formula itself to 1e-12.
The cosine σ generator computes log(var/(1 − var)) in fp32 with var near 1
at small t, so an ulp of its cos becomes 2.6e-6 relative (measured): it is
held to 1e-5 (JAX casts t to fp32, so there is no fp64 comparison)."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import one_torch_thread, rel_err, t  # noqa: E402,F401


CPU = "cpu"
DISCRETIZATIONS = [
    ("EDMcDiscretization", {}), ("EDMcDiscretization", {"do_append_zero": False, "sigma_min": 0.01}),
    ("EDMcSimpleDiscretization", {}), ("EDMDiscretization", {}), ("EDMDiscretization", {"rho": 3.0}),
    ("TanZeroSNRDiscretization", {}), ("TanZeroSNRDiscretization", {"scale": 2.0, "end_shift": 0.01}),
    ("RectifiedFlowDiscretization", {}), ("RectifiedFlowDiscretization", {"do_append_zero": True}),
    ("RectifiedFlowComfyDiscretization", {}), ("LegacyDDPMDiscretization", {}),
]
GENERATORS = [
    ("EDMSigmaGenerator", {}), ("CosineScheduleSigmaGenerator", {}), ("TanScheduleSigmaGenerator", {}),
    ("TanScheduleSigmaGenerator", {"clip": False, "scale": 0.5}), ("RectifiedFlowSigmaGenerator", {}),
    ("RectifiedFlowComfySigmaGenerator", {}), ("RectifiedFlowComfySigmaGenerator", {"start_shift": 0.1}),
]
PRECONDITIONINGS = [("EpsPreconditioning", {}), ("VPreconditioning", {}), ("VPreconditioningWithEDMcNoise", {}),
                    ("EDMPreconditioning", {}), ("EDMPreconditioning", {"sigma_data": 0.5}),
                    ("RectifiedFlowXLPreconditioning", {}), ("RectifiedFlowComfyPreconditioning", {})]
WEIGHTINGS = [("UnitWeighting", {}), ("EpsWeighting", {}), ("EDMWeighting", {}), ("EDMWeighting", {"sigma_data": 0.5}),
              ("RectifiedFlowWeighting", {}), ("RectifiedFlowWeighting", {"m": 0.3, "s": 1.5}),
              ("RectifiedFlowComfyWeighting", {})]
T_GRID = np.concatenate([np.linspace(0.0, 1.0, 101), [1e-6, 0.999, 0.9999999]]).astype(np.float32)


def _pair(module: str, name: str, kwargs: dict):
    import importlib

    jax_obj = getattr(importlib.import_module(f"neurosis_tpu.diffusion.{module}"), name)(**kwargs)
    port_obj = getattr(importlib.import_module(f"neurosis_tpu_torch.diffusion.{module}"), name)(**kwargs)
    return jax_obj, port_obj


def _close(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _condition(fn, x: np.ndarray, h: float = 1e-6) -> np.ndarray:
    """κ = |d ln fn / d ln x| of the port's ``fn`` at x, in fp64."""
    x64 = torch.tensor(x, dtype=torch.float64)
    up, down = fn(x64 * np.exp(h)).abs(), fn(x64 * np.exp(-h)).abs()
    return np.nan_to_num(np.abs((torch.log(up) - torch.log(down)).numpy()) / (2 * h), nan=0.0)


def _close_conditioned(port_fn, jax_fn, x: np.ndarray):
    """fp32: within 1e-6·max(1, κ, |ln w|) relative (+1e-30); fp64: within 1e-12."""
    got = port_fn(t(x)).numpy().astype(np.float64)
    want = np.asarray(jax_fn(jnp.asarray(x.copy())), np.float64)
    with np.errstate(divide="ignore"):
        log_w = np.nan_to_num(np.abs(np.log(np.abs(want))), posinf=0.0)
    tol = 1e-6 * np.maximum.reduce([np.ones_like(want), _condition(port_fn, x), log_w]) * np.abs(want) + 1e-30
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol), float(np.max(np.abs(got - want) / tol))
    with jax.enable_x64(True):
        want64 = np.asarray(jax_fn(jnp.asarray(x.astype(np.float64))))
    if want64.dtype == np.float64:  # the generators cast t to fp32 themselves
        got64 = port_fn(torch.tensor(x, dtype=torch.float64)).numpy()
        np.testing.assert_allclose(got64, want64, rtol=1e-12, atol=0)


@functools.lru_cache(maxsize=None)
def sigma_grids():
    """σ grids of JAX's own tables (without the appended zero) and generators."""
    from neurosis_tpu.diffusion import discretization as jd
    from neurosis_tpu.diffusion import sigma_generators as jg

    grids = {name + str(sorted(kw.items())): np.asarray(getattr(jd, name)(**kw).get_sigmas(200), np.float32)
             for name, kw in DISCRETIZATIONS}
    for name, kw in GENERATORS:
        grids[name + str(sorted(kw.items()))] = np.asarray(getattr(jg, name)(**kw)(len(T_GRID), jnp.asarray(T_GRID)))
    return {k: v[np.isfinite(v) & (v > 0)] for k, v in grids.items()}


@pytest.mark.parametrize("name,kwargs", DISCRETIZATIONS)
@pytest.mark.parametrize("n,flip", [(1000, False), (50, True), (7, False)])
def test_discretization_tables(name, kwargs, n, flip):
    jdisc, disc = _pair("discretization", name, kwargs)
    _close(disc(n, flip=flip, device=CPU).numpy(), jdisc(n, flip=flip))
    assert disc.do_append_zero == jdisc.do_append_zero


@pytest.mark.parametrize("name,kwargs", GENERATORS)
def test_sigma_generators_on_a_t_grid(name, kwargs):
    jgen, gen = _pair("sigma_generators", name, kwargs)
    rtol = 1e-5 if name == "CosineScheduleSigmaGenerator" else 1e-6  # the 1 − var cancellation (docstring)
    _close(gen(len(T_GRID), t(T_GRID)).numpy(), jgen(len(T_GRID), jnp.asarray(T_GRID.copy())), rtol)


def test_sigma_generators_draw_their_own_t():
    """Without t each generator draws from the generator it is given: one
    seed, one draw."""
    from neurosis_tpu_torch.diffusion import sigma_generators as g

    for name, kwargs in GENERATORS:
        gen = getattr(g, name)(**kwargs)
        a, b = (gen(16, generator=torch.Generator().manual_seed(3)) for _ in range(2))
        assert a.shape == (16,) and torch.equal(a, b) and torch.isfinite(a).all(), name
    with pytest.raises(ValueError, match="pre-drawn t or a generator"):
        g.EDMSigmaGenerator()(4)


def all_sigmas(below_one: bool = False) -> np.ndarray:
    """Every grid of ``sigma_grids`` in one array (σ < 1 only: the comfy convention's t)."""
    grid = np.concatenate(list(sigma_grids().values()))
    return grid[grid < 1.0] if below_one else grid


@pytest.mark.parametrize("name,kwargs", PRECONDITIONINGS)
def test_preconditionings_on_jax_sigma_grids(name, kwargs):
    jpre, pre = _pair("preconditioning", name, kwargs)
    grid = all_sigmas()
    for g, w in zip(pre(t(grid)), jpre(jnp.asarray(grid.copy()))):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name,kwargs,v_pred", [(n, kw, False) for n, kw in WEIGHTINGS] + [
    ("MinSNRGammaModifier", {}, False), ("MinSNRGammaModifier", {}, True)])
def test_weightings_on_jax_sigma_grids(name, kwargs, v_pred):
    if name == "MinSNRGammaModifier":  # wrapping each weighting in turn
        from neurosis_tpu.diffusion import weighting as jw
        from neurosis_tpu_torch.diffusion import weighting as w

        pairs = [(jw.MinSNRGammaModifier(getattr(jw, n)(**kw), gamma=5.0, v_pred=v_pred),
                  w.MinSNRGammaModifier(getattr(w, n)(**kw), gamma=5.0, v_pred=v_pred)) for n, kw in WEIGHTINGS]
    else:
        pairs = [_pair("weighting", name, kwargs)]
    for jweight, weight in pairs:
        inner = type(getattr(weight, "weighting", weight)).__name__
        grid = all_sigmas(below_one="Comfy" in inner)  # σ is t there
        if "RectifiedFlow" in inner:
            _close_conditioned(weight, jweight, grid)
        else:
            _close(weight(t(grid)).numpy(), jweight(jnp.asarray(grid.copy())))


def _toy_net(xp):
    def net(x, c_noise, cond):
        ctx = cond["crossattn"].mean(axis=(1, 2)) if xp is jnp else cond["crossattn"].mean(dim=(1, 2))
        cn = c_noise.astype(jnp.float32) if xp is jnp else c_noise.float()
        return xp.tanh(x) * (1.0 + 1e-3 * cn)[:, None, None, None] + ctx[:, None, None, None]

    return net


@pytest.mark.parametrize("pre", ["VPreconditioning", "EDMPreconditioning", "RectifiedFlowComfyPreconditioning"])
@pytest.mark.parametrize("mode", ["D", "F"])
def test_continuous_and_discrete_denoisers(pre, mode):
    from neurosis_tpu.diffusion import denoiser as jd
    from neurosis_tpu.diffusion.discretization import TanZeroSNRDiscretization as JTan
    from neurosis_tpu_torch.diffusion import denoiser as d
    from neurosis_tpu_torch.diffusion.discretization import TanZeroSNRDiscretization

    jpre, ppre = _pair("preconditioning", pre, {})
    rng = np.random.RandomState(1)
    x = rng.randn(3, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(3, 77, 16).astype(np.float32)
    sigma = np.array([0.03, 0.7, 14.0], np.float32) if "Comfy" not in pre else np.array([0.03, 0.5, 0.97], np.float32)
    pairs = [(jd.Denoiser(jpre), d.Denoiser(ppre))]
    if pre == "VPreconditioning":
        pairs.append((jd.DiscreteDenoiser(jpre, 1000, JTan(), do_append_zero=True),
                      d.DiscreteDenoiser(ppre, 1000, TanZeroSNRDiscretization(), do_append_zero=True, device=CPU)))
    for jden, den in pairs:
        want = jden(_toy_net(jnp), jnp.asarray(x.copy()), jnp.asarray(sigma.copy()),
                    {"crossattn": jnp.asarray(ctx.copy())}, mode)
        got = den(_toy_net(torch), t(x), t(sigma), {"crossattn": t(ctx)}, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if len(pairs) > 1:
        np.testing.assert_allclose(pairs[1][1].log_sigmas.numpy(), np.asarray(pairs[1][0].log_sigmas), rtol=1e-6)


def jax_loss_draws(rng, shape, chance: float, offset_on: bool):
    """JAX's StandardDiffusionLoss draws for ``rng`` (loss.py:93-97, 58-71),
    as the port takes them: t, noise, and the offset zeroed unless taken."""
    t_rng, noise_rng, offset_rng = jax.random.split(rng, 3)
    ts = jax.random.uniform(t_rng, (shape[0],), dtype=jnp.float32)
    noise = jax.random.normal(noise_rng, shape, dtype=jnp.float32)
    offset = None
    if offset_on:
        chance_rng, off_rng = jax.random.split(offset_rng)
        offset = np.asarray(jax.random.normal(off_rng, shape[:2] + (1,) * (len(shape) - 2), dtype=jnp.float32))
        if chance < 1.0:
            offset = offset * float(jax.random.bernoulli(chance_rng, chance))
    return np.asarray(ts), np.asarray(noise), offset


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("objective", ["edm", "rf"])
@pytest.mark.parametrize("offset,chance,seed", [(0.0, 0.0, 0), (0.1, 0.0, 1), (0.1, 1.0, 2), (0.1, 0.5, 3)])
def test_standard_loss_with_jax_draws(loss_type, objective, offset, chance, seed):
    from neurosis_tpu.diffusion.denoiser import Denoiser as JDen
    from neurosis_tpu.diffusion.loss import StandardDiffusionLoss as JLoss
    from neurosis_tpu_torch.diffusion.denoiser import Denoiser
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss

    if objective == "rf":
        gen, pre, weight = "RectifiedFlowComfySigmaGenerator", "RectifiedFlowComfyPreconditioning", \
            "RectifiedFlowComfyWeighting"
    else:
        gen, pre, weight = "EDMSigmaGenerator", "EDMPreconditioning", "EDMWeighting"
    (jgen, pgen), (jpre, ppre), (jw, pw) = (_pair("sigma_generators", gen, {}), _pair("preconditioning", pre, {}),
                                            _pair("weighting", weight, {}))
    kw = dict(loss_type=loss_type, objective_type=objective, noise_offset=offset, noise_offset_chance=chance)
    jloss, loss = JLoss(jgen, jw, **kw), StandardDiffusionLoss(pgen, pw, **kw)
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(4, 77, 16).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jloss(_toy_net(jnp), JDen(jpre), {"crossattn": jnp.asarray(ctx.copy())}, jnp.asarray(x.copy()), key)
    ts, noise, off = jax_loss_draws(key, x.shape, loss.noise_offset_chance, loss.noise_offset > 0)
    got = loss(_toy_net(torch), Denoiser(ppre), {"crossattn": t(ctx)}, t(x), t=t(ts), noise=t(noise),
               offset=None if off is None else t(off))
    assert got.shape == (4,)
    assert rel_err(got.numpy(), want) < 1e-6


def test_loss_clamps_and_refuses_as_jax():
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.sigma_generators import EDMSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import UnitWeighting

    loss = StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), noise_offset=-1, noise_offset_chance=3,
                                 loss_type="MSE", input_keys="y", snr_gamma=5.0)
    assert (loss.noise_offset, loss.noise_offset_chance, loss.loss_type, loss.input_keys, loss.snr_gamma) == \
        (0.0, 1.0, "l2", {"y"}, 5.0)
    with pytest.raises(ValueError, match="objective"):
        StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), objective_type="flow")
    with pytest.raises(ValueError, match="loss type"):
        StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), loss_type="huber")


def test_input_keys_reach_the_network():
    from neurosis_tpu_torch.diffusion.denoiser import Denoiser
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.preconditioning import EDMPreconditioning
    from neurosis_tpu_torch.diffusion.sigma_generators import EDMSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import UnitWeighting

    seen = {}

    def net(x, c_noise, cond, **extra):
        seen.update(extra)
        return x

    loss = StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), input_keys=["y"])
    x = torch.zeros(2, 4, 4, 4)
    loss(net, Denoiser(EDMPreconditioning()), {}, x, torch.Generator().manual_seed(0),
         batch={"y": torch.ones(2), "other": torch.ones(2)})
    assert set(seen) == {"y"}


def test_offset_draw_follows_the_chance():
    """Drawn by the port: chance 0 draws nothing; chance 1 always offsets;
    a given seed reproduces its draw."""
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.sigma_generators import EDMSigmaGenerator
    from neurosis_tpu_torch.diffusion.weighting import UnitWeighting

    x = torch.zeros(3, 8, 8, 4)
    never = StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), noise_offset=0.1)
    always = StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), noise_offset=0.1, noise_offset_chance=1.0)
    assert never.draw_offset(x, torch.Generator()) is None
    off = always.draw_offset(x, torch.Generator().manual_seed(0))
    assert off.shape == (3, 8, 1, 1) and bool((off != 0).all())
    half = StandardDiffusionLoss(EDMSigmaGenerator(), UnitWeighting(), noise_offset=0.1, noise_offset_chance=0.5)
    taken = [bool(half.draw_offset(x, torch.Generator().manual_seed(s)).any()) for s in range(40)]
    assert 5 < sum(taken) < 35
