"""The port's optax counterparts (neurosis_tpu_torch/optimizers/adamw.py:
``adam``, ``adamw``, ``sgd``) and CAME (optimizers/came.py) against optax
and the JAX package's ``came`` on the CPU, and the ``torch.optim`` class
paths, which both packages map to optax's functions.

The same seeded parameters (a conv kernel, a dense kernel, a bias, in
JAX's layout, handed to torch in its own with ``jax_layout`` set as the
port's Conv2d and Dense set it) take 5 steps of seeded grads on both
sides. fp32 parameters after each step within 1e-6 of their largest value.
"""

import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

SHAPES = {"conv": (3, 3, 4, 6), "dense": (5, 7), "bias": (7,)}  # JAX layouts
TO_TORCH = {"conv": (3, 2, 0, 1), "dense": (1, 0)}
JAX_LAYOUT = {"conv": (2, 3, 1, 0), "dense": (1, 0)}
STEPS = 5


def _params(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grads(step: int) -> dict:
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*s) * 10.0 ** rng.uniform(-3, 0)).astype(np.float32) for k, s in SHAPES.items()}


def _torch_params(params: dict) -> dict:
    out = {}
    for k, v in params.items():
        p = torch.nn.Parameter(torch.tensor(v.transpose(TO_TORCH[k]) if k in TO_TORCH else v.copy()))
        if k in JAX_LAYOUT:
            p.jax_layout = JAX_LAYOUT[k]
        out[k] = p
    return out


def _jax_view(k: str, p: torch.Tensor) -> np.ndarray:
    return p.detach().permute(*JAX_LAYOUT[k]).numpy() if k in JAX_LAYOUT else p.detach().numpy()


def _run_both(jax_opt, torch_factory, steps: int = STEPS, tol: float = 1e-6):
    import optax

    params = _params()
    jp = {k: jnp.asarray(v.copy()) for k, v in params.items()}
    state = jax_opt.init(jp)
    tp = _torch_params(params)
    opt = torch_factory(list(tp.values()))
    for i in range(steps):
        g = _grads(i)
        upd, state = jax_opt.update({k: jnp.asarray(v.copy()) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k].transpose(TO_TORCH[k]) if k in TO_TORCH else g[k].copy())
        opt.step()
        for k, p in tp.items():
            want = np.asarray(jp[k])
            err = np.abs(_jax_view(k, p) - want).max() / np.abs(want).max()
            assert err < tol, (i, k, err)
    return tp


@pytest.mark.parametrize("kw", [{}, {"eps_root": 1e-6}, {"nesterov": True}, {"mu_dtype": "bfloat16"},
                                {"b1": 0.8, "b2": 0.99, "eps": 1e-6, "eps_root": 1e-8, "nesterov": True}])
@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_adam_and_adamw_match_optax(name, kw):
    import optax

    from neurosis_tpu_torch.optimizers import adamw as port

    extra = {"weight_decay": 0.05} if name == "adamw" else {}
    jax_kw = dict(kw, mu_dtype=jnp.bfloat16) if "mu_dtype" in kw else kw
    _run_both(getattr(optax, name)(1e-2, **jax_kw, **extra), lambda ps: getattr(port, name)(ps, 1e-2, **kw, **extra))


def test_mu_dtype_keeps_the_first_moment_in_it():
    from neurosis_tpu_torch.optimizers.adamw import adam

    p = torch.nn.Parameter(torch.ones(4))
    opt = adam([p], 1e-3, mu_dtype="jnp.bfloat16")
    p.grad = torch.full((4,), 0.3)
    opt.step()
    assert opt.state[p]["mu"].dtype == torch.bfloat16 and opt.state[p]["nu"].dtype == torch.float32


@pytest.mark.parametrize("kw", [{}, {"momentum": 0.9}, {"momentum": 0.9, "nesterov": True},
                                {"momentum": 0.9, "accumulator_dtype": "bfloat16"}])
def test_sgd_matches_optax(kw):
    import optax

    from neurosis_tpu_torch.optimizers.adamw import sgd

    jax_kw = dict(kw, accumulator_dtype=jnp.bfloat16) if "accumulator_dtype" in kw else kw
    _run_both(optax.sgd(1e-2, **jax_kw), lambda ps: sgd(ps, 1e-2, **kw))


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.01, "clip_threshold": 0.5, "betas": (0.8, 0.95, 0.99)}])
def test_came_matches_jax_on_jax_s_axes(kw):
    """The factored moments run over the last two axes of JAX's layout (the
    conv kernel's I and O, the dense kernel's in and out)."""
    from neurosis_tpu.optimizers.came import came
    from neurosis_tpu_torch.optimizers.came import CAME

    _run_both(came(1e-2, **kw), lambda ps: CAME(ps, 1e-2, **kw))


# -- the torch.optim class paths ----------------------------------------------

TORCH_NODES = {
    "torch.optim.AdamW": {"lr": 1e-2, "betas": [0.5, 0.6], "amsgrad": True, "weight_decay": 0.05,
                          "maximize": False},
    "torch.optim.Adam": {"lr": 1e-2, "betas": [0.5, 0.6], "weight_decay": 0.3, "eps": 1e-6},
    "torch.optim.SGD": {"lr": 1e-2, "momentum": 0.9, "dampening": 0.5, "weight_decay": 0.3, "nesterov": True},
}


@pytest.mark.parametrize("path", sorted(TORCH_NODES))
def test_a_torch_optim_path_trains_what_jax_s_builder_does(path, caplog):
    """Both builders map the path to optax's function, rename ``lr`` and
    drop what it does not take (``betas``, ``amsgrad``, ``maximize``,
    ``dampening``, Adam's and SGD's ``weight_decay``), the port with the
    loader's warning; 5 steps agree."""
    from neurosis_tpu.trainer.builder import build_optimizer as jax_build

    from neurosis_tpu_torch.trainer.builder import build_optimizer

    node = {"class_path": path, "init_args": dict(TORCH_NODES[path])}
    with caplog.at_level(logging.WARNING):
        factory = build_optimizer(node)
    dropped = {"torch.optim.AdamW": "['amsgrad', 'betas', 'maximize']", "torch.optim.Adam": "['betas', 'weight_decay']",
               "torch.optim.SGD": "['dampening', 'weight_decay']"}[path]
    assert f"takes no {dropped}: dropped" in caplog.text
    _run_both(jax_build({"class_path": path, "init_args": dict(TORCH_NODES[path])}), factory)


def test_torch_optim_adamw_decays_by_optax_s_default():
    """``torch.optim.AdamW {lr: 1e-4}`` decays weights by optax's 1e-4,
    not torch's 1e-2: with a zero grad one step scales p by 1 − lr·1e-4."""
    from neurosis_tpu_torch.trainer.builder import build_optimizer

    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = build_optimizer({"class_path": "torch.optim.AdamW", "init_args": {"lr": 1e-4}})([p])
    assert opt.defaults["weight_decay"] == 1e-4
    p.grad = torch.zeros_like(p)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 1e-4 * 1e-4, rtol=0, atol=1e-15)


def test_the_optax_paths_resolve_and_mask_is_refused():
    from neurosis_tpu_torch.config.loader import instantiate
    from neurosis_tpu_torch.trainer.builder import build_optimizer

    for name in ("adam", "adamw", "sgd"):
        build_optimizer({"class_path": f"optax.{name}", "init_args": {"learning_rate": 1e-3}})
    with pytest.raises(NotImplementedError, match="item 8"):
        build_optimizer({"class_path": "optax.adamw", "init_args": {"learning_rate": 1e-3, "mask": {"a": True}}})
    with pytest.raises(NotImplementedError, match="item 11"):
        instantiate({"class_path": "optax.lion"})
