"""Helpers for holding neurosis_tpu_torch modules against their JAX twins.

Inputs are made with numpy from a seed and copied into both frameworks
(jax on the CPU can alias a numpy buffer, so every hand-over copies).
Parameters go JAX → torch through ``jax_params_to_state_dict`` and load
with ``strict=True``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one torch thread (xdist runs several workers on the
    box's cores; torch would give each of them every core), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(tree):
    """A JAX pytree of arrays → the same nesting of numpy copies."""
    if isinstance(tree, dict) or hasattr(tree, "items"):
        return {k: to_np(v) for k, v in tree.items()}
    return np.array(tree, dtype=np.float32)


def perturb(tree, seed: int, scale: float = 0.02):
    """Add small seeded noise to every leaf, so zero-initialised layers
    (out convs, proj_out) take part in a comparison."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        arr = np.asarray(t, np.float32)
        return arr + scale * np.asarray(rng.randn(*arr.shape), np.float32)

    return walk(to_np(tree))


def load_into(module: torch.nn.Module, jax_params, prefix: str = "") -> None:
    module.load_state_dict(jax_params_to_state_dict(to_np(jax_params), prefix), strict=True)


def grads_by_key(jax_grads) -> dict:
    """JAX gradient tree → {torch key: numpy grad in torch layout}."""
    return {k: v.numpy() for k, v in jax_params_to_state_dict(to_np(jax_grads)).items()}


def check_grads(module: torch.nn.Module, jax_grads, tol: float) -> None:
    """Each parameter's grad within tol of its own largest value, or of
    1e-3 of the largest grad anywhere for tensors whose true grad is ~0 (a
    conv bias right before a GroupNorm)."""
    want = grads_by_key(jax_grads)
    got = {k: p.grad for k, p in module.named_parameters()}
    assert set(got) == set(want)
    floor = 1e-3 * max(float(np.abs(w).max()) for w in want.values())
    for k, g in got.items():
        err = float(np.abs(g.numpy() - want[k]).max())
        assert err / max(float(np.abs(want[k]).max()), floor) < tol, k


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(want))), 1e-12)


def t(x: np.ndarray, dtype=torch.float32, requires_grad: bool = False) -> torch.Tensor:
    return torch.tensor(np.array(x), dtype=dtype, requires_grad=requires_grad)


def recorded_launches(monkeypatch):
    """The kernels' libraries replaced by a stub that records each launch as
    (entry, shape): (B, H, Sq, Skv) for flash, (B, H, W, C, F) for the convs;
    meta tensors then run through every wrapper."""
    import collections
    import types

    from neurosis_tpu_torch import _nvcc
    from neurosis_tpu_torch.models import autoencoder, unet, vae
    from neurosis_tpu_torch.ops import conv3x3, flash_attention

    calls = collections.Counter()

    class Lib:
        def __getattr__(self, entry):
            def launch(*args):
                first = {"flash": 5, "conv3x3": 3, "gn_silu": 5}[next(k for k in ("flash", "conv3x3", "gn_silu")
                                                                      if entry.startswith(k))]
                calls[entry, tuple(args[first:first + (4 if entry.startswith("flash") else 5)])] += 1
                return 0
            return launch

    monkeypatch.setattr(_nvcc, "load", lambda name: Lib())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for mod in (flash_attention, conv3x3):
        monkeypatch.setattr(mod, "sm_count", lambda index: 132)
    for mod in (unet, vae, autoencoder):
        monkeypatch.setattr(mod, "init_parameters", lambda module, generator: None)
    return calls
