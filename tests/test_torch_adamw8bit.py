"""The port's 8-bit AdamW (neurosis_tpu_torch/optimizers/adamw8bit.py) against
the JAX package's (neurosis_tpu/optimizers/adamw8bit.py).

(a) The codebook round trip and its relative-error bounds (the twins of
    tests/test_adamw8bit.py:27-57), and the codes of the same inputs against
    JAX's quantizers: within 1, equal on at least 99.9% (log10 and round can
    differ by an ulp between the two, which moves a code at a boundary).
(b) Five updates of an 8-bit leaf and a small leaf from the same seeded
    parameters and grads: codes within 1 and equal on at least 99.9%,
    scales within 1e-6, the small leaf's fp32 moments within 1e-6 of
    JAX's, the parameters within 1e-6 of their size.
(c) Fifty updates on a noisy quadratic (tests/test_adamw8bit.py:74): the
    8-bit port tracks fp32 torch AdamW (mean |diff| under 5% of the distance
    travelled) and JAX's 8-bit run (under 1%).
(d) The state: int8/uint8 codes and fp32 scales for a large leaf, fp32
    moments under min_8bit_size, about 1.02 bytes a parameter a moment, and
    the count in state_dict.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import importlib  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from neurosis_tpu_torch.optimizers import adamw8bit as tq  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

jq = importlib.import_module("neurosis_tpu.optimizers.adamw8bit")  # the package exports a function of that name


def _codes_agree(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1.0, 1e3])
def test_signed_roundtrip_relative_error_and_jax_codes(scale):
    x = np.random.RandomState(0).randn(4096).astype(np.float32) * scale
    codes, s = tq.quantize_signed(torch.tensor(x), 256)
    y = tq.dequantize_signed(codes, s, x.shape).numpy()
    rel = np.abs(y - x) / np.maximum(np.abs(x), 1e-30)
    big = np.abs(x) > s.numpy().max() * 1e-6  # more than 7 decades under the absmax collapse to 0
    assert float(np.max(rel[big])) < 0.07  # 7 decades over 126 steps: half a step is 6.6%
    q = jq._quantize_signed(jnp.asarray(x.copy()), 256)
    _codes_agree(codes.numpy(), np.asarray(q.codes))
    np.testing.assert_array_equal(s.numpy(), np.asarray(q.scale))


@pytest.mark.parametrize("scale", [1e-8, 1e-2, 10.0])
def test_unsigned_roundtrip_relative_error_and_jax_codes(scale):
    x = (np.random.RandomState(1).rand(4096).astype(np.float32) + 1e-4) * scale
    codes, s = tq.quantize_unsigned(torch.tensor(x), 256)
    assert codes.dtype == torch.uint8
    y = tq.dequantize_unsigned(codes, s, x.shape).numpy()
    assert float(np.max(np.abs(y - x) / x)) < 0.05  # 10 decades over 254 steps: half a step is 4.6%
    q = jq._quantize_unsigned(jnp.asarray(x.copy()), 256)
    _codes_agree(codes.numpy(), np.asarray(q.codes).view(np.uint8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(q.scale))
    # the same codes dequantize to JAX's values
    want = np.asarray(jq._dequantize_unsigned(jq.Quantized8bit(jnp.asarray(codes.numpy().view(np.int8)),
                                                                jnp.asarray(s.numpy())), x.size, x.shape))
    np.testing.assert_allclose(y, want, rtol=1e-6)


def test_zero_and_padding():
    codes, s = tq.quantize_signed(torch.zeros(300), 256)  # padded to 2 blocks of 256
    assert codes.shape == (2, 256) and not codes.any() and not s.any()
    np.testing.assert_array_equal(tq.dequantize_signed(codes, s, (300,)).numpy(), 0.0)


def _jax_run(params, grads, lr, wd):
    tx = jq.adamw8bit(lr, weight_decay=wd)
    p = {k: jnp.asarray(v.copy()) for k, v in params.items()}
    state = tx.init(p)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v.copy()) for k, v in g.items()}, state, p)
        p = optax.apply_updates(p, u)
    return p, state[0]


def test_five_updates_match_jax():
    rng = np.random.RandomState(3)
    params = {"big": rng.randn(64, 128).astype(np.float32) * 0.05, "small": rng.randn(16).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 1e-2 for k, v in params.items()} for _ in range(5)]
    lr, wd = 1e-3, 1e-2
    jp, js = _jax_run(params, grads, lr, wd)

    ps = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    opt = tq.AdamW8bit(list(ps.values()), learning_rate=lr, weight_decay=wd)
    for g in grads:
        for k, p in ps.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    assert opt.count == 5 and int(js.count) == 5
    st = opt.state[ps["big"]]
    _codes_agree(st["mu_codes"].numpy(), np.asarray(js.mu["big"].codes))
    _codes_agree(st["nu_codes"].numpy(), np.asarray(js.nu["big"].codes).view(np.uint8))
    np.testing.assert_allclose(st["mu_scale"].numpy(), np.asarray(js.mu["big"].scale), rtol=1e-6)
    np.testing.assert_allclose(st["nu_scale"].numpy(), np.asarray(js.nu["big"].scale), rtol=1e-6)
    small = opt.state[ps["small"]]
    np.testing.assert_allclose(small["mu"].numpy(), np.asarray(js.mu["small"]), rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(small["nu"].numpy(), np.asarray(js.nu["small"]), rtol=1e-6, atol=1e-12)
    for k, p in ps.items():
        moved = np.abs(np.asarray(jp[k]) - params[k]).max()
        assert moved > 4 * lr  # five updates of about lr each
        assert np.abs(p.detach().numpy() - np.asarray(jp[k])).max() <= 1e-6 * np.abs(params[k]).max() + 1e-8, k


def test_trajectory_tracks_fp32_adamw_and_jax():
    """50 steps on a noisy quadratic (the noise from numpy, the same on every side)."""
    rng = np.random.RandomState(2)
    target = rng.randn(128, 64).astype(np.float32)
    noise = [rng.randn(128, 64).astype(np.float32) * 0.01 for _ in range(50)]
    lr, wd = 3e-2, 1e-3

    def torch_run(opt_cls, **kw):
        w = torch.nn.Parameter(torch.zeros(128, 64))
        opt = opt_cls([w], **kw)
        losses = []
        for n in noise:
            loss = torch.mean(torch.square(w - torch.tensor(target) + torch.tensor(n)))
            w.grad = None
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return w.detach().numpy(), losses

    w8, l8 = torch_run(tq.AdamW8bit, learning_rate=lr, weight_decay=wd, min_8bit_size=1024)
    w32, _ = torch_run(torch.optim.AdamW, lr=lr, weight_decay=wd)
    assert l8[-1] < 0.25 * l8[0]
    ref = np.mean(np.abs(w32))
    assert np.mean(np.abs(w8 - w32)) < 0.05 * ref

    tx = jq.adamw8bit(lr, weight_decay=wd, min_8bit_size=1024)
    p = {"w": jnp.zeros((128, 64), jnp.float32)}
    state = tx.init(p)

    @jax.jit
    def step(p, state, n):
        g = jax.grad(lambda q: jnp.mean(jnp.square(q["w"] - jnp.asarray(target) + n)))(p)
        u, state = tx.update(g, state, p)
        return optax.apply_updates(p, u), state

    for n in noise:
        p, state = step(p, state, jnp.asarray(n.copy()))
    assert np.mean(np.abs(w8 - np.asarray(p["w"]))) < 0.01 * ref


def test_state_layout_and_registry():
    from neurosis_tpu_torch.config.registry import resolve_class_path
    from neurosis_tpu_torch.trainer.builder import build_optimizer

    assert resolve_class_path("bitsandbytes.optim.AdamW8bit") is tq.AdamW8bit
    big, small = torch.nn.Parameter(torch.ones(64, 128)), torch.nn.Parameter(torch.ones(16))
    opt = build_optimizer({"class_path": "bitsandbytes.optim.AdamW8bit", "init_args": {"lr": 1e-4}})([big, small])
    assert isinstance(opt, tq.AdamW8bit) and opt.defaults["lr"] == 1e-4 and opt.defaults["weight_decay"] == 1e-2
    big.grad, small.grad = torch.full_like(big, 0.1), torch.full_like(small, 0.1)
    opt.step()
    st = opt.state[big]
    assert st["mu_codes"].dtype == torch.int8 and st["nu_codes"].dtype == torch.uint8
    assert st["mu_scale"].dtype == torch.float32 and st["mu_codes"].shape == (32, 256)
    assert (st["mu_codes"].numel() + 4 * st["mu_scale"].numel()) / big.numel() <= 1.1
    assert set(opt.state[small]) == {"mu", "nu"} and opt.state[small]["mu"].dtype == torch.float32
    saved = opt.state_dict()
    assert saved["count"] == 1
    again = tq.AdamW8bit([torch.nn.Parameter(torch.ones(64, 128)), torch.nn.Parameter(torch.ones(16))],
                         learning_rate=1e-4)
    again.load_state_dict(saved)
    assert again.count == 1 and torch.equal(next(iter(again.state.values()))["mu_codes"], st["mu_codes"])
