"""The training path's optimizer and normalisation options against the JAX
package on the CPU: Adafactor with ``beta1`` momentum and ``weight_decay``
over five updates (optax.adafactor's chain, relative step and a fixed lr;
1e-6 of the largest value), the memory-saving GroupNorm (forward and grads against
JAX's custom VJP, 1e-5; the ``NEUROSIS_GN_VJP`` gate), and the
tag-frequency loss hook's ``loss_scale`` over a caption stream, exactly."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_optim import _seeded, _to_jax_layout  # noqa: E402
from torch_parity import one_torch_thread, rel_err  # noqa: E402,F401


@pytest.mark.parametrize("kwargs", [dict(beta1=0.9, weight_decay=0.01),
                                    dict(beta1=0.5, weight_decay=0.1, relative_step=False, lr=3e-3),
                                    dict(beta1=0.9, scale_parameter=False)])
def test_adafactor_momentum_and_decay_five_updates(kwargs):
    import optax

    from neurosis_tpu.optimizers.adafactor import Adafactor as JAdafactor
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor

    init = _seeded(0)
    grads = [_seeded(s) for s in range(1, 6)]
    jtx = JAdafactor(**kwargs)
    jparams = {k: jnp.asarray(_to_jax_layout(v)) for k, v in init.items()}
    jstate = jtx.init(jparams)
    params = {k: torch.tensor(v.copy()) for k, v in init.items()}
    opt = Adafactor(list(params.values()), **kwargs)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(_to_jax_layout(v)) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.tensor(g[k].copy())
        opt.step()
        for k, p in params.items():
            assert rel_err(_to_jax_layout(p.numpy()), np.asarray(jparams[k])) < 1e-6, k
    assert all("m" in opt.state[p] for p in params.values())


def test_adafactor_group_lr_scale_scales_decay_and_momentum_as_optax_scale():
    """A group's lr_scale (an embedder's own base_lr) scales the whole
    update, weight decay included, as JAX's optax.scale after the optimizer."""
    import optax

    from neurosis_tpu.optimizers.adafactor import Adafactor as JAdafactor
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor

    init, grads = _seeded(0), [_seeded(s) for s in (1, 2, 3)]
    jtx = optax.chain(JAdafactor(beta1=0.9, weight_decay=0.05), optax.scale(0.25))
    jparams = {k: jnp.asarray(_to_jax_layout(v)) for k, v in init.items()}
    jstate = jtx.init(jparams)
    params = {k: torch.tensor(v.copy()) for k, v in init.items()}
    opt = Adafactor([{"params": list(params.values()), "lr_scale": 0.25}], beta1=0.9, weight_decay=0.05)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(_to_jax_layout(v)) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.tensor(g[k].copy())
        opt.step()
    for k, p in params.items():
        assert rel_err(_to_jax_layout(p.numpy()), np.asarray(jparams[k])) < 1e-6, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_function_matches_jax_custom_vjp(dtype):
    from neurosis_tpu.ops.groupnorm import group_norm as jgn
    from neurosis_tpu_torch.ops.groupnorm import group_norm

    rng = np.random.RandomState(0)
    x = (rng.randn(2, 8, 8, 64) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    dy = rng.randn(2, 8, 8, 64).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x).astype(jdt)
    out, vjp = jax.vjp(lambda a, s, b: jgn(a, s, b, 32, 1e-5), jx, jnp.asarray(scale), jnp.asarray(bias))
    jdx, jds, jdb = vjp(jnp.asarray(dy).astype(jdt))
    tx = torch.tensor(x).to(dtype).requires_grad_(True)
    ts, tb = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    got = group_norm(tx, ts, tb, 32, 1e-5)
    got.backward(torch.tensor(dy).to(dtype))
    tol = 1e-5 if dtype == torch.float32 else 1e-2  # bf16 output: its own rounding (2⁻⁸)
    for g, w in ((got, out), (tx.grad, jdx), (ts.grad, jds), (tb.grad, jdb)):
        assert g.dtype == (dtype if g is got or g is tx.grad else torch.float32)
        assert rel_err(g.detach().float().numpy(), np.asarray(w).astype(np.float32)) < tol


def test_group_norm_gate(monkeypatch):
    """NEUROSIS_GN_VJP=1 routes GroupNorm32 through the function (off by
    default): the same values and grads as the plain path (1e-5)."""
    from neurosis_tpu_torch.modules.layers import GroupNorm32, gn_custom_vjp_enabled

    assert not gn_custom_vjp_enabled()
    norm = GroupNorm32(64, 32, device="cpu")
    with torch.no_grad():
        norm.weight.normal_(generator=torch.Generator().manual_seed(0))
        norm.bias.normal_(generator=torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 8, 64, generator=torch.Generator().manual_seed(2))
    results = []
    for gate in ("0", "1"):
        monkeypatch.setenv("NEUROSIS_GN_VJP", gate)
        xi = x.clone().requires_grad_(True)
        norm.zero_grad()
        y = norm(xi)
        (y * torch.arange(y.numel()).reshape(y.shape).sin()).sum().backward()
        results.append([y.detach(), xi.grad, norm.weight.grad.clone(), norm.bias.grad.clone()])
    for a, b in zip(*results):
        assert rel_err(b.numpy(), a.numpy()) < 1e-5


def test_tag_frequency_hook_over_a_caption_stream():
    """The loss_scale of each batch and the logged metrics equal JAX's hook
    fed the same stream, exactly; the dotted check_fn resolves as JAX's."""
    import yaml

    from neurosis_tpu.config.loader import instantiate as jinstantiate
    from neurosis_tpu_torch.config.loader import instantiate

    node = yaml.safe_load(open("configs/hook/loss_scale.example.yml"))["model"]["init_args"]["forward_hooks"][0]
    jhook, hook = jinstantiate(node), instantiate(node)
    assert hook.check_fn("artist:someone") and not hook.check_fn("1girl")
    rng = np.random.RandomState(0)
    vocab = ["artist:a", "artist:b", "character:c", "masterpiece", "lowres", "watermark", "1girl", "solo", "art:d"]
    for step in range(30):
        captions = [" ".join(rng.choice(vocab, size=rng.randint(1, 6))) for _ in range(4)]
        batch = {"caption": captions}
        got, want = hook.pre_hook(None, None, batch, step), jhook.pre_hook(None, None, batch, step)
        assert got["loss_scale"].dtype == np.float32 and np.array_equal(got["loss_scale"], want["loss_scale"])
        assert hook.batch_hook(None, got, 1.0, {}) == jhook.batch_hook(None, want, 1.0, {})
    assert hook.counts == jhook.counts
