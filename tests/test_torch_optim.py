"""neurosis_tpu_torch Adafactor, EMA and the global grad norm against the JAX
package (optax.adafactor under the relative-step schedule, LitEma's
ema_update, stacked_global_norm) over three updates on seeded numpy
gradients. Parameters live in torch layout (OIHW, (out, in)) on the port's
side and in JAX layout (HWIO, (in, out)) on the JAX side, so the factored
second moments must pick the same axes. fp32 throughout: 1e-5 of the
largest value for the updated parameters, 1e-6 for the EMA shadows."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import one_torch_thread, rel_err  # noqa: E402,F401

# torch-layout shapes: convs (3x3, 1x1, a tie of C and F), a dense, a bias, a norm scale
SHAPES = {
    "conv": (16, 8, 3, 3),
    "conv_tie": (8, 8, 3, 3),
    "skip": (12, 4, 1, 1),
    "dense": (6, 20),
    "bias": (6,),
    "scale": (1,),
}


def _to_jax_layout(a: np.ndarray) -> np.ndarray:
    if a.ndim == 4:
        return np.ascontiguousarray(a.transpose(2, 3, 1, 0))
    if a.ndim == 2:
        return np.ascontiguousarray(a.T)
    return a.copy()


def _seeded(seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("scale_parameter,warmup_init", [(True, True), (True, False), (False, False)])
def test_adafactor_three_updates(scale_parameter, warmup_init):
    import optax

    from neurosis_tpu.optimizers.adafactor import Adafactor as JAdafactor
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor

    init = _seeded(0)
    init["scale"] *= 1e-4  # below the 1e-3 parameter-scale floor
    grads = [_seeded(s) for s in (1, 2, 3)]
    grads[1]["dense"][0] = 0.0  # a row with no gradient

    jtx = JAdafactor(scale_parameter=scale_parameter, relative_step=True, warmup_init=warmup_init)
    jparams = {k: jnp.asarray(_to_jax_layout(v)) for k, v in init.items()}
    jstate = jtx.init(jparams)
    params = {k: torch.tensor(v.copy()) for k, v in init.items()}
    opt = Adafactor(list(params.values()), scale_parameter=scale_parameter, relative_step=True,
                    warmup_init=warmup_init)
    for g in grads:
        upd, jstate = jtx.update({k: jnp.asarray(_to_jax_layout(v)) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.tensor(g[k].copy())
        opt.step()
        for k, p in params.items():
            want = np.asarray(jparams[k])
            got = _to_jax_layout(p.numpy())
            assert rel_err(got, want) < 1e-5, k
            # the update itself, not only the parameter it moved
            assert rel_err(got - _to_jax_layout(init[k]), want - _to_jax_layout(init[k])) < 1e-4, k


def test_adafactor_refuses_what_is_not_ported():
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor

    p = [torch.zeros(2, 2, requires_grad=True)]
    with pytest.raises(ValueError):
        Adafactor(p, lr=1e-3, relative_step=True)
    with pytest.raises(ValueError):
        Adafactor(p, warmup_init=True, relative_step=False, lr=1e-3)


@pytest.mark.parametrize("use_num_updates", [True, False])
def test_ema_three_updates(use_num_updates):
    from neurosis_tpu.modules.ema import ema_init as jinit
    from neurosis_tpu.modules.ema import ema_update as jupdate
    from neurosis_tpu_torch.modules.ema import ema_init, ema_update

    init = _seeded(4)
    jstate = jinit({k: jnp.asarray(v.copy()) for k, v in init.items()}, use_num_updates)
    state = ema_init([torch.tensor(v.copy()) for v in init.values()], use_num_updates)
    for s in (5, 6, 7):
        new = _seeded(s)
        jstate = jupdate(jstate, {k: jnp.asarray(v.copy()) for k, v in new.items()}, decay=0.999)
        ema_update(state, [torch.tensor(v.copy()) for v in new.values()], decay=0.999)
        assert state.num_updates == int(jstate.num_updates)
        for k, shadow in zip(init, state.params):
            assert rel_err(shadow.numpy(), jstate.params[k]) < 1e-6, k


def test_global_norm():
    from neurosis_tpu.optimizers.stacked import stacked_global_norm
    from neurosis_tpu_torch.trainer.state import global_norm

    g = _seeded(8)
    want = float(stacked_global_norm({k: jnp.asarray(v.copy()) for k, v in g.items()}))
    got = float(global_norm([torch.tensor(v.copy()) for v in g.values()]))
    np.testing.assert_allclose(got, want, rtol=1e-6)
