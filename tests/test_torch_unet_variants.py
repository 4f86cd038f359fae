"""The UNet's options against the JAX package on the CPU, and the remat
policies and dropout of the port's UNet.

Three tiny UNets cover every option of the config surface between them
(scale-shift norm, ResBlock up/down, conv_resample off, per-level attention
block counts, disabled self-attention per level and in the middle, no middle
transformer, dropout, linear projections, and the class-count, continuous
and timestep label embeddings). Each loads JAX's parameters through
``jax_params_to_state_dict`` with ``strict=True``; output to 1e-5 of its
largest value, every parameter's grad to 2e-4 of its own largest, or of 1e-3
of the largest grad anywhere for a grad that is ~0 (a conv bias before a
GroupNorm), as the other parity tests hold grads (fp32).

Every remat policy, one and per level, gives the loss and grads of
``none`` to 1e-6 (fp32), dropout on included: the recompute draws the
forward's masks. Dropout without a generator (eval) is the identity, at
p = 0 it draws nothing, and in training its keep share is within a
binomial bound of 1 − p.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import check_grads, load_into, one_torch_thread, perturb, rel_err  # noqa: E402,F401


CPU = "cpu"
BASE = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=[2],
            channel_mult=[1, 2], num_heads=2, context_dim=16)
VARIANTS = {
    "scale_shift_updown_classes": dict(use_scale_shift_norm=True, resblock_updown=True, num_classes=10,
                                       dropout=0.1, disable_middle_transformer=True),
    "no_resample_attention_counts": dict(conv_resample=False, num_res_blocks=2, num_attention_blocks=[0, 1],
                                         attention_resolutions=[1, 2], disable_self_attentions=[False, True],
                                         num_classes="continuous"),
    "middle_cross_only_timestep": dict(disable_middle_self_attn=True, num_classes="timestep",
                                       use_linear_in_transformer=True),
}


def _inputs(seed, num_classes):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    ts = np.array([3.0, 700.0], np.float32)
    ctx = rng.randn(2, 5, 16).astype(np.float32)
    y = None
    if isinstance(num_classes, int):
        y = np.array([1, 7], np.int32)
    elif num_classes is not None:
        y = np.array([0.3, 2.5], np.float32)  # a label in a normalised range: a large one scales the whole emb
    return x, ts, ctx, y


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_unet_variant_matches_jax(name):
    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu_torch.models.unet import UNetModel

    cfg = dict(BASE, **VARIANTS[name])
    x, ts, ctx, y = _inputs(len(name), cfg.get("num_classes"))
    jx, jt, jc = (jnp.asarray(a.copy()) for a in (x, ts, ctx))
    jy = None if y is None else jnp.asarray(y.copy())
    junet = JUNet(**cfg)
    p = perturb(junet.init(jax.random.PRNGKey(0), jx, jt, jc, y=jy)["params"], 4)

    def jloss(params):
        out = junet.apply({"params": params}, jx, jt, jc, y=jy)
        return jnp.sum(out * jnp.cos(jnp.arange(out.size).reshape(out.shape) * 0.01)), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)

    unet = UNetModel(**cfg, device=CPU)
    load_into(unet, p)  # strict=True: every variant keeps the reference's parameter names
    ty = None if y is None else torch.tensor(y.astype(np.int64) if y.dtype == np.int32 else y)
    out = unet(torch.tensor(x), torch.tensor(ts), torch.tensor(ctx), y=ty)
    (out * torch.cos(torch.arange(out.numel()).reshape(out.shape) * 0.01)).sum().backward()
    assert rel_err(out.detach().numpy(), want) < 1e-5
    check_grads(unet, jgrads, 2e-4)


def _remat_unet(policy, dropout=0.0):
    from neurosis_tpu_torch.models.unet import UNetModel

    cfg = dict(BASE, attention_resolutions=[1, 2], transformer_depth=[1, 2], use_checkpoint=True,
               remat_policy=policy, dropout=dropout)
    return UNetModel(**cfg, device=CPU, generator=torch.Generator().manual_seed(0))


def _loss_and_grads(unet, generator=None):
    x, ts, ctx, _ = _inputs(1, None)
    for p in unet.parameters():
        p.grad = None
    out = unet(torch.tensor(x), torch.tensor(ts), torch.tensor(ctx), generator=generator)
    loss = (out * torch.tanh(out)).mean()
    loss.backward()
    return float(loss), {n: p.grad.clone() for n, p in unet.named_parameters()}


@pytest.mark.parametrize("policy,dropout", [(p, 0.2) for p in ("full", "dots", "dots_all", "names", "dots_names")]
                         + [(["none", "dots_names"], 0.2), (["full", "names"], 0.0), (["dots", "dots_all"], 0.2),
                            ("dots_names", 0.0)])
def test_remat_policies_give_the_loss_and_grads_of_none(policy, dropout):
    ref = _remat_unet("none", dropout)
    state = {k: v.clone() for k, v in ref.state_dict().items()}
    with torch.no_grad():  # zero-initialised outputs would hide the blocks' grads
        for p in ref.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
        state = {k: v.clone() for k, v in ref.state_dict().items()}
    gen = (lambda: torch.Generator().manual_seed(5)) if dropout else (lambda: None)
    want_loss, want = _loss_and_grads(ref, gen())
    unet = _remat_unet(policy, dropout)
    unet.load_state_dict(state)
    got_loss, got = _loss_and_grads(unet, gen())
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
    for n in want:
        assert float((got[n] - want[n]).abs().max()) <= 1e-6 * max(float(want[n].abs().max()), 1e-12), n


def test_remat_policy_is_per_level_and_checked():
    from neurosis_tpu_torch.modules.attention import SpatialTransformer

    unet = _remat_unet(["none", "dots_names"])
    policies = {(type(m).__name__, m.remat_policy) for m in unet.modules() if isinstance(m, SpatialTransformer)}
    assert policies == {("SpatialTransformer", "none"), ("SpatialTransformer", "dots_names")}
    with pytest.raises(ValueError, match="remat_policy"):
        _remat_unet("everything")


def test_dropout_eval_zero_and_keep_share():
    from neurosis_tpu_torch.modules.layers import dropout

    x = torch.randn(64, 64)
    assert dropout(x, 0.3, None) is x  # no generator: deterministic, as JAX's deterministic=True
    assert dropout(x, 0.0, torch.Generator()) is x
    n, p = 400_000, 0.1
    y = dropout(torch.ones(n), p, torch.Generator().manual_seed(0))
    kept = int((y != 0).sum())
    assert abs(kept - n * (1 - p)) <= 5 * (n * p * (1 - p)) ** 0.5  # five binomial standard deviations
    assert torch.allclose(y[y != 0], torch.full((kept,), 1 / (1 - p)))
    # a dropout UNet without a generator is the UNet at dropout 0
    a, b = _remat_unet("none", 0.3), _remat_unet("none", 0.0)
    b.load_state_dict(a.state_dict())
    x, ts, ctx, _ = _inputs(2, None)
    with torch.no_grad():
        assert torch.equal(a(torch.tensor(x), torch.tensor(ts), torch.tensor(ctx)),
                           b(torch.tensor(x), torch.tensor(ts), torch.tensor(ctx)))
