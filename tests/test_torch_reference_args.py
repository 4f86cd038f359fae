"""No argument the JAX package honours is dropped in silence.

``neurosis_tpu_torch.config.reference_args.JAX_ONLY_ARGS`` is rebuilt here
from the signatures of the JAX registry's class for every path the port
resolves (through ``**kwargs`` to the base that takes them) and of the
port's class, and must equal the port's table. Every argument still in it is
refused at a value other than JAX's default, naming its ROADMAP item, and
passes at the default; an argument neither package takes is dropped.
"""

import dataclasses
import inspect

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from neurosis_tpu_torch.config import reference_args  # noqa: E402
from neurosis_tpu_torch.config.loader import _parameters, instantiate  # noqa: E402
from neurosis_tpu_torch.config.registry import _PORTED, resolve_class_path  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

_FLAX_FIELDS = {"parent", "name"}


def _jax_parameters(cls) -> dict:
    """{name: default} of what JAX's ``cls`` takes, ``**kwargs`` followed to
    the bases it is passed to."""
    from flax import linen as nn

    if isinstance(cls, type) and issubclass(cls, nn.Module):
        out = {}
        for f in dataclasses.fields(cls):
            if f.name in _FLAX_FIELDS or not f.init:
                continue
            if f.default is not dataclasses.MISSING:
                out[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                out[f.name] = f.default_factory()
            else:
                out[f.name] = reference_args.REQUIRED
        return out
    funcs = [b.__dict__["__init__"] for b in cls.__mro__ if "__init__" in b.__dict__] \
        if isinstance(cls, type) else [cls]
    out = {}
    for fn in funcs:
        if fn is object.__init__:
            break
        params = inspect.signature(fn).parameters
        for n, p in params.items():
            if n != "self" and p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL) and n not in out:
                out[n] = reference_args.REQUIRED if p.default is p.empty else p.default
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return out


def _plain(v):
    return list(_plain(x) for x in v) if isinstance(v, (list, tuple)) else v


def rebuilt_table() -> dict:
    from neurosis_tpu.config import registry as jax_registry

    table = {}
    for path in sorted(_PORTED):
        port = _parameters(resolve_class_path(path))
        if port is None:  # the port's class takes any keyword
            continue
        try:
            jax_cls = jax_registry.resolve_class_path(path)
        except ImportError:  # a path the JAX registry does not know takes nothing there
            continue
        missing = {n: _plain(d) for n, d in _jax_parameters(jax_cls).items() if n not in port}
        if missing:
            table[path] = missing
    return table


def test_the_table_is_jax_signatures_less_the_ports():
    assert rebuilt_table() == reference_args.JAX_ONLY_ARGS


def _port_parameters(cls) -> dict:
    """{name: default} of what the port's ``cls`` takes (the same walk)."""
    funcs = [b.__dict__["__init__"] for b in cls.__mro__ if "__init__" in b.__dict__] \
        if isinstance(cls, type) else [cls]
    out = {}
    for fn in funcs:
        if fn is object.__init__:
            break
        params = inspect.signature(fn).parameters
        for n, p in params.items():
            if n != "self" and p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL) and n not in out:
                out[n] = reference_args.REQUIRED if p.default is p.empty else p.default
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            break
    return out


# (path, argument) whose default differs between the packages, and why no
# config trains differently for it: one side requires what the other
# defaults (a config that omits it fails on that side), or the argument
# names weights that neither package fetches
SHARED_DEFAULTS_THAT_DIFFER = {
    **{(p, "g_optimizer"): "the port's engine requires the optimizer the builder always passes"
       for p in ("neurosis.models.AutoencodingEngine", "neurosis.models.autoencoder.AutoencodingEngine")},
    **{(p, "optimizer"): "the port's engine requires the optimizer the builder always passes"
       for p in ("neurosis.models.DiffusionEngine", "neurosis.models.diffusion.DiffusionEngine")},
    ("neurosis.modules.encoders.GeneralConditioner", "embedders"): "the port requires the embedders",
    **{("neurosis.modules.diffusion.model." + c, "attn_resolutions"): "JAX requires it; the port defaults to none"
       for c in ("Encoder", "Decoder", "Model")},
    ("neurosis.models.text_encoder.FrozenCLIPEmbedder", "version"): "names weights neither package fetches",
}


def _same(a, b) -> bool:
    a, b = _plain(a), _plain(b)
    if isinstance(a, (int, float)) and isinstance(b, (int, float)) and not isinstance(a, bool):
        return float(a) == float(b)
    return a == b


def test_shared_arguments_take_jax_s_defaults():
    """Every argument both packages' classes take has JAX's default in the
    port, for every path the port resolves (the torch.optim ones included),
    but the listed ones, none of which trains differently."""
    from neurosis_tpu.config import registry as jax_registry

    differ = set()
    for path in sorted(_PORTED):
        cls = resolve_class_path(path)
        if _parameters(cls) is None:
            continue
        try:
            jax_cls = jax_registry.resolve_class_path(path)
        except ImportError:
            continue
        jax_args, port_args = _jax_parameters(jax_cls), _port_parameters(cls)
        differ |= {(path, n) for n in set(jax_args) & set(port_args) if not _same(jax_args[n], port_args[n])}
    assert differ == set(SHARED_DEFAULTS_THAT_DIFFER)


@pytest.mark.parametrize("path", ["torch.optim.AdamW", "torch.optim.Adam", "torch.optim.SGD"])
def test_torch_optim_paths_resolve_to_optax_s_counterparts(path):
    """JAX maps the three paths to optax's adamw, adam and sgd; the port to
    its functions of the same names, which take optax's arguments."""
    from neurosis_tpu.config import registry as jax_registry

    jax_fn, port_fn = jax_registry.resolve_class_path(path), resolve_class_path(path)
    assert jax_fn.__module__.startswith("optax") and port_fn.__name__ == jax_fn.__name__
    assert set(_jax_parameters(jax_fn)) - set(_parameters(port_fn)) == set(reference_args.JAX_ONLY_ARGS.get(path, {}))


@pytest.mark.parametrize("path,arg", sorted((p, a) for p, args in reference_args.JAX_ONLY_ARGS.items() for a in args))
def test_an_argument_jax_honours_is_refused_off_its_default(path, arg):
    from neurosis_tpu_torch.config.loader import _adapt_kwargs

    default = reference_args.JAX_ONLY_ARGS[path][arg]
    cls = resolve_class_path(path)
    assert _adapt_kwargs(cls, {arg: default}, path) == {}  # at JAX's default: passes
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item (8|9|10) "):
        _adapt_kwargs(cls, {arg: ("not", "the", "default")}, path)


def test_an_argument_neither_takes_is_dropped():
    node = {"class_path": "neurosis.modules.diffusion.EDMWeighting",
            "init_args": {"sigma_data": 0.5, "verbose": True}}
    w = instantiate(node)
    assert w.sigma_data == 0.5


def test_the_slice_s_arguments_are_honoured():
    """The arguments the port used to drop build what they say."""
    loss = instantiate({"class_path": "neurosis.modules.diffusion.StandardDiffusionLoss", "init_args": {
        "sigma_generator": {"class_path": "neurosis.modules.diffusion.sampling.sigma_generators."
                                          "RectifiedFlowComfySigmaGenerator"},
        "loss_weighting": {"class_path": "neurosis.modules.diffusion.UnitWeighting"},
        "noise_offset": 0.1, "noise_offset_chance": 2.0, "loss_type": "l1", "objective_type": "rf"}})
    assert (loss.loss_type, loss.objective_type, loss.noise_offset, loss.noise_offset_chance) == ("l1", "rf", 0.1, 1.0)
    unet = instantiate({"class_path": "neurosis.modules.diffusion.UNetModel", "init_args": dict(
        in_channels=4, model_channels=32, out_channels=4, num_res_blocks=2, attention_resolutions=[2],
        channel_mult=[1, 2], num_heads=2, context_dim=16, use_scale_shift_norm=True, resblock_updown=True,
        num_attention_blocks=[0, 1])}, {"device": "cpu"})
    assert unet.input_blocks[3][0].down and unet.output_blocks[0][0].emb_layers[1].weight.shape[0] == 128
    assert len(unet.input_blocks[4]) == 2 and len(unet.input_blocks[5]) == 1  # one attention block at level 1
