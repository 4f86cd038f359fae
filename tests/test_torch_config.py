"""The port's config layer against the JAX package's: its own YAML reader
against ``yaml.safe_load`` on every file under ``configs/`` and on the YAML
1.1 scalar edge cases, refusals of what it does not read (with the line),
the ``${...}`` interpolation, and the class_path registry (every path the
JAX registry or a model config names resolves to a port class or raises
NotImplementedError naming its ROADMAP item). Exact equality throughout."""

import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
yaml = pytest.importorskip("yaml")

ROOT = Path(__file__).resolve().parents[1]
CONFIG_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "configs").rglob("*") if p.is_file())
MODEL_CONFIGS = sorted(str(p.relative_to(ROOT)) for sub in ("sd15", "sdxl", "smoke", "vae")
                       for p in (ROOT / "configs" / sub).glob("*.yaml"))


def _same(a, b) -> bool:
    """Equality that also holds NaN equal to NaN and keeps bool apart from int."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_reader_equals_pyyaml_on_every_config(path):
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    text = (ROOT / path).read_text()
    assert _same(safe_load(text, path), yaml.safe_load(text))


@pytest.mark.parametrize("text", [
    "a: 1e-4", "a: 4.5e-6", "a: 1.0e-6", "a: 1.5e6", "a: yes", "a: No", "a: on", "a: OFF", "a: true", "a: ~",
    "a: null", "a:", "a: 010", "a: 0x1F", "a: 0b101", "a: 1_000", "a: -3", "a: +7", "a: 1:30", "a: .5", "a: -.inf",
    "a: .nan", "a: 0o7", "a: [1, 2]", "a: [none, none, dots_names]", "a: [1, [2, 'x y'], \"q\\n\", ]", "a: []",
    "a: it's", "a: 'it''s' # comment", "a: b#c", "a: b # c", "'k': v", "\"k\": v", "on: 1", "1: one",
    "a:\n- 1\n- 2\nb: 3", "- a: 1\n  b: 2\n- c", "a:\n  - x: 1\n    y:\n      - 2\n  - 3",
    "a: ${oc.env:NAME,./x}", "a: tcp://localhost:1", "a: x:y", "a:  spaced  ", "# only a comment", "",
])
def test_reader_edge_cases_equal_pyyaml(text):
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    assert _same(safe_load(text), yaml.safe_load(text)), text


def test_reader_scalar_resolution_examples():
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    cfg = safe_load("lr: 1e-4\nlr2: 4.5e-6\nflag: yes\nremat: [none, none, dots_names]\n")
    assert cfg == {"lr": "1e-4", "lr2": 4.5e-6, "flag": True, "remat": ["none", "none", "dots_names"]}


@pytest.mark.parametrize("text,line", [
    ("a: &x 1", 1), ("a: 1\nb: *x", 2), ("a: !!str 1", 1), ("a: |\n  x", 1), ("a: >\n  x", 1),
    ("a: 1\nb: {c: 1}", 2), ("a:\n\tb: 1", 2), ("a: b\n  c", 2), ("? a\n: b", 1), ("<<: x", 1),
    ("a: [1,\n 2]", 1), ("a: 'x\n  y'", 1), ("a: 2001-12-14", 1), ("---\na: 1", 1), ("a: b: c", 1),
    ("a: 1\n  - 2", 2), ("a: \"\\q\"", 1),
])
def test_reader_refuses_what_it_does_not_read(text, line):
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    with pytest.raises(ValueError, match=rf"^f\.yaml:{line}: "):
        safe_load(text, "f.yaml")


def test_config_loader_interpolation(tmp_path, monkeypatch):
    """The twin of tests/test_cli_smoke.py's interpolation test, plus a
    typed whole-string interpolation and a set environment variable."""
    from neurosis_tpu_torch.config.loader import load_config

    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text("a:\n  b: hello\n  n: 3\nc: ${a.b}\nd: ${oc.env:NEUROSIS_TEST_ENVVAR,fallback}\n"
                        "e: ${a.n}\nf: x-${a.b}-${a.n}\ng: ${oc.env:NEUROSIS_TEST_SET,unused}\n")
    monkeypatch.delenv("NEUROSIS_TEST_ENVVAR", raising=False)
    monkeypatch.setenv("NEUROSIS_TEST_SET", "set")
    cfg = load_config(cfg_path)
    assert cfg["c"] == "hello"
    assert cfg["d"] == "fallback"
    assert cfg["e"] == 3 and cfg["f"] == "x-hello-3" and cfg["g"] == "set"


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_loader_equals_jax_loader(path):
    """load_config (reader + interpolation) gives the JAX package's dict."""
    pytest.importorskip("jax")
    from neurosis_tpu.config.loader import load_config as jax_load

    from neurosis_tpu_torch.config.loader import load_config

    assert _same(load_config(ROOT / path), jax_load(ROOT / path))


def _class_paths(node, out):
    if isinstance(node, dict):
        if isinstance(node.get("class_path"), str):
            out.add(node["class_path"])
        for v in node.values():
            _class_paths(v, out)
    elif isinstance(node, list):
        for v in node:
            _class_paths(v, out)
    return out


def _resolves_or_names_its_item(path: str):
    from neurosis_tpu_torch.config.registry import resolve_class_path

    try:
        obj = resolve_class_path(path)
    except NotImplementedError as e:
        assert "ROADMAP Queue 1 item" in str(e), (path, str(e))
        return None
    assert callable(obj) and obj.__module__.startswith(("neurosis_tpu_torch.", "torch.")), (path, obj)
    return obj


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_every_class_path_of_the_configs_resolves_or_names_its_item(config):
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    paths = _class_paths(safe_load((ROOT / config).read_text(), config), set())
    assert paths
    for path in sorted(paths):
        _resolves_or_names_its_item(path)


def test_every_jax_registry_path_resolves_or_names_its_item():
    pytest.importorskip("jax")
    from neurosis_tpu.config import registry as jax_registry

    from neurosis_tpu_torch.config.registry import known_paths

    jax_registry.resolve_class_path("neurosis.modules.diffusion.UNetModel")  # populates the registry
    paths = set(jax_registry.REGISTRY) | {"bitsandbytes.optim.AdamW8bit"}
    assert paths <= set(known_paths())
    ported = [p for p in sorted(paths) if _resolves_or_names_its_item(p) is not None]
    assert len(ported) >= 40


def test_registry_maps_torch_and_optax_optimizers():
    from neurosis_tpu_torch.config.registry import resolve_class_path
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.optimizers.adamw import adamw

    assert resolve_class_path("neurosis.modules.diffusion.UNetModel") is UNetModel
    assert resolve_class_path("torch.optim.AdamW") is torch.optim.AdamW  # torch's own, not optax's
    assert resolve_class_path("optax.adamw") is adamw
    opt = adamw([torch.nn.Parameter(torch.zeros(2))], 4.5e-6)
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["lr"] == 4.5e-6  # optax's default decay
    with pytest.raises(NotImplementedError, match="item 8"):
        resolve_class_path("optax.lion")
    with pytest.raises(ImportError, match="cannot resolve"):
        resolve_class_path("neurosis_tpu.models.unet.UNetModel")  # no import of the JAX package


def test_instantiate_threads_device_and_generator():
    from neurosis_tpu_torch.config.loader import instantiate

    unet = {"class_path": "neurosis.modules.diffusion.UNetModel",
            "init_args": dict(in_channels=4, out_channels=4, model_channels=32, attention_resolutions=[2],
                              num_res_blocks=1, channel_mult=[1, 2], num_heads=2, context_dim=64,
                              remat_policy=["none", "dots_names"])}
    denoiser = {"class_path": "neurosis.modules.diffusion.DiscreteDenoiser",
                "init_args": {"num_idx": 10, "preconditioning": {
                    "class_path": "neurosis.modules.diffusion.EpsPreconditioning"},
                    "discretization": {"class_path": "neurosis.modules.diffusion.LegacyDDPMDiscretization"}}}
    nets = [instantiate(unet, {"device": torch.device("cpu"), "generator": torch.Generator().manual_seed(3)},
                        dtype=torch.bfloat16) for _ in range(2)]
    assert nets[0].dtype == torch.bfloat16
    for a, b in zip(nets[0].parameters(), nets[1].parameters()):
        assert a.device.type == "cpu" and torch.equal(a, b)
    d = instantiate(denoiser, {"device": torch.device("cpu"), "generator": torch.Generator()})
    assert d.sigmas.device.type == "cpu" and d.sigmas.shape == (11,)


def test_build_optimizer_names_and_refusals():
    """optimizer nodes → params → torch optimizers: ``lr`` and
    ``learning_rate`` reach the one the class takes, the JAX-only
    ``stacked:`` key changes nothing, a scheduler raises (item 8)."""
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.builder import build_optimizer

    params = [torch.nn.Parameter(torch.zeros(3, 2))]
    opt = build_optimizer({"class_path": "torch.optim.AdamW", "init_args": {"learning_rate": 1e-3,
                                                                           "weight_decay": 0.01}})(params)
    assert type(opt) is torch.optim.AdamW and opt.defaults["lr"] == 1e-3 and opt.defaults["weight_decay"] == 0.01
    opt = build_optimizer({"class_path": "optax.adamw", "init_args": {"lr": 2e-4}, "stacked": False})(params)
    assert opt.defaults["lr"] == 2e-4 and opt.defaults["weight_decay"] == 1e-4
    opt = build_optimizer(None)(params)  # the JAX default: optax.adamw(1e-4)
    assert type(opt) is torch.optim.AdamW and opt.defaults["lr"] == 1e-4
    opt = build_optimizer({"class_path": "neurosis.optimizers.Adafactor",
                           "init_args": {"scale_parameter": True, "relative_step": True, "warmup_init": True}})(params)
    assert isinstance(opt, Adafactor) and opt.defaults["warmup_init"]
    with pytest.raises(NotImplementedError, match="item 8"):
        build_optimizer(None, {"class_path": "neurosis.schedulers.CosineWithWarmUp"})
    with pytest.raises(NotImplementedError, match="item 8"):
        build_optimizer({"class_path": "bitsandbytes.optim.AdamW8bit", "init_args": {"lr": 1e-4}})
