"""``trainer.wandb_watch_steps`` and ``HFHubCheckpoint`` against the JAX
package on the CPU, under stub ``wandb`` and ``huggingface_hub`` modules.

The watch: a CLI fit of sd15-tiny with ``wandb_watch_steps: 2`` logs at
steps 2 and 4, and each payload (its group keys, in order, and every array)
equals what JAX's ``Trainer._wandb_watch`` logs for the same weights: the
port's parameters at each watch, imported into JAX's tree by the JAX
package's own ``import_torch_params``. The VAE trainer's groups likewise, and
a failing histogram is logged, not raised.

The hub callback: the calls its ``HfApi`` receives are JAX's callback's, the
exported file is tensor-equal to JAX's ``export_sgm_checkpoint`` of the same
weights, off-cadence steps do nothing, and a raising stub is logged, not
raised.
"""

import concurrent.futures
import dataclasses
import logging
import re
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "configs" / "smoke" / "sd15-tiny.yaml"
VAE_TINY = ROOT / "configs" / "smoke" / "vae-tiny.yaml"


class Histogram:
    def __init__(self, values):
        self.values = np.array(values)


class Run:
    def __init__(self):
        self.logs = []

    def log(self, payload, step=None):
        self.logs.append((step, payload))


@pytest.fixture()
def stub_wandb(monkeypatch):
    mod = types.ModuleType("wandb")
    mod.Histogram = Histogram
    mod.runs = []

    def init(**_):
        mod.runs.append(Run())
        return mod.runs[-1]

    mod.init = init
    monkeypatch.setitem(sys.modules, "wandb", mod)
    return mod


def _write_folder(folder: Path, n: int = 3) -> Path:
    from neurosis_tpu_torch.data.png import write_png

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(folder / f"img_{i}.png", (rng.rand(80, 96, 3) * 255).astype(np.uint8))
        (folder / f"img_{i}.txt").write_text(f"tag{i}, a test image")
    return folder


@pytest.fixture()
def smoke(tmp_path, monkeypatch):
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(_write_folder(tmp_path / "data")))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    monkeypatch.setenv("NEUROSIS_ALLOW_HASH_TOKENIZER", "1")
    return tmp_path


def _jax_template(cfg: dict):
    """JAX's engine for ``cfg`` and its init, abstractly evaluated."""
    from neurosis_tpu.trainer.builder import apply_precision, build_engine

    engine = apply_precision(build_engine(cfg["model"]), (cfg.get("trainer") or {}).get("precision"))
    s = jax.ShapeDtypeStruct
    if "ddconfig" in cfg["model"]["init_args"]:
        return engine, jax.eval_shape(engine.init, jax.random.PRNGKey(0), {"image": s((1, 64, 64, 3), jnp.uint8)})
    light = dataclasses.replace(engine, optimizer=None, use_ema=False)
    return engine, jax.eval_shape(light.init, jax.random.PRNGKey(0), {"image": s((1, 64, 64, 3), jnp.uint8),
                                                                     "caption_ids": s((1, 77), jnp.int32)})


def _imported(template: dict, named: dict) -> dict:
    """The port's weights ({key: array}) in JAX's tree, by JAX's importer."""
    from neurosis_tpu.checkpoint import import_torch_params

    out = {}
    for top, tree in template.items():
        if not jax.tree_util.tree_leaves(tree):
            out[top] = {}
            continue
        sd = {k: np.array(v) for k, v in named.items() if k.startswith(top + ".")}
        out[top], missing, unexpected = import_torch_params(tree, sd, prefix=top + ".")
        assert not missing and not unexpected, (top, missing[:3], unexpected[:3])
    return out


def _jax_watch(params: dict, step: int, every: int) -> list:
    from neurosis_tpu.trainer.loop import Trainer as JaxTrainer

    run = Run()
    JaxTrainer._wandb_watch(SimpleNamespace(wandb_watch_steps=every, logger=SimpleNamespace(wandb=run)),
                            SimpleNamespace(params=params), step)
    return run.logs


def _assert_same_payload(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].values, want[k].values, err_msg=k)


def _named(engine) -> dict:
    from neurosis_tpu_torch.trainer.callbacks import _named_params

    return {k: p.detach().numpy().copy() for k, p in _named_params(engine)}


def test_a_cli_fit_logs_jax_s_histograms_on_the_watch_cadence(smoke, stub_wandb, monkeypatch):
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.trainer import watch
    from neurosis_tpu_torch.trainer.cli import main

    text = TINY.read_text()
    for old, new in (("  max_steps: 1\n", "  max_steps: 4\n  wandb_watch_steps: 2\n  logger:\n"
                                          "    - class_path: lightning.pytorch.loggers.WandbLogger\n"
                                          "      init_args:\n        project: watch\n"),
                     ("  fast_dev_run: true\n", "")):
        assert text.count(old) == 1
        text = text.replace(old, new)
    config = smoke / "watch.yaml"
    config.write_text(text)
    snapshots = []
    arrays = watch.device_arrays

    def recorded(engine):
        snapshots.append(_named(engine))
        return arrays(engine)

    monkeypatch.setattr(watch, "device_arrays", recorded)
    assert main(["fit", "-c", str(config), "--device", "cpu"]) == 0

    (run,) = stub_wandb.runs
    logged = [(s, p) for s, p in run.logs if any(k.startswith("parameters/") for k in p)]
    assert [s for s, _ in logged] == [2, 4] and len(snapshots) == 2
    _, (template, _) = _jax_template(load_config(config))
    for (step, payload), named in zip(logged, snapshots):
        ((jstep, want),) = _jax_watch(_imported(template.params, named), step, 2)
        assert jstep == step and "parameters/model/input_blocks.3.1" in want
        _assert_same_payload(payload, want)
    assert not (set(snapshots[0]) ^ set(snapshots[1])) and any(
        not np.array_equal(snapshots[0][k], snapshots[1][k]) for k in snapshots[0])  # it trained in between


def test_the_vae_trainer_s_histograms_are_jax_s(smoke, stub_wandb):
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.trainer.builder import build_engine
    from neurosis_tpu_torch.trainer.loop import Trainer

    cfg = load_config(VAE_TINY)
    engine = build_engine(cfg["model"], device="cpu", generator=torch.Generator().manual_seed(0))
    run = Run()
    trainer = SimpleNamespace(wandb_watch_steps=3, logger=SimpleNamespace(wandb=run), _watch_gathers=False,
                              device=torch.device("cpu"), engine=engine, last_watch=None)
    Trainer._wandb_watch(trainer, 5)  # off the cadence
    Trainer._wandb_watch(trainer, 6)
    _, state = _jax_template(cfg)
    ((step, want),) = _jax_watch(_imported(state.params, _named(engine)), 6, 3)
    assert [s for s, _ in run.logs] == [6] == [step] and trainer.last_watch["groups"] == [
        k.split("/", 1)[1] for k in want]
    assert {k.split("/")[1] for k in want} == {"decoder", "encoder", "loss"}
    _assert_same_payload(run.logs[0][1], want)


def test_a_failing_watch_is_logged_not_raised(stub_wandb, caplog):
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.trainer.loop import Trainer

    def broken(values):
        raise RuntimeError("no histogram")

    stub_wandb.Histogram = broken
    engine = SimpleNamespace(model=UNetModel(4, 32, 4, 1, [], channel_mult=[1], device="cpu"))
    engine.named_trainable_parameters = lambda: [("model." + n, p) for n, p in engine.model.named_parameters()]
    trainer = SimpleNamespace(wandb_watch_steps=1, logger=SimpleNamespace(wandb=Run()), _watch_gathers=False,
                              device=torch.device("cpu"), engine=engine, last_watch=None)
    with caplog.at_level(logging.ERROR):
        Trainer._wandb_watch(trainer, 1)
    assert "wandb watch logging failed" in caplog.text and not trainer.logger.wandb.logs


# -- HFHubCheckpoint ----------------------------------------------------------------


class HfApi:
    calls: list = []
    fail: bool = False

    def create_repo(self, repo_id, private=None, exist_ok=None):
        if self.fail:
            raise ConnectionError("no network")
        self.calls.append(("create_repo", repo_id, private, exist_ok))

    def upload_file(self, path_or_fileobj, path_in_repo, repo_id, run_as_future=False):
        self.calls.append(("upload_file", Path(path_or_fileobj).name, path_in_repo, repo_id, run_as_future))
        fut = concurrent.futures.Future()
        fut.set_result(path_in_repo)
        return fut


@pytest.fixture()
def stub_hub(monkeypatch):
    mod = types.ModuleType("huggingface_hub")
    api = type("HfApi", (HfApi,), {"calls": [], "fail": False})
    mod.HfApi = api
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    return api


def test_the_hub_checkpoint_makes_jax_s_calls_and_file(smoke, stub_hub):
    from neurosis_tpu.trainer.callbacks import HFHubCheckpoint as JaxHub
    from safetensors.numpy import load_file as jax_load

    from neurosis_tpu_torch.checkpoint.safetensors import load_file
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.config.registry import resolve_class_path
    from neurosis_tpu_torch.trainer.builder import build_engine
    from neurosis_tpu_torch.trainer.callbacks import HFHubCheckpoint

    cfg = load_config(TINY)
    engine = build_engine(cfg["model"], "bf16-mixed", device="cpu", generator=torch.Generator().manual_seed(0))
    state = engine.init(seed=0)
    with torch.no_grad():  # every tensor takes part (zero-initialised layers too)
        for p in engine.model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.02)
    port = resolve_class_path("neurosis_tpu.trainer.callbacks.HFHubCheckpoint")(repo_id="me/run", private=False)
    assert port.path_in_repo == "checkpoints" and type(port) is HFHubCheckpoint
    trainer = SimpleNamespace(root_dir=smoke / "port", engine=engine, mesh=None)
    port.on_train_batch_end(trainer, state, None, {}, 999)
    assert not stub_hub.calls and not (smoke / "port").exists()
    port.every_n_train_steps = 999
    port.on_train_batch_end(trainer, state, None, {}, 999)
    port.on_fit_end(trainer, state)
    port_calls, stub_hub.calls[:] = list(stub_hub.calls), []

    jengine, (jstate, jfrozen) = _jax_template(cfg)
    named = {f"model.{k}": v.numpy().copy() for k, v in engine.model.state_dict().items()}
    named.update({f"conditioner.{k}": v.numpy().copy() for k, v in engine.conditioner.state_dict().items()})
    named.update({f"first_stage.{k}": v.numpy().copy() for k, v in engine.first_stage.state_dict().items()})
    # JAX's tree names the embedders 'embedders_N' (its export writes 'embedders.N')
    named = {re.sub(r"^conditioner\.embedders\.(\d+)", r"conditioner.embedders_\1", k): v for k, v in named.items()}
    frozen = _imported({"conditioner": jfrozen["conditioner"], "first_stage": jfrozen["first_stage"]}, named)
    jstate = SimpleNamespace(params=_imported({"model": jstate.params["model"]}, named), ema=None)
    jax_cb = JaxHub(repo_id="me/run", every_n_train_steps=999, private=False)
    jax_cb.on_train_batch_end(SimpleNamespace(root_dir=smoke / "jax", engine=jengine), jstate, frozen, None, {}, 999)
    jax_cb.on_fit_end(None, jstate)
    assert port_calls == stub_hub.calls == [
        ("create_repo", "me/run", False, True),
        ("upload_file", "step_00000999.safetensors", "checkpoints/step_00000999.safetensors", "me/run", True)]

    got = load_file(smoke / "port" / "hub" / "step_00000999.safetensors")
    want = jax_load(str(smoke / "jax" / "hub" / "step_00000999.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert port.last_export["bytes"] == (smoke / "port" / "hub" / "step_00000999.safetensors").stat().st_size


def test_a_failing_hub_upload_is_logged_not_raised(smoke, stub_hub, caplog):
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.trainer.callbacks import HFHubCheckpoint

    engine = SimpleNamespace(model=UNetModel(4, 32, 4, 1, [], channel_mult=[1], device="cpu"), conditioner=None,
                             first_stage=None)
    cb = HFHubCheckpoint("me/run", every_n_train_steps=1)
    trainer = SimpleNamespace(root_dir=smoke, engine=engine, mesh=None)
    stub_hub.fail = True
    with caplog.at_level(logging.ERROR):
        cb.on_train_batch_end(trainer, SimpleNamespace(ema=None), None, {}, 1)
    assert "HF hub checkpoint upload failed" in caplog.text and not cb._futures
    assert (smoke / "hub" / "step_00000001.safetensors").exists()  # exported, then the repo call failed
    stub_hub.fail = False
    failed = concurrent.futures.Future()
    failed.set_exception(TimeoutError("upload"))
    cb._futures = [failed]
    with caplog.at_level(logging.ERROR):
        cb.on_fit_end(trainer, None)
    assert "pending HF upload failed" in caplog.text
