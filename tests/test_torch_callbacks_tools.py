"""The last callbacks and the checkpoint tools of the port against the JAX
package's, on the CPU: EMATracker's values and ProgressCallback's lines
(exact, the clock faked alike); SaveConfigCallback's config.yaml read back
by the port's YAML reader and by PyYAML to the config (and to what JAX's
callback writes), with the same wandb calls; the CLI's class paths into
the JAX package resolving to the port's callbacks; and every subcommand of
tools/convert.py and tools/blessup.py, tensor-equal (bitwise, dtypes kept)
to JAX's on seeded small safetensors files, config.json byte-equal.
"""

import json
import logging
from types import SimpleNamespace

import numpy as np
import pytest

yaml = pytest.importorskip("yaml")
st = pytest.importorskip("safetensors.numpy")
pytest.importorskip("jax")

import neurosis_tpu.trainer.callbacks as jax_cb  # noqa: E402
import neurosis_tpu_torch.trainer.callbacks as port_cb  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_ema_tracker_is_jax_s():
    values = np.random.RandomState(0).rand(50) * 3
    for steps in (2, 64):
        a, b = jax_cb.EMATracker(steps), port_cb.EMATracker(steps)
        assert [a.update(float(v)) for v in values] == [b.update(float(v)) for v in values]


def test_progress_lines_are_jax_s(monkeypatch, caplog):
    losses = np.random.RandomState(1).rand(9)
    lines, emas = {}, {}
    for name, mod in (("jax", jax_cb), ("port", port_cb)):
        clock = iter(np.arange(100) * 0.25)  # the same clock for both
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
        cb = mod.ProgressCallback(every_n=2)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=mod.logger.name):
            for step, loss in enumerate(losses, start=1):
                metrics = {"loss": float(loss)} if step % 3 else {"total": float(loss)}  # the VAE's key
                args = (None, None, None, metrics, step) if name == "port" else (None, None, None, None, metrics, step)
                cb.on_train_batch_end(*args)
        lines[name] = [r.getMessage() for r in caplog.records if r.name == mod.logger.name]
        emas[name] = cb.ema.value
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 3  # steps 4, 6, 8
    assert emas["port"] == emas["jax"]


class FakeRun:
    def __init__(self):
        self.calls = []
        self.config = SimpleNamespace(update=lambda d, allow_val_change: self.calls.append(("update", sorted(d))))

    def log_artifact(self, path, type):
        self.calls.append(("log_artifact", path.rsplit("/", 1)[-1], type))

    def log_code(self, root):
        self.calls.append(("log_code", root.rsplit("/", 1)[-1]))


def test_save_config_reads_back_in_both_readers(tmp_path):
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.config.yaml_reader import safe_load

    config = load_config(ROOT / "configs" / "sdxl" / "sdxl.example.yaml")
    config["extra"] = {"quoted": ["yes", "1e-4", "x: y", "", "it's", "tab\there", None, 1.0e-6, float("inf"), [],
                                  {}, [[1, 2], {"a": [3]}]], "empty": {}}
    calls = {}
    for name, mod in (("jax", jax_cb), ("port", port_cb)):
        run = FakeRun()
        trainer = SimpleNamespace(root_dir=tmp_path / name, logger=SimpleNamespace(wandb=run))
        mod.SaveConfigCallback(config=config, log_code=True).on_fit_start(trainer, None)
        calls[name] = run.calls
    text = (tmp_path / "port" / "config.yaml").read_text()
    assert safe_load(text) == config == yaml.safe_load(text)
    assert yaml.safe_load((tmp_path / "jax" / "config.yaml").read_text()) == config
    assert calls["port"][:2] == calls["jax"][:2] == [("update", ["resolved_config"]),
                                                      ("log_artifact", "config.yaml", "config")]
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]]


def test_cli_resolves_jax_paths_to_the_port_s_callbacks():
    from neurosis_tpu_torch.trainer.cli import _callbacks

    cfg = {"seed_everything": 1, "trainer": {"callbacks": [
        {"class_path": "neurosis_tpu.trainer.callbacks.ProgressCallback", "init_args": {"every_n": 1}},
        {"class_path": "neurosis_tpu.trainer.callbacks.SaveConfigCallback"},
        {"class_path": "neurosis_tpu.trainer.callbacks.HFHubCheckpoint", "init_args": {"repo_id": "x/y"}}]}}
    progress, save, hub = _callbacks(cfg)
    assert isinstance(progress, port_cb.ProgressCallback) and progress.every_n == 1
    assert isinstance(save, port_cb.SaveConfigCallback) and save.config is cfg
    assert isinstance(hub, port_cb.HFHubCheckpoint) and hub.repo_id == "x/y" and hub.every_n_train_steps == 1000


# -- tools/convert.py and tools/blessup.py -------------------------------------------


def _sgm_file(path, seed: int = 0, prefix: str = "first_stage_model."):
    """A small sgm-layout checkpoint: VAE keys of every kind the diffusers
    remap touches, text-encoder and UNet keys, fp32 and fp16."""
    rng = np.random.RandomState(seed)
    vae = {
        "encoder.conv_in.weight": (8, 3, 3, 3), "encoder.conv_in.bias": (8,),
        "encoder.down.0.block.0.conv1.weight": (8, 8, 3, 3), "encoder.down.0.block.1.nin_shortcut.weight": (8, 8, 1, 1),
        "encoder.down.0.downsample.conv.weight": (8, 8, 3, 3), "encoder.mid.block_1.norm1.weight": (8,),
        "encoder.mid.block_2.conv2.bias": (8,), "encoder.mid.attn_1.q.weight": (8, 8, 1, 1),
        "encoder.mid.attn_1.proj_out.bias": (8,), "encoder.mid.attn_1.norm.weight": (8,),
        "encoder.norm_out.weight": (8,), "decoder.up.0.block.0.nin_shortcut.weight": (8, 8, 1, 1),
        "decoder.up.3.upsample.conv.weight": (8, 8, 3, 3), "decoder.mid.attn_1.v.weight": (8, 8, 1, 1),
        "decoder.norm_out.bias": (8,), "decoder.conv_out.weight": (3, 8, 3, 3), "decoder.conv_out.bias": (3,),
        "quant_conv.weight": (8, 8, 1, 1),
    }
    state = {prefix + k: rng.randn(*s).astype(np.float16 if "conv_out.weight" in k else np.float32)
             for k, s in vae.items()}
    state["cond_stage_model.transformer.embeddings.weight"] = rng.randn(4, 8).astype(np.float32)
    state["conditioner.embedders.0.transformer.final.weight"] = rng.randn(8).astype(np.float32)
    state["conditioner.embedders.1.model.proj"] = rng.randn(8, 4).astype(np.float16)
    state["model.diffusion_model.out.2.weight"] = rng.randn(4, 8).astype(np.float32)
    st.save_file(state, str(path))
    return path


def _same_file(a, b):
    x, y = st.load_file(str(a)), st.load_file(str(b))
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and np.array_equal(x[k], y[k]), k


def _run_both(tmp_path, module: str, argv):
    """The JAX tool and the port's on the same argv, each writing under its
    own directory ({out} in argv)."""
    import importlib

    outs = {}
    for pkg in ("neurosis_tpu", "neurosis_tpu_torch"):
        out = tmp_path / pkg
        assert importlib.import_module(f"{pkg}.tools.{module}").main(
            [str(a).format(out=out) for a in argv]) == 0
        outs[pkg] = out
    return outs["neurosis_tpu"], outs["neurosis_tpu_torch"]


@pytest.mark.parametrize("cmd", ["sd15-ldm2neurosis", "extract-vae", "patch-te"])
def test_convert_is_jax_s(tmp_path, cmd):
    a, b = _sgm_file(tmp_path / "a.safetensors", 0), _sgm_file(tmp_path / "b.safetensors", 1)
    argv = [cmd, a] + ([b] if cmd == "patch-te" else []) + ["{out}/out.safetensors"]
    ref, port = _run_both(tmp_path, "convert", argv)
    _same_file(ref / "out.safetensors", port / "out.safetensors")


@pytest.mark.parametrize("config,extract", [("sdxl", True), ("sd1.5", True), ("sdxl", False)])
def test_vae2hf_is_jax_s(tmp_path, config, extract):
    src = _sgm_file(tmp_path / "vae.safetensors", prefix="first_stage_model." if extract else "")
    argv = ["vae2hf", src, "{out}/hf", "-C", config] + (["--extract"] if extract else [])
    ref, port = _run_both(tmp_path, "convert", argv)
    assert (port / "hf" / "config.json").read_bytes() == (ref / "hf" / "config.json").read_bytes()
    assert json.loads((port / "hf" / "config.json").read_text())["_class_name"] == "AutoencoderKL"
    _same_file(ref / "hf" / "diffusion_pytorch_model.safetensors", port / "hf" / "diffusion_pytorch_model.safetensors")


@pytest.mark.parametrize("args,prefix", [(["--contrast", "1.05", "--brightness", "0.02"], ""),
                                         (["--contrast", "0.97", "--brightness", "-0.1", "--encoder"], ""),
                                         (["--contrast", "0.5", "--contrast-op", "add", "--brightness", "1.5",
                                           "--brightness-op", "mul"], "first_stage_model.")])
def test_bless_is_jax_s(tmp_path, args, prefix):
    src = _sgm_file(tmp_path / "vae.safetensors", prefix=prefix)
    ref, port = _run_both(tmp_path, "blessup", [src, "{out}/blessed.safetensors"] + args)
    _same_file(ref / "blessed.safetensors", port / "blessed.safetensors")
    assert not np.array_equal(st.load_file(str(port / "blessed.safetensors"))[f"{prefix}decoder.conv_out.bias"],
                              st.load_file(str(src))[f"{prefix}decoder.conv_out.bias"]) or "--encoder" in args
