"""The port's training entry point, ``python -m neurosis_tpu_torch``, on the CPU.

(a) fit, validate and test of configs/smoke/sd15-tiny.yaml and fit of
    vae-tiny.yaml with ``--device cpu`` (the twins of tests/test_cli_smoke.py).
(b) The slice as a whole from sd15-tiny.yaml: the JAX package's CLI builder and
    the port's build on one image folder; the first prepared batch is the
    same; JAX's init (UNet perturbed so its zero-init layers take part) goes
    into the port through jax_params_to_state_dict; one step each with the
    same t, noise and posterior noise gives the loss and grad norm within 1e-5
    with trainer.precision removed (fp32), within 2e-2 / 5e-2 as written
    (bf16-mixed UNet on both sides).
(c) Each model config under configs/{sd15,sdxl,smoke,vae} that the port builds
    gives JAX's parameter names and shapes (``jax.eval_shape`` of the init,
    through the key rules; the port's modules on the meta device). Tracing a
    full-size model is not done on the CPU, so both sides build the config
    with its widths cut (channels, tower widths, and the context and label
    widths that follow from them) and its depths, levels, heads and
    layouts as written.
(d) The refusals: more than one device, an image_logger: node with an
    unknown step type, model_checkpoint:, trainer.profiler:, an existing
    checkpoints/ directory (fit and predict), and no CUDA without
    --device cpu.
(e) The tiny fits (each with an image_logger: node) and predict in a
    process where jax, yaml, PIL, pandas, regex and safetensors cannot be
    imported (the card's machine in miniature).
And chip_smoke.py's launch tables of its CLI phase against its fp32 tables.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, perturb, to_np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "configs" / "smoke" / "sd15-tiny.yaml"
VAE_TINY = ROOT / "configs" / "smoke" / "vae-tiny.yaml"
MODEL_CONFIGS = sorted(str(p.relative_to(ROOT)) for sub in ("sd15", "sdxl", "smoke", "vae")
                       for p in (ROOT / "configs" / sub).glob("*.yaml"))


def _write_folder(folder: Path, n: int = 3) -> Path:
    """The JAX smoke test's image folder: random 80x96 PNGs written by the
    port's writer, with tag captions."""
    from neurosis_tpu_torch.data.png import write_png

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(folder / f"img_{i}.png", (rng.rand(80, 96, 3) * 255).astype(np.uint8))
        (folder / f"img_{i}.txt").write_text(f"tag{i}, a test image, simple")
    return folder


@pytest.fixture()
def smoke(tmp_path, monkeypatch):
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(_write_folder(tmp_path / "data")))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    return tmp_path


def _edited(src: Path, dst: Path, *edits) -> Path:
    text = src.read_text()
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    dst.write_text(text)
    return dst


# -- (a) ----------------------------------------------------------------------


@pytest.mark.parametrize("argv,key", [
    (["fit", "-c", str(TINY), "--fast-dev-run"], None),
    (["validate", "-c", str(TINY), "--max-batches", "2"], "val/loss"),
    (["test", "-c", str(TINY), "--max-batches", "2"], "test/loss"),
    (["fit", "-c", str(VAE_TINY)], None),
])
def test_cli_runs_the_smoke_configs_on_the_cpu(smoke, capsys, argv, key):
    from neurosis_tpu_torch.trainer.cli import main

    assert main(argv + ["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in (smoke / "root" / "logs" / "metrics.jsonl").read_text().splitlines()]
    if key is None:
        assert [r["step"] for r in lines] == [1]
        loss = lines[0]["total" if "vae" in argv[2] else "loss"]
        assert np.isfinite(loss) and lines[0]["step_ms"] > 0 and lines[0]["data_ms"] > 0
    else:
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert np.isfinite(out[key]) and out[key.split("/")[0] + "/num_batches"] == 2.0


def test_validate_reports_the_ema_loss_and_refuses_random_weights(smoke, capsys, monkeypatch):
    """With use_ema, eval_step also reports loss_ema (the same draws under
    the shadows: equal to loss before any update); without fast_dev_run or
    a checkpoint, validate refuses random weights."""
    from neurosis_tpu_torch.trainer.cli import main

    cfg = _edited(TINY, smoke / "ema.yaml", ("    use_ema: false", "    use_ema: true"))
    assert main(["validate", "-c", str(cfg), "--max-batches", "1", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["val/loss_ema"] == pytest.approx(out["val/loss"], rel=1e-6)
    cfg = _edited(TINY, smoke / "real.yaml", ("  fast_dev_run: true", "  fast_dev_run: false"))
    monkeypatch.setenv("NEUROSIS_ALLOW_HASH_TOKENIZER", "1")
    with pytest.raises(RuntimeError, match="randomly-initialized"):
        main(["validate", "-c", str(cfg), "--max-batches", "1", "--device", "cpu"])


def test_eval_step_scores_the_ema_shadows_and_restores_the_weights():
    """eval_step's loss_ema is the loss of an engine whose weights are the
    shadows, at the same draws; the live weights come back unchanged."""
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.trainer.builder import build_engine

    node = load_config(TINY)["model"]
    node["init_args"]["use_ema"] = True
    engines = [build_engine(node, None, device="cpu", generator=torch.Generator().manual_seed(0)) for _ in range(2)]
    states = [e.init(seed=5) for e in engines]
    g = torch.Generator().manual_seed(1)
    for shadow in states[0].ema.params:
        shadow.add_(0.02 * torch.randn(shadow.shape, generator=g))
    with torch.no_grad():
        for p, shadow in zip(engines[1].trainable_parameters(), states[0].ema.params):
            p.copy_(shadow)
    before = [p.detach().clone() for p in engines[0].trainable_parameters()]
    batch = {"image": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g),
             "caption_ids": torch.randint(0, 49408, (2, 77), generator=g)}
    _, m0 = engines[0].eval_step(states[0], batch)
    _, m1 = engines[1].eval_step(states[1], batch)
    assert float(m0["loss_ema"]) == float(m1["loss"]) and float(m0["loss"]) != float(m0["loss_ema"])
    assert all(torch.equal(a, b) for a, b in zip(before, engines[0].trainable_parameters()))


# -- (b) ----------------------------------------------------------------------


def jax_loss_and_grad_norm(engine, model_params, frozen, batch, t, noise, post_eps):
    """JAX engine.train_step's loss and grad norm with its three draws (the
    posterior noise, t, the noise) given: the frozen encode, the
    conditioner, the preconditioned UNet and the weighted L2, as
    engine.loss and StandardDiffusionLoss compose them."""
    from neurosis_tpu.modules.distributions import DiagonalGaussian
    from neurosis_tpu.ops.dequant import dequant_image
    from neurosis_tpu.optimizers.stacked import stacked_global_norm

    def loss(params, batch, t, noise, post_eps):
        x = dequant_image(batch[engine.input_key])
        moments = engine.first_stage.apply({"params": frozen["first_stage"]}, x, method="encode")
        dist = DiagonalGaussian.from_moments(moments)
        latents = engine.scale_factor * (dist.mean + dist.std * post_eps)
        cond = engine.conditioner.apply({"params": frozen["conditioner"]}, batch, rng=None)
        sig = engine.loss_fn.sigma_generator(latents.shape[0], t).astype(latents.dtype)
        z = latents + sig[:, None, None, None] * noise

        def net(x, c_noise, c):
            return engine.model.apply({"params": params}, x, c_noise, c.get("crossattn"), y=c.get("vector"),
                                      deterministic=False)

        d = engine.denoiser(net, z, sig, cond, "D")
        return engine.loss_fn.get_loss(d, latents, engine.loss_fn.loss_weighting(sig)).mean()

    val, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree_util.tree_map(jnp.asarray, model_params), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(t.copy()), jnp.asarray(noise.copy()), jnp.asarray(post_eps.copy()))
    return float(val), float(stacked_global_norm(grads))


@pytest.mark.parametrize("precision,tols", [("fp32", (1e-5, 1e-5)), ("bf16-mixed", (2e-2, 5e-2))])
def test_slice_as_a_whole_matches_jax(smoke, precision, tols):
    from neurosis_tpu.trainer.cli import _build as jax_build

    from neurosis_tpu_torch.trainer.cli import _build

    config = TINY if precision == "bf16-mixed" else _edited(TINY, smoke / "fp32.yaml", ("  precision: bf16-mixed\n", ""))
    _, jengine, jdataset, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None))
    _, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                            device="cpu"))
    assert engine.model.dtype == (torch.bfloat16 if precision == "bf16-mixed" else None)
    assert all(p.dtype == torch.float32 for p in engine.model.parameters())  # fp32 weights, bf16 compute

    indices = next(iter(jdataset.get_batch_iterator()))
    assert next(iter(dataset.get_batch_iterator())) == indices
    jprep = jtrainer.prepare_batch(jdataset.get_batch(indices))
    prep = trainer.prepare_batch(dataset.get_batch(indices))
    assert sorted(prep) == sorted(jprep) == ["caption_ids", "image", "uncond_ids"]
    for k, v in jprep.items():
        assert prep[k].dtype == (torch.uint8 if k == "image" else torch.int64), k
        np.testing.assert_array_equal(prep[k].numpy(), v, err_msg=k)

    jstate, jfrozen = jax.jit(jengine.init)(jax.random.PRNGKey(42), {k: jnp.asarray(v) for k, v in jprep.items()})
    p_unet = perturb(jstate.params["model"], 1)
    load_into(engine.model, p_unet)
    load_into(engine.conditioner, jfrozen["conditioner"])
    load_into(engine.first_stage, jfrozen["first_stage"])

    rng = np.random.RandomState(7)
    shape = tuple(engine.encode_first_stage(prep["image"]).shape)  # (1, 32, 32, 4): one downsample
    t = np.array([0.37] * shape[0], np.float32)
    noise = rng.randn(*shape).astype(np.float32)
    post_eps = rng.randn(*shape).astype(np.float32)
    want_loss, want_norm = jax_loss_and_grad_norm(jengine, p_unet, to_np(jfrozen), jprep, t, noise, post_eps)
    state = engine.init(seed=0)
    state, metrics = engine.train_step(state, prep, t=torch.tensor(t), noise=torch.tensor(noise),
                                       posterior_noise=torch.tensor(post_eps))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=tols[0])
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=tols[1])


# -- (c) ----------------------------------------------------------------------


def _cut(cfg: dict) -> dict:
    """The config with its widths cut: UNet channels (32, or 64 with
    64-channel heads), text towers 64 wide in 2 heads (their layer counts
    kept), the context width their sum, the label width the pooled width
    plus the size features, VAE channels 32. Everything else as written."""
    cfg = copy.deepcopy(cfg)
    m = cfg["model"]["init_args"]
    if "ddconfig" in m:
        m["ddconfig"]["ch"] = 32
        return cfg
    widths, pooled, sizes = [], 0, 0
    for emb in m["conditioner"]["init_args"]["emb_models"]:
        ia = emb.setdefault("init_args", {})
        if emb["class_path"].endswith(("FrozenCLIPEmbedder", "FrozenOpenCLIPEmbedder2")):
            ia.update(width=64, heads=2)
            widths.append(64)
            pooled = 64 if emb["class_path"].endswith("2") else pooled
        elif emb["class_path"].endswith("ConcatTimestepEmbedderND"):
            sizes += 2 * ia.get("outdim", 256)
    unet = m["model"]["init_args"]
    unet["model_channels"] = 64 if unet.get("num_head_channels", -1) != -1 else 32
    unet["context_dim"] = sum(widths)
    if unet.get("adm_in_channels"):
        unet["adm_in_channels"] = pooled + sizes
    m["first_stage_model"]["init_args"]["ddconfig"]["ch"] = 32
    return cfg


def _jax_names(cfg: dict) -> dict:
    """{torch key: shape} of the JAX engine's init, abstractly evaluated."""
    from neurosis_tpu.trainer.builder import apply_precision, build_engine

    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict

    engine = apply_precision(build_engine(cfg["model"]), (cfg.get("trainer") or {}).get("precision"))
    s = jax.ShapeDtypeStruct
    batch = {"image": s((1, 64, 64, 3), jnp.uint8), "caption_ids": s((1, 77), jnp.int32),
             **{k: s((1, 2), jnp.float32)
                for k in ("original_size_as_tuple", "crop_coords_top_left", "target_size_as_tuple")}}
    out = jax.eval_shape(engine.init, jax.random.PRNGKey(0), batch)
    zeros = lambda tree: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), tree)  # noqa: E731

    def keys(tree, prefix):
        return {k: tuple(v.shape) for k, v in jax_params_to_state_dict(zeros(tree), prefix).items()}

    if "ddconfig" in cfg["model"]["init_args"]:
        names = {}
        for part in ("encoder", "decoder", "loss"):
            names.update(keys(out.params[part], part + "."))
        names.update(keys(out.batch_stats, "loss."))
        return names
    state, frozen = out
    return {**keys(state.params["model"], "model."), **keys(state.params["conditioner"], "conditioner."),
            **keys(frozen["conditioner"], "conditioner."), **keys(frozen["first_stage"], "first_stage.")}


@pytest.mark.parametrize("config", MODEL_CONFIGS)
def test_configs_build_jax_names_and_shapes(config):
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.trainer.builder import build_engine
    from neurosis_tpu_torch.trainer.callbacks import engine_modules

    cfg = _cut(load_config(ROOT / config))
    precision = (cfg.get("trainer") or {}).get("precision")
    if config.endswith("sdxl-te.example.yaml"):  # AdamW8bit and its scheduler wait for item 8
        with pytest.raises(NotImplementedError, match="item 8"):
            build_engine(cfg["model"], precision, device="meta", generator=torch.Generator())
        return
    engine = build_engine(cfg["model"], precision, device="meta", generator=torch.Generator())
    got = {}
    for top, module in engine_modules(engine).items():
        got.update({f"{top}.{k}": tuple(v.shape) for k, v in module.state_dict().items()})
    assert got == _jax_names(cfg)


# -- (d) ----------------------------------------------------------------------


@pytest.mark.parametrize("edit,error,match", [
    (("  fast_dev_run: true\n", "  fast_dev_run: true\n  devices: 2\n"), NotImplementedError, "item 10"),
    (("  fast_dev_run: true\n", "  fast_dev_run: true\n  strategy: fsdp\n"), NotImplementedError, "item 10"),
    (("  fast_dev_run: true\n", "  fast_dev_run: true\n  context_parallel: 2\n"), NotImplementedError, "item 10"),
    (("  fast_dev_run: true\n", "  fast_dev_run: true\n  profiler:\n    class_path: NeurosisProfiler\n"),
     NotImplementedError, "item 11"),
    (("seed_everything: 42\n", "seed_everything: 42\nimage_logger:\n  log_step_type: every_epoch\n"),
     ValueError, "not a valid StepType"),
    (("seed_everything: 42\n", "seed_everything: 42\nmodel_checkpoint:\n  every_n_train_steps: 10\n"),
     NotImplementedError, "item 12"),
])
def test_cli_refuses_what_it_cannot_honour(smoke, edit, error, match):
    from neurosis_tpu_torch.trainer.cli import main

    cfg = _edited(TINY, smoke / "refused.yaml", edit)
    with pytest.raises(error, match=match):
        main(["fit", "-c", str(cfg), "--device", "cpu"])


def test_cli_refuses_resume_predict_and_a_missing_card(smoke, monkeypatch):
    from neurosis_tpu_torch.trainer.cli import main

    (smoke / "root" / "checkpoints").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        main(["fit", "-c", str(TINY), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 12"):  # predict reads no resumable run either
        main(["predict", "-c", str(TINY), "--device", "cpu", "--size", "64", "--steps", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["fit", "-c", str(TINY)])


def test_unknown_callbacks_warn_and_are_skipped(smoke, caplog):
    from neurosis_tpu_torch.trainer.cli import main

    cfg = _edited(TINY, smoke / "callbacks.yaml", (
        "    - class_path: DeviceStatsMonitor\n",
        "    - class_path: DeviceStatsMonitor\n    - class_path: lightning.pytorch.callbacks.LearningRateMonitor\n"
        "    - class_path: my.own.Callback\n    - class_path: neurosis.trainer.profile.NeurosisProfiler\n"))
    assert main(["fit", "-c", str(cfg), "--device", "cpu"]) == 0
    assert "skipping unsupported trainer callback 'my.own.Callback'" in caplog.text
    assert "NeurosisProfiler" in caplog.text and "LearningRateMonitor" not in caplog.text


def test_a_failed_step_leaves_a_crash_dump(smoke, monkeypatch):
    from neurosis_tpu_torch.trainer.cli import main
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    def fail(self, state, batch, **kw):
        raise FloatingPointError("a failed step")

    monkeypatch.setattr(DiffusionEngine, "train_step", fail)
    with pytest.raises(FloatingPointError):
        main(["fit", "-c", str(TINY), "--device", "cpu"])
    dump = torch.load(smoke / "root" / "last_exception.s0.pt", weights_only=True)
    assert dump["step"] == 0 and dump["params"] and all(k.startswith("model.") for k in dump["params"])


# -- (e) ----------------------------------------------------------------------


def test_cli_path_runs_without_the_packages_the_card_lacks(tmp_path):
    """fit of both smoke configs, each with an image_logger: node, and
    predict, where none of those packages imports; the logger's PNGs and
    predict's are written."""
    folder = _write_folder(tmp_path / "data")
    node = ("seed_everything: 42\n", "seed_everything: 42\nimage_logger:\n  every_n_train_steps: 1\n"
            "  log_first_step: true\n  log_func_kwargs:\n    num_steps: 2\n")
    tiny, vae = _edited(TINY, tmp_path / "il.yaml", node), _edited(VAE_TINY, tmp_path / "vae_il.yaml", node)
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'yaml', 'PIL', 'pandas', 'regex', 'safetensors'):\n"
        "    sys.modules[name] = None\n"
        "from neurosis_tpu_torch.trainer.cli import main\n"
        f"assert main(['fit', '-c', {str(tiny)!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['fit', '-c', {str(vae)!r}, '--device', 'cpu']) == 0\n"
        f"assert main(['predict', '-c', {str(TINY)!r}, '--device', 'cpu', '--size', '64', '--steps', '2', "
        "'--prompt', 'a cat']) == 0\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("NEUROSIS_TOKENIZER_DIR",)}
    env.update(NEUROSIS_SMOKE_DATA=str(folder), NEUROSIS_SMOKE_ROOT=str(tmp_path / "root"), HF_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"
    assert "image logging failed" not in out.stderr
    images = sorted(p.name for p in (tmp_path / "root" / "images" / "train").iterdir())
    assert {"gs000001_e0000_b000001_samples_grid.png", "gs000001_e0000_b000001_diff_boost_00.png",
            "gs000001_e0000_b000001_vis_logits_00.png"} <= set(images)
    assert sorted(p.name for p in (tmp_path / "root" / "predictions").iterdir()) == ["grid.png", "sample_000.png"]


# -- chip_smoke's CLI phase -----------------------------------------------------


def test_chip_smoke_cli_tables_are_its_fp32_tables():
    """The launches phase 11 expects of the fp32 SDXL step through the CLI are
    the xl32 rows (UNDRIVEN_F32_FLASH_SHAPES['sdxl_f32']) plus the frozen
    encode's (SDXL_FLASH_F32_SHAPES), so the fp32 table and the path cannot
    drift apart; its images land in WDXLBucketList's 1024x1024 bucket."""
    import chip_smoke as cs

    from neurosis_tpu_torch.data.aspect import WDXLBucketList

    per_path: dict = {}
    for path, _shape, (n_fwd, n_bwd), dtype in cs.flash_tables(torch):
        kind = "f32" if dtype == torch.float32 else "bf16"
        tot = per_path.setdefault(path, {})
        tot[f"fwd_{kind}"] = tot.get(f"fwd_{kind}", 0) + n_fwd
        tot[f"bwd_{kind}"] = tot.get(f"bwd_{kind}", 0) + n_bwd
    xl32 = cs.UNDRIVEN_F32_FLASH_SHAPES["sdxl_f32"]
    want_fwd = sum(f for f, _ in xl32.values()) + sum(cs.SDXL_FLASH_F32_SHAPES.values())
    assert per_path["cli_sdxl_f32"] == {"fwd_f32": want_fwd, "bwd_f32": sum(b for _, b in xl32.values())}
    assert want_fwd == 281
    assert per_path["cli_vae"] == {"fwd_f32": 2, "bwd_f32": 2}
    assert "sdxl_f32" not in per_path  # those rows are phase 11's now
    assert cs.TABLES_OF["cli_sdxl_bf16"] == "sdxl" and set(cs.PATHS) >= {"cli_sdxl_f32", "cli_sdxl_bf16", "cli_vae"}
    buckets = WDXLBucketList()
    assert all(buckets.bucket(w / h).size == (1024, 1024) and min(w, h) >= 1024 for w, h in cs.CLI_IMAGE_SIZES)
    assert len(cs.CLI_IMAGE_SIZES) == 8
