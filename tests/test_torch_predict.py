"""The port's sampling path against the JAX package's on the CPU, at the
widths of configs/smoke/sd15-tiny.yaml and vae-tiny.yaml.

(a) engine.sample and engine.log_images of the sd15-tiny engine (fp32: the
    config with its precision key removed), built by each package's CLI
    builder, the UNet's JAX init perturbed (so its zero-init output layers
    take part) and exported to the port through jax_params_to_state_dict;
    the initial noise and the encode's posterior noise are JAX's own draws
    passed in. Samples within 1e-4 of their largest value after 4 Euler
    steps at CFG 7.5 (the guider multiplies the fp32 noise of the two
    UNet calls by 7.5 a step), the decoded images within 1e-4.
(b) The VAE trainer's log_images with use_ema (the shadows set to other
    weights on both sides) and the discriminator-logit grids: within 1e-5
    (diff_boost 3e-5: it triples the difference), the colour bars' labels
    within the text bound of test_torch_image.py.
(c) ImageLogger's cadence against JAX's over every StepType.
(d) predict of the sd15-tiny copy with allow_random_weights through each
    CLI, the same perturbed weights and initial noise: the PNGs within 2
    levels of JAX's, the grid's geometry equal.
(e) fit with an image_logger: node writes the logger's PNGs, named as JAX's.
"""

import argparse
import dataclasses
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_cli import TINY, VAE_TINY, _edited, _write_folder  # noqa: E402
from torch_parity import load_into, one_torch_thread, perturb, recorded_launches, rel_err, to_np  # noqa: E402,F401


@pytest.fixture()
def smoke(tmp_path, monkeypatch):
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(_write_folder(tmp_path / "data", n=2)))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    monkeypatch.setenv("NEUROSIS_ALLOW_HASH_TOKENIZER", "1")
    return tmp_path


def _fp32_tiny(smoke, *edits):
    return _edited(TINY, smoke / "fp32.yaml", ("  precision: bf16-mixed\n", ""), *edits)


def _engines(config):
    """Both packages' engines, trainers and first batch from ``config``, the
    port's loaded with JAX's init (the UNet perturbed)."""
    from neurosis_tpu.trainer.cli import _build as jax_build

    from neurosis_tpu_torch.trainer.cli import _build

    _, jengine, jdataset, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None))
    _, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                            device="cpu"))
    indices = next(iter(jdataset.get_batch_iterator()))
    host = jdataset.get_batch(indices)
    jprep = jtrainer.prepare_batch(host)
    jstate, jfrozen = jax.jit(jengine.init)(jax.random.PRNGKey(42), {k: jnp.asarray(v) for k, v in jprep.items()})
    p_unet = perturb(jstate.params["model"], 3)
    load_into(engine.model, p_unet)
    load_into(engine.conditioner, jfrozen["conditioner"])
    load_into(engine.first_stage, jfrozen["first_stage"])
    jparams = dict(jstate.params, model=jax.tree_util.tree_map(jnp.asarray, p_unet))
    return jengine, jparams, jfrozen, jprep, engine, trainer, host


def test_engine_sample_and_log_images_equal_jax(smoke):
    jengine, jparams, jfrozen, jprep, engine, trainer, host = _engines(_fp32_tiny(smoke))
    prep = trainer.prepare_batch(host)
    jbatch = {k: jnp.asarray(v) for k, v in jprep.items()}

    # sample: cond and uncond from the conditioner, 4 steps of the config's Euler sampler at CFG 7.5
    jc, juc = jengine.conditioner.get_unconditional_conditioning(
        {"params": jengine._merged_cond_params(jparams, jfrozen)}, jbatch)
    shape = (1, 32, 32, 4)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jengine.sample(jparams, jfrozen, jc, juc, rng, shape, num_steps=4))
    state = engine.init(seed=0)
    with engine.eval_scope(state):
        c, uc = engine.conditioner.get_unconditional_conditioning(prep)
        got = engine.sample(c, uc, shape, num_steps=4, noise=torch.tensor(np.asarray(jax.random.normal(rng, shape))))
    assert got.shape == shape and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-4

    # log_images: the same two draws JAX makes from its key, passed in
    key = jax.random.PRNGKey(9)
    enc_rng, sample_rng = jax.random.split(key)
    want_log = jengine.log_images(jparams, jfrozen, jbatch, num_img=1, rng=key, captions=host["caption"],
                                  num_steps=4)
    got_log = engine.log_images(state, prep, num_img=1, captions=host["caption"], num_steps=4,
                                posterior_noise=torch.tensor(np.asarray(jax.random.normal(enc_rng, shape))),
                                noise=torch.tensor(np.asarray(jax.random.normal(sample_rng, shape))))
    assert sorted(got_log) == sorted(want_log) == ["conditioning", "inputs", "reconstructions", "samples"]
    for k, want_img in want_log.items():
        assert got_log[k].shape == want_img.shape and got_log[k].dtype == np.float32, k
    np.testing.assert_array_equal(got_log["inputs"], want_log["inputs"])
    assert rel_err(got_log["reconstructions"], want_log["reconstructions"]) < 1e-4
    assert rel_err(got_log["samples"], want_log["samples"]) < 1e-4
    # no sampler: no samples; no captions: no conditioning
    engine.sampler = None
    assert sorted(engine.log_images(state, prep, num_img=1)) == ["inputs", "reconstructions"]


def test_sample_takes_its_noise_from_the_generator(smoke):
    """Without noise, sample draws the initial noise from the generator:
    the same seed gives the same latents, the EMA scope swaps the UNet
    weights in and out."""
    from neurosis_tpu_torch.trainer.cli import _build

    config = _edited(TINY, smoke / "ema.yaml", ("    use_ema: false", "    use_ema: true"))
    _, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                            device="cpu"))
    prep = trainer.prepare_batch(dataset.get_batch(next(iter(dataset.get_batch_iterator()))))
    state = engine.init(seed=0)
    with torch.no_grad():
        for p in engine.model.parameters():
            p.add_(0.01)  # the live weights move away from the shadows
    c, uc = engine.conditioner.get_unconditional_conditioning(prep)
    runs = []
    for seed in (1, 1, 2):
        with engine.eval_scope(state):
            runs.append(engine.sample(c, uc, (1, 8, 8, 4), num_steps=2, generator=torch.Generator().manual_seed(seed)))
    live = engine.sample(c, uc, (1, 8, 8, 4), num_steps=2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2]) and not torch.equal(runs[0], live)
    assert all(torch.equal(p, s + 0.01) or torch.allclose(p, s + 0.01)
               for p, s in zip(engine.trainable_parameters(), state.ema.params))


def test_vae_log_images_equal_jax():
    import test_torch_vae_engine as V

    from neurosis_tpu.modules.ema import ema_init

    jengine = dataclasses.replace(V._jax_engine(), use_ema=True, sample_posterior=True)
    x = np.random.RandomState(3).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    jstate = jax.jit(jengine.init)(jax.random.PRNGKey(0), {"image": jnp.asarray(x)})
    params = dict(jstate.params, encoder=perturb(jstate.params["encoder"], 1),
                  decoder=perturb(jstate.params["decoder"], 2), loss=perturb(jstate.params["loss"], 3))
    shadows = {k: perturb(params[k], 4 + i, scale=0.05) for i, k in enumerate(("encoder", "decoder"))}
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, params),
                                 ema=ema_init(jax.tree_util.tree_map(jnp.asarray, shadows)))
    key = jax.random.PRNGKey(7)
    want = jengine.log_images(jstate, {"image": jnp.asarray(x)}, num_img=2, rng=key)

    engine = V._torch_engine(params, jstate.batch_stats)
    engine.use_ema, engine.sample_posterior = True, True
    state = engine.init(seed=0)
    ema_modules = V._torch_engine(dict(params, **shadows), jstate.batch_stats)
    state.ema.params = [p.detach().clone() for p in ema_modules.g_parameters()]
    eps = torch.tensor(np.asarray(jax.random.normal(key, (2, 32, 32, 2))))
    got = engine.log_images(state, {"image": torch.tensor(x)}, num_img=2, posterior_noise=eps)
    assert sorted(got) == sorted(want) == sorted(
        ["inputs", "vis_logits", "vis_logits_blended"] + [f"{k}{s}" for k in ("reconstructions", "diff", "diff_boost")
                                                          for s in ("", "_ema")])
    for k, w in want.items():
        w = np.asarray(w)
        assert got[k].shape == w.shape and got[k].dtype == np.float32, k
        if k.startswith("vis_logits"):  # the grids exact, the colour bar's labels within the text bound
            assert rel_err(got[k][:, :-24], w[:, :-24]) < 1e-5, k
            d = np.abs(got[k][0, -24:] - w[0, -24:]).max(-1)
            assert d.max() <= 16 / 127.5 and (d > 1e-6).mean() <= 1e-3, k
        else:  # diff_boost multiplies the reconstruction's fp32 noise by its factor, 3
            assert rel_err(got[k], w) < (3e-5 if k.startswith("diff_boost") else 1e-5), k
    assert not np.allclose(got["reconstructions"], got["reconstructions_ema"])
    live = [p.detach().clone() for p in engine.g_parameters()]
    assert all(torch.equal(a, b) for a, b in zip(live, engine.g_parameters()))  # the scope restored them


@pytest.mark.parametrize("step_type", ["global_step", "batch_idx", "global_batch", "sample_idx"])
def test_image_logger_cadence_equals_jax(step_type):
    from neurosis_tpu.trainer.callbacks import ImageLogger as JLogger

    from neurosis_tpu_torch.trainer.callbacks import ImageLogger, StepType

    kw = dict(every_n_train_steps=4, log_first_step=True, log_before_start=True, log_step_type=step_type,
              batch_size=2, accumulate_grad_batches=3)
    loggers = (JLogger(**kw), ImageLogger(**kw))
    assert loggers[1].log_step_type == StepType(step_type)
    decisions = ([], [])
    for lg, out in zip(loggers, decisions):
        out.append(lg.check_step_idx(0, 0, before_start=True))
        for epoch in range(2):
            for batch_idx in range(1, 6):
                global_step = 5 * epoch + batch_idx
                ok = lg.check_step_idx(global_step, batch_idx)
                out.append((global_step, batch_idx, ok, lg.get_step_idx(global_step, batch_idx)))
                if ok:
                    lg._last_logged = lg.get_step_idx(global_step, batch_idx)
    assert decisions[0] == decisions[1]
    assert any(d[2] for d in decisions[1][1:])


def test_predict_equals_jax(smoke, monkeypatch):
    """python -m neurosis_tpu_torch predict against the JAX package's
    Trainer.predict: the same weights (JAX's init, UNet perturbed) and
    initial noise; 2 prompts, 4 steps, 64 px."""
    from neurosis_tpu.trainer.cli import _build as jax_build
    from PIL import Image

    from neurosis_tpu_torch.data.png import read_png
    from neurosis_tpu_torch.trainer import cli

    config = _fp32_tiny(smoke, ("  fast_dev_run: true\n", "  fast_dev_run: false\n  allow_random_weights: true\n"))
    prompts = ["a red square", "tag0, a test image"]
    _, jengine, _, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=None, max_steps=None))
    init = jengine.init
    exported = {}

    def perturbed_init(rng, batch):
        state, frozen = init(rng, batch)
        exported.update(model=perturb(state.params["model"], 6), frozen=to_np(frozen))
        return state._replace(params=dict(state.params, model=jax.tree_util.tree_map(jnp.asarray,
                                                                                     exported["model"]))), frozen

    jengine.init = perturbed_init
    jtrainer.predict(prompts, smoke / "want", size=64, num_steps=4)
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(43), (2, 8, 8, 4)))

    build = cli._build

    def build_with_jax_weights(args):
        out = build(args)
        engine = out[1]
        load_into(engine.model, exported["model"])
        load_into(engine.conditioner, exported["frozen"]["conditioner"])
        load_into(engine.first_stage, exported["frozen"]["first_stage"])
        sample = engine.sample
        engine.sample = lambda *a, **k: sample(*a, **dict(k, noise=torch.tensor(noise)))
        return out

    monkeypatch.setattr(cli, "_build", build_with_jax_weights)
    argv = ["predict", "-c", str(config), "--device", "cpu", "--steps", "4", "--size", "64", "--out",
            str(smoke / "got")]
    for p in prompts:
        argv += ["--prompt", p]
    assert cli.main(argv) == 0
    assert sorted(os.listdir(smoke / "got")) == sorted(os.listdir(smoke / "want")) == \
        ["grid.png", "sample_000.png", "sample_001.png"]
    for name in ("sample_000.png", "sample_001.png", "grid.png"):
        got, mode, _ = read_png(smoke / "got" / name)
        want = np.asarray(Image.open(smoke / "want" / name).convert("RGB"))
        assert mode == "RGB" and got.shape == want.shape, name
        if name != "grid.png":
            assert got.shape == (16, 16, 3) and np.abs(got.astype(int) - want.astype(int)).max() <= 2, name


def test_fit_with_an_image_logger_writes_its_pngs(smoke, monkeypatch):
    """fit of sd15-tiny (2 steps) and of vae-tiny (1 step) with an
    image_logger: node: the logger's PNGs, named gs{step}_e{epoch}_b{batch}_
    <key>_<i>, with the samples' captioned grid for the diffusion engine."""
    from neurosis_tpu_torch.data.png import read_png
    from neurosis_tpu_torch.trainer.cli import main

    node = ("seed_everything: 42\n", "seed_everything: 42\nimage_logger:\n  every_n_train_steps: 2\n"
            "  max_images: 2\n  log_first_step: true\n  log_func_kwargs:\n    num_steps: 2\n")
    cfg = _edited(TINY, smoke / "il.yaml", node, ("  fast_dev_run: true\n", "  fast_dev_run: false\n"),
                  ("  max_steps: 1\n", "  max_steps: 2\n"))
    assert main(["fit", "-c", str(cfg), "--device", "cpu"]) == 0
    out = smoke / "root" / "images" / "train"
    keys = ("conditioning", "inputs", "reconstructions", "samples")
    want = sorted([f"gs{s:06d}_e0000_b{s:06d}_{k}_00.png" for s in (1, 2) for k in keys] +
                  [f"gs{s:06d}_e0000_b{s:06d}_samples_grid.png" for s in (1, 2)])
    assert sorted(os.listdir(out)) == want
    for name in want:
        px, mode, _ = read_png(out / name)
        assert mode == "RGB" and (name.endswith("grid.png") or px.shape == (64, 64, 3)), name

    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(smoke / "vae_root"))
    assert main(["fit", "-c", str(_edited(VAE_TINY, smoke / "vae_il.yaml", node)), "--device", "cpu"]) == 0
    names = sorted(os.listdir(smoke / "vae_root" / "images" / "train"))
    keys = ("diff", "diff_boost", "inputs", "reconstructions")
    assert names == sorted([f"gs000001_e0000_b000001_{k}_{i:02d}.png" for k in keys for i in (0, 1)] +
                           [f"gs000001_e0000_b000001_{k}_00.png" for k in ("vis_logits", "vis_logits_blended")])


# -- chip_smoke.py's sampling tables ----------------------------------------------


def test_chip_smoke_sampling_tables_are_the_models_launches(monkeypatch):
    """The launches phases 12-13 expect, from chip_smoke.sampling_tables(),
    equal the port's own models run forward without grad on meta tensors at
    full SDXL width: one UNet call at CFG batch 2, 4 and 8 in bf16 and at 4
    in fp32 (sdxl.example.yaml as written), the fp32 decode of 1, 2 and 4
    images at 1024 px; and each of those shapes is a row of phase 3's
    flash or conv tables under its path, with its count."""
    import chip_smoke as cs

    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL
    from neurosis_tpu_torch.models.unet import UNetModel

    calls = recorded_launches(monkeypatch)
    meta = dict(device="meta", generator=torch.Generator())

    def unet_call(n, dtype):
        calls.clear()
        model = UNetModel(**cs.SDXL_UNET, use_checkpoint=True, dtype=dtype, **meta)
        with torch.no_grad():
            model(torch.empty(n, 128, 128, 4, device="meta"), torch.zeros(n, dtype=torch.long, device="meta"),
                  torch.empty(n, 77, 2048, device="meta"), y=torch.empty(n, 2816, device="meta"))
        return dict(calls)

    def tables(flash, flash32, conv, gn):
        out = {("flash_fwd_bf16", sh[:4]): k for sh, k in flash.items()}
        out.update({("flash_fwd_f32", sh[:4]): k for sh, k in flash32.items()})
        out.update({("conv3x3_bf16", sh): k for sh, k in conv.items()})
        out.update({("gn_silu_conv3x3_bf16", sh): k for sh, k in gn.items()})
        return out

    want = cs.sampling_tables()
    for b in cs.SAMPLE_BATCHES:
        assert unet_call(2 * b, torch.bfloat16) == tables(*want[f"sdxl_sample{b}"])
    per_call = unet_call(2 * cs.LOGGER_IMAGES, torch.bfloat16)
    fp32_call = unet_call(2 * len(cs.PREDICT_PROMPTS), None)
    vae = AutoencoderKL(cs.SD15_VAE, embed_dim=4, **meta)
    decodes = {}
    for b in (1, 2, 4):
        calls.clear()
        with torch.no_grad():
            assert vae.decode(torch.empty(b, 128, 128, 4, device="meta")).shape == (b, 1024, 1024, 3)
        decodes[b] = dict(calls)
        if b in cs.SAMPLE_BATCHES:
            assert decodes[b] == tables(*want[f"sdxl_decode{b}"])
    steps = cs.PREDICT_STEPS
    assert tables(*want["cli_predict"]) == {**{k: n * steps for k, n in fp32_call.items()}, **decodes[2]}
    assert tables(*want["cli_logger"]) == {**{k: n * cs.LOGGER_STEPS for k, n in per_call.items()},
                                           **{k: 3 * n for k, n in decodes[2].items()}}  # and the encode

    flash_rows = {(path, sh, dt): n for path, sh, n, dt in cs.flash_tables(torch)}
    for path, (flash, flash32, _conv, _gn) in want.items():
        assert path in cs.PATHS and path in cs.FORWARD_ONLY
        for dtype, table in ((torch.bfloat16, flash), (torch.float32, flash32)):
            for sh, n in table.items():
                assert flash_rows[path, sh, dtype] == (n, 0), (path, sh)
    # the shapes sampling adds: SDXL at batch 4 under CFG (UNet batch 8) and the decode's fp32 rows
    assert {(8, 10, 4096, 4096, 64), (8, 20, 1024, 1024, 64), (8, 10, 4096, 77, 64), (8, 20, 1024, 77, 64)} <= \
        set(want["sdxl_sample4"][0])
    assert {(1, 1, 16384, 16384, 512), (4, 1, 16384, 16384, 512)} <= \
        set(want["sdxl_decode1"][1]) | set(want["sdxl_decode4"][1])
