"""One v-prediction step from the CLI's builder against the JAX package's.

configs/smoke/sd15-tiny.yaml (fp32) turned into a v-prediction
zero-terminal-SNR fine-tune (VPreconditioning over TanZeroSNRDiscretization,
min-SNR-γ over EDMWeighting with v_pred, noise offset at chance 1, caption
dropout on CLIP, log_sigmas) with configs/hook/loss_scale.example.yml merged
under ``model:``. Both builders read it; the tag hook's pre_hook gives the
same ``loss_scale`` on both sides; JAX's init goes into the port; the
port's encode gives both sides the latents; JAX's ``engine.loss`` draws
from one key and the port takes those draws (the conditioner's swap, t,
noise, the offset). Loss, grad norm and the
log_sigmas metrics within 1e-5, the hook's logged metrics exactly. Its own
file: the test runner's workers take whole files.
"""

import argparse

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_cli import ROOT, TINY, _write_folder  # noqa: E402
from test_torch_diffusion_options import jax_loss_draws  # noqa: E402
from torch_parity import load_into, one_torch_thread, perturb, to_np  # noqa: E402,F401


def _vpred_config(path):
    """sd15-tiny.yaml edited as text (the port's reader takes block YAML, as
    the configs are written) with the hook file's forward_hooks block
    appended under model.init_args."""
    text = TINY.read_text()
    tan = "          class_path: neurosis.modules.diffusion.TanZeroSNRDiscretization\n"
    edits = [
        ("  precision: bf16-mixed\n", ""),
        ("    use_ema: false\n", "    use_ema: false\n    log_sigmas: true\n"),
        ("          class_path: neurosis.modules.diffusion.EpsPreconditioning\n",
         "          class_path: neurosis.modules.diffusion.VPreconditioning\n"),
        ("        discretization:\n          class_path: neurosis.modules.diffusion.LegacyDDPMDiscretization\n\n"
         "    first_stage_model:", "        discretization:\n" + tan + "\n    first_stage_model:"),
        ("              is_trainable: false\n", "              is_trainable: false\n              ucg_rate: 0.5\n"),
        ("        loss_weighting:\n          class_path: neurosis.modules.diffusion.EpsWeighting\n",
         "        noise_offset: 0.05\n        noise_offset_chance: 1.0\n        loss_weighting:\n"
         "          class_path: neurosis.modules.diffusion.MinSNRGammaModifier\n          init_args:\n"
         "            gamma: 5.0\n            v_pred: true\n            weighting:\n"
         "              class_path: neurosis.modules.diffusion.EDMWeighting\n"),
        ("            num_idx: 50\n            discretization:\n"
         "              class_path: neurosis.modules.diffusion.LegacyDDPMDiscretization\n",
         "            num_idx: 50\n            discretization:\n"
         "              class_path: neurosis.modules.diffusion.TanZeroSNRDiscretization\n"),
    ]
    for old, new in edits:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    hook = (ROOT / "configs" / "hook" / "loss_scale.example.yml").read_text()
    hooks = hook[hook.index("    forward_hooks:\n"):]
    text = text.replace("\n    model:\n", "\n" + hooks + "\n    model:\n", 1)
    path.write_text(text)
    return path


def test_vpred_step_with_the_tag_hook_matches_jax(tmp_path, monkeypatch):
    from neurosis_tpu.optimizers.stacked import stacked_global_norm
    from neurosis_tpu.trainer.cli import _build as jax_build

    from neurosis_tpu_torch.trainer.cli import _build

    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(_write_folder(tmp_path / "data")))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    config = _vpred_config(tmp_path / "vpred.yaml")
    _, jengine, jdataset, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None))
    _, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                            device="cpu"))
    assert engine.log_sigmas and len(engine.loss_hooks) == len(jengine.loss_hooks) == 1

    indices = next(iter(jdataset.get_batch_iterator()))
    assert next(iter(dataset.get_batch_iterator())) == indices  # each sets its epoch's draws
    host = [hook.pre_hook(jtrainer, jengine, jdataset.get_batch(indices), 0) for hook in jengine.loss_hooks][0]
    port_host = engine.loss_hooks[0].pre_hook(trainer, engine, dataset.get_batch(indices), 0)
    np.testing.assert_array_equal(port_host["loss_scale"], host["loss_scale"])
    jprep = jtrainer.prepare_batch(host)
    prep = trainer.prepare_batch(port_host)
    assert "loss_scale" in prep and prep["loss_scale"].dtype == torch.float32
    np.testing.assert_array_equal(prep["image"].numpy(), jprep["image"])

    jb = {k: jnp.asarray(v) for k, v in jprep.items()}
    jstate, jfrozen = jax.jit(jengine.init)(jax.random.PRNGKey(42), jb)
    p_unet = perturb(jstate.params["model"], 1)
    load_into(engine.model, p_unet)
    load_into(engine.conditioner, jfrozen["conditioner"])
    load_into(engine.first_stage, jfrozen["first_stage"])
    frozen = jax.tree_util.tree_map(jnp.asarray, to_np(jfrozen))

    # the port's encode (held against JAX's in test_torch_cli.py's slice test) gives both sides the latents
    post_eps = np.random.RandomState(7).randn(*engine.encode_first_stage(prep["image"]).shape).astype(np.float32)
    latents = jnp.asarray(engine.encode_first_stage(prep["image"], posterior_noise=torch.tensor(post_eps)).numpy())

    key = jax.random.PRNGKey(3)
    params = {"model": jax.tree_util.tree_map(jnp.asarray, p_unet), "conditioner": {}}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(jengine.loss, has_aux=True))(
        params, frozen, jb, latents, key)
    cond_rng, loss_rng = jax.random.split(key)
    cond_sub = jax.random.split(cond_rng)[1]
    swap = torch.tensor(bool(jax.random.uniform(cond_sub) < 0.5))
    ts, noise, offset = jax_loss_draws(loss_rng, latents.shape, 1.0, True)

    state = engine.init(seed=0)
    state, metrics = engine.train_step(state, prep, t=torch.tensor(ts), noise=torch.tensor(noise),
                                       posterior_noise=torch.tensor(post_eps), offset=torch.tensor(offset),
                                       ucg=[swap])
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(stacked_global_norm(jgrads)), rtol=1e-5)
    for k in ("loss_s0", "loss_smax", "loss_smin"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    logged = engine.loss_hooks[0].batch_hook(engine, port_host, None, {})[1]
    assert logged == jengine.loss_hooks[0].batch_hook(jengine, host, None, {})[1]
    assert set(logged) == {"train/tag_loss_scale_mean", "train/tag_vocab_size"}
