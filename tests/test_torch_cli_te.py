"""The entry point on sdxl-te.example.yaml, against the JAX package, on the CPU
(part (f) of tests/test_torch_cli.py, in a file of its own because it is
the slowest port test and the test runner's workers take whole files).

sdxl-te.example.yaml with its widths and depths cut (8-bit AdamW, the legacy
cosine schedule, both towers trainable at their own base_lr): three steps
from the port's CLI builder and the JAX CLI's builder on shared weights and
the same draws give the losses and grad norms within 1e-5, the same
per-group lr, both towers moving, and updates that agree.
"""

import argparse
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_cli import _cut  # noqa: E402
from torch_parity import load_into, one_torch_thread, perturb, rel_err, to_np  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


def _te_config(tmp_path: Path) -> Path:
    """sdxl-te.example.yaml cut for the CPU: ``_cut``'s widths, a UNet of two
    levels of one ResBlock and one transformer block, towers of 2 layers
    (CLIP-L's hidden layer 1), 64 px images in an aspect-bucketed folder,
    the run root in ``tmp_path``. The optimizer, schedule and base_lr nodes
    as written."""
    import yaml

    from neurosis_tpu_torch.config.loader import load_config

    cfg = _cut(load_config(ROOT / "configs" / "sdxl" / "sdxl-te.example.yaml"))
    m = cfg["model"]["init_args"]
    m["model"]["init_args"].update(channel_mult=[1, 2], num_res_blocks=1, transformer_depth=[1, 1])
    towers = m["conditioner"]["init_args"]["emb_models"][:2]
    for emb in towers:
        emb["init_args"]["layers"] = 2
    towers[0]["init_args"]["layer_idx"] = 1
    folder = tmp_path / "data"
    folder.mkdir()
    rng = np.random.RandomState(0)
    from neurosis_tpu_torch.data.png import write_png

    for i in range(4):
        write_png(folder / f"img_{i}.png", (rng.rand(64, 72, 3) * 255).astype(np.uint8))
        (folder / f"img_{i}.txt").write_text(f"tag{i}, a test image, simple")
    cfg["data"]["init_args"].update(folder=str(folder), buckets={
        "class_path": "neurosis.dataset.aspect.AspectBucketList",
        "init_args": {"n_buckets": 2, "edge_min": 32, "edge_max": 96, "edge_step": 32, "max_aspect": 2.0,
                      "tgt_pixels": 64 * 64}})
    cfg["trainer"]["default_root_dir"] = str(tmp_path / "root")
    # YAML 1.1 reads the config's 3e-5 and 3e-7 as strings, which the port casts and the JAX package's
    # schedule cannot take (ROADMAP Queue 3): the cut copy writes them as floats
    m["optimizer"]["init_args"]["lr"] = float(m["optimizer"]["init_args"]["lr"])
    m["scheduler"]["init_args"]["min_lr"] = float(m["scheduler"]["init_args"]["min_lr"])
    path = tmp_path / "sdxl-te-cut.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_sdxl_te_three_steps_match_jax(tmp_path):
    """JAX's steps run its CLI builder's engine, loss and optimizer by hand,
    around two faults of the JAX package (ROADMAP Queue 3): its Trainer jits
    train_step, and its builder's schedule calls int() on optax's count,
    which a traced count cannot, so here each update is jitted with the
    counts static (``_jax_update``); and its engine splits trainable embedders by the key
    ``embedders.N`` where Flax names them ``embedders_N``, so it trains no
    tower, so here the towers' parameters move from its frozen tree into the
    trainable one (where its optimizer's label_fn files them under
    "default", at the same scale 1.0) and the optimizer is initialised over
    both."""
    import optax

    from neurosis_tpu.modules.distributions import DiagonalGaussian
    from neurosis_tpu.ops.dequant import dequant_image
    from neurosis_tpu.optimizers.stacked import stacked_global_norm
    from neurosis_tpu.schedulers import legacy_cosine_annealing_warmup_restarts
    from neurosis_tpu.trainer.cli import _build as jax_build

    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.optimizers.adamw8bit import AdamW8bit
    from neurosis_tpu_torch.trainer.cli import _build

    config = _te_config(tmp_path)
    _, jengine, jdataset, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None))
    _, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                            device="cpu"))
    assert engine.lr_scales == {0: 1.0, 1: 1.0} and tuple(jengine.trainable_embedders) == (0, 1)
    indices = next(iter(jdataset.get_batch_iterator()))
    assert next(iter(dataset.get_batch_iterator())) == indices
    jprep = jtrainer.prepare_batch(jdataset.get_batch(indices))
    prep = trainer.prepare_batch(dataset.get_batch(indices))
    for k, v in jprep.items():
        np.testing.assert_array_equal(prep[k].numpy(), v, err_msg=k)

    jbatch = {k: jnp.asarray(v) for k, v in jprep.items()}
    jstate, jfrozen = jax.jit(jengine.init)(jax.random.PRNGKey(42), jbatch)
    frozen = to_np(jfrozen)
    assert not jstate.params["conditioner"] and sorted(frozen["conditioner"]) == ["embedders_0", "embedders_1"]
    params = {"model": perturb(jstate.params["model"], 1), "conditioner": frozen.pop("conditioner")}
    frozen["conditioner"] = {}
    load_into(engine.model, params["model"])
    load_into(engine.conditioner, params["conditioner"])
    load_into(engine.first_stage, frozen["first_stage"])
    state = engine.init(seed=0)
    assert isinstance(state.optimizer, AdamW8bit) and len(state.optimizer.param_groups) == 3

    def loss(p, t, noise, post_eps):
        x = dequant_image(jbatch[jengine.input_key])
        moments = jengine.first_stage.apply({"params": frozen["first_stage"]}, x, method="encode")
        dist = DiagonalGaussian.from_moments(moments)
        latents = jengine.scale_factor * (dist.mean + dist.std * post_eps)
        cond = jengine.conditioner.apply({"params": jengine._merged_cond_params(p, frozen)}, jbatch, rng=None)
        sig = jengine.loss_fn.sigma_generator(latents.shape[0], t).astype(latents.dtype)

        def net(x, c_noise, c):
            return jengine.model.apply({"params": p["model"]}, x, c_noise, c.get("crossattn"), y=c.get("vector"),
                                       deterministic=False)

        d = jengine.denoiser(net, latents + sig[:, None, None, None] * noise, sig, cond, "D")
        return jengine.loss_fn.get_loss(d, latents, jengine.loss_fn.loss_weighting(sig)).mean()

    value_and_grad = jax.jit(jax.value_and_grad(loss))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = jax.jit(jengine.optimizer.init)(jparams)
    start = {k: v.detach().clone() for k, v in engine.named_trainable_parameters()}
    grad_top: dict = {}
    rng = np.random.RandomState(7)
    for k in range(3):
        shape = tuple(engine.encode_first_stage(prep["image"]).shape)
        t = np.array([0.2 + 0.25 * k, 0.7], np.float32)[: shape[0]]
        noise, post_eps = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
        val, grads = value_and_grad(jparams, jnp.asarray(t.copy()), jnp.asarray(noise.copy()),
                                    jnp.asarray(post_eps.copy()))
        for name, g in {**jax_params_to_state_dict(to_np(grads["model"]), "model."),
                        **jax_params_to_state_dict(to_np(grads["conditioner"]), "conditioner.")}.items():
            grad_top[name] = max(grad_top.get(name, 0.0), float(g.abs().max()))
        updates, opt_state = _jax_update(jengine.optimizer, grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        state, metrics = engine.train_step(state, prep, t=torch.tensor(t), noise=torch.tensor(noise),
                                           posterior_noise=torch.tensor(post_eps))
        np.testing.assert_allclose(float(metrics["loss"]), float(val), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(stacked_global_norm(grads)), rtol=1e-5)

    counts = {int(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]
              if str(getattr(path[-1], "name", "")) == "count"}
    assert counts == {3} and state.optimizer.count == 3
    sched = legacy_cosine_annealing_warmup_restarts(**_sched_args(config))
    assert [g["lr"] for g in state.optimizer.param_groups] == [float(3e-5) * float(sched(3))] * 3

    want = {**jax_params_to_state_dict(to_np(jparams["model"]), "model."),
            **jax_params_to_state_dict(to_np(jparams["conditioner"]), "conditioner.")}
    moved, noise_floor = set(), 1e-6 * max(grad_top.values())
    for name, p in engine.named_trainable_parameters():
        got, w, p0 = p.detach().numpy(), want[name].numpy(), start[name].numpy()
        if grad_top[name] < noise_floor:
            # a grad that is 0 but for float noise (the k biases, zero at init): Adam scales the noise to ±lr
            assert np.abs(got - w).max() <= 2 * float(3e-5) * 2 * 0.08, name
            continue
        if np.abs(p0).any():  # a tensor still at its zero init is held by its updates alone
            assert rel_err(got, w) < 1e-5, name
        dp, dj = got - p0, w - p0
        top = np.abs(dj).max()
        # grads agree to ~1e-4 of their largest, which flips a few 8-bit codes by one step (13.8% of m)
        assert np.abs(dp - dj).max() <= 0.2 * top + 1e-9, name
        assert np.abs(dp - dj).mean() <= 0.01 * np.abs(dj).mean() + 1e-12, \
            (name, float(np.abs(dp - dj).mean()), float(np.abs(dj).mean()), float(np.abs(dp - dj).max()), float(top),
             float(np.abs(w).max()))
        if top > 0 and np.abs(dp).max() > 0:
            moved.add(name.split(".")[2] if name.startswith("conditioner.") else "unet")
    assert moved == {"unet", "0", "1"}  # the UNet and both towers


def _jax_update(optimizer, grads, state, params):
    """``optimizer.update`` jitted with the state's counts as static Python
    ints, rebuilt as numpy constants inside: the JAX builder's schedule calls
    int() on optax's count, which a traced count refuses."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(state)
    counts = tuple(int(leaf) if str(getattr(path[-1], "name", "")) == "count" else None for path, leaf in flat)

    def update(g, p, others, counts):
        it = iter(others)
        leaves = [next(it) if c is None else np.asarray(c, np.int32) for c in counts]
        return optimizer.update(g, jax.tree_util.tree_unflatten(treedef, leaves), p)

    others = [leaf for (_, leaf), c in zip(flat, counts) if c is None]
    return jax.jit(update, static_argnums=3)(grads, params, others, counts)


def _sched_args(config: Path) -> dict:
    from neurosis_tpu_torch.config.loader import load_config

    return load_config(config)["model"]["init_args"]["scheduler"]["init_args"]
