"""Reference-layout (sgm) checkpoints between the JAX package and the port, at
configs/smoke/sd15-tiny.yaml's dims with EMA on and the precision key
removed (fp32).

- The JAX package's export_sgm_checkpoint (UNet, CLIP tower, VAE, the UNet's
  EMA shadows under LitEma's names) loads into the port's engine with no
  missing and no unexpected key, every tensor equal to JAX's.
- One train_step of the loaded engine matches JAX's loss and grad norm within
  1e-5, with t, noise and posterior noise passed.
- The port's own export loads back into a fresh engine: every tensor, every
  shadow and the EMA update count equal.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
pytest.importorskip("safetensors")  # the JAX package's writer
import jax.numpy as jnp  # noqa: E402

from test_torch_cli import TINY, jax_loss_and_grad_norm  # noqa: E402
from torch_parity import grads_by_key, one_torch_thread, perturb, to_np  # noqa: E402,F401


def _model_node() -> dict:
    from neurosis_tpu_torch.config.loader import load_config

    node = load_config(TINY)["model"]
    node["init_args"]["use_ema"] = True
    return node


def _port_engine(seed: int):
    from neurosis_tpu_torch.trainer.builder import build_engine

    engine = build_engine(_model_node(), None, device=torch.device("cpu"),
                          generator=torch.Generator().manual_seed(seed))
    return engine, engine.init(seed)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(JAX engine, state, frozen, batch, path) of an exported checkpoint:
    UNet perturbed, EMA shadows perturbed apart from it, 7 EMA updates."""
    from neurosis_tpu.checkpoint.sgm import export_sgm_checkpoint
    from neurosis_tpu.modules.ema import EmaState
    from neurosis_tpu.trainer.builder import build_engine
    from neurosis_tpu.trainer.loop import HashTokenizer

    engine = build_engine(_model_node())
    rng = np.random.RandomState(0)
    batch = {"image": rng.randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8),
             "caption_ids": HashTokenizer()(["a test image, simple", "tag1, tag2"])}
    state, frozen = jax.jit(engine.init)(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    params = {"model": perturb(state.params["model"], 1), "conditioner": {}}
    shadows = {"model": perturb(state.params["model"], 2), "conditioner": {}}
    state = state._replace(params=jax.tree_util.tree_map(jnp.asarray, params),
                           ema=EmaState(jax.tree_util.tree_map(jnp.asarray, shadows), jnp.asarray(7, jnp.int32)))
    path = tmp_path_factory.mktemp("ckpt") / "sd15-tiny.safetensors"
    export_sgm_checkpoint(engine, state, frozen, path)
    return engine, state, frozen, batch, path


def test_jax_export_loads_into_the_port(jax_checkpoint):
    from neurosis_tpu_torch.checkpoint.sgm import load_sgm_checkpoint

    _, jstate, jfrozen, _, path = jax_checkpoint
    engine, state = _port_engine(3)
    state, report = load_sgm_checkpoint(engine, state, path, with_report=True)
    assert report["missing"] == [] and report["unexpected"] == []
    assert set(report["per_component"]) == {"unet", "conditioner", "first_stage", "model_ema"}
    for module, tree in ((engine.model, jstate.params["model"]), (engine.conditioner, jfrozen["conditioner"]),
                         (engine.first_stage, jfrozen["first_stage"])):
        want = grads_by_key(tree)
        got = {k: v.detach().numpy() for k, v in module.state_dict().items()}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = grads_by_key(jstate.ema.params["model"])
    for (name, _), shadow in zip(engine.model.named_parameters(), state.ema.params):
        np.testing.assert_array_equal(shadow.numpy(), want[name], err_msg=name)
    assert state.ema.num_updates == 7


def test_a_step_from_the_jax_checkpoint_matches_jax(jax_checkpoint):
    from neurosis_tpu_torch.checkpoint.sgm import load_sgm_checkpoint

    jengine, jstate, jfrozen, batch, path = jax_checkpoint
    engine, state = _port_engine(4)
    load_sgm_checkpoint(engine, state, path)
    rng = np.random.RandomState(5)
    t = np.array([0.2, 0.9], np.float32)
    noise, post_eps = (rng.randn(2, 32, 32, 4).astype(np.float32) for _ in range(2))
    want_loss, want_norm = jax_loss_and_grad_norm(jengine, to_np(jstate.params["model"]), to_np(jfrozen), batch, t,
                                                  noise, post_eps)
    tbatch = {k: torch.tensor(v.copy()) for k, v in batch.items()}
    state, metrics = engine.train_step(state, tbatch, t=torch.tensor(t), noise=torch.tensor(noise),
                                       posterior_noise=torch.tensor(post_eps))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), want_norm, rtol=1e-5)


def test_port_export_round_trips(tmp_path):
    from neurosis_tpu_torch.checkpoint.sgm import export_sgm_checkpoint, load_sgm_checkpoint

    engine, state = _port_engine(1)
    batch = {"image": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                                    generator=torch.Generator().manual_seed(2)),
             "caption_ids": torch.randint(0, 49408, (2, 77), generator=torch.Generator().manual_seed(3))}
    state, _ = engine.train_step(state, batch)  # shadows move apart from the parameters
    export_sgm_checkpoint(engine, state, tmp_path / "port.safetensors")

    fresh, fresh_state = _port_engine(9)
    fresh_state, report = load_sgm_checkpoint(fresh, fresh_state, tmp_path / "port.safetensors", with_report=True)
    assert report["missing"] == [] and report["unexpected"] == []
    for name in ("model", "conditioner", "first_stage"):
        want, got = getattr(engine, name).state_dict(), getattr(fresh, name).state_dict()
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    for got, want in zip(fresh_state.ema.params, state.ema.params):
        assert torch.equal(got, want)
    assert fresh_state.ema.num_updates == state.ema.num_updates == 1


def test_missing_checkpoint_trains_from_the_seeded_init(tmp_path, caplog):
    """A ckpt_path that does not exist warns and keeps the seeded init, as
    the JAX trainer does."""
    from neurosis_tpu_torch.trainer.loop import Trainer

    engine, _ = _port_engine(1)
    before = [p.detach().clone() for p in engine.model.parameters()]
    engine.ckpt_path = str(tmp_path / "absent.safetensors")
    trainer = Trainer(engine, default_root_dir=str(tmp_path), fast_dev_run=True)
    trainer._start("fit")
    assert "not found" in caplog.text
    assert all(torch.equal(a, b) for a, b in zip(before, engine.model.parameters()))
