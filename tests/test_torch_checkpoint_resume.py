"""Checkpoint save and resume of the port (trainer/callbacks.py
CheckpointCallback, trainer/loop.py Trainer._maybe_resume), on the CPU.

(a) A save and a resume give back the parameters, the optimizer state (8-bit
    codes and scales, the schedule's count and lr), the EMA shadows and the
    step bitwise, for the diffusion engine (sd15-tiny in fp32, with a
    trainable text tower at its own base_lr, AdamW8bit, the legacy cosine
    schedule and EMA) and for the VAE trainer (vae-tiny with EMA; like the
    JAX package, its optimizers' state is not saved).
(b) Two steps, a save, then a third step from the resumed run equals a
    third step from the saved state in memory under the same generator,
    bitwise.
(c) Only the newest ``keep`` checkpoints stay; an interrupted save leaves
    the previous one readable and the next save clears its remains.
(d) A directory of JAX orbax trees and a corrupt file raise, an empty
    checkpoints/ starts fresh; a ``memory://`` dirpath saves to the blob
    store (pruned to ``keep``) and ``Trainer(remote_checkpoint_url=...)``
    resumes from it bitwise (the sd15 engine in (b), the VAE trainer here),
    a ``file://`` dirpath saves in the local directory it names, and a
    scheme without a filesystem raises, naming it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
TINY = ROOT / "configs" / "smoke" / "sd15-tiny.yaml"
VAE_TINY = ROOT / "configs" / "smoke" / "vae-tiny.yaml"


def _engine(seed: int, vae: bool = False):
    """The tiny config's engine, fp32; its trainable weights perturbed by
    ``seed`` (the frozen ones are the build seed's on every engine, as a
    run's ckpt_path would give them)."""
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.trainer.builder import build_engine

    node = load_config(VAE_TINY if vae else TINY)["model"]
    ia = node["init_args"]
    ia["use_ema"] = True
    if not vae:
        ia["base_lr"] = 1.0
        ia["conditioner"]["init_args"]["emb_models"][0]["init_args"].update(is_trainable=True, base_lr=0.5)
        ia["optimizer"] = {"class_path": "bitsandbytes.optim.AdamW8bit",
                           "init_args": {"lr": 1e-3, "weight_decay": 1e-2, "min_8bit_size": 1024}}
        ia["scheduler"] = {"class_path": "neurosis.schedulers.LegacyCosineAnnealingWarmupRestarts",
                           "init_args": {"first_cycle_steps": 10, "min_lr": 0.1, "warm_up_steps": 2}}
    engine = build_engine(node, None, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(seed)
    params = engine.g_parameters() if vae else engine.trainable_parameters()
    with torch.no_grad():
        for p in params:
            p.add_(1e-3 * torch.randn(p.shape, generator=g))
    return engine


def _trainer(engine, root: Path, remote_checkpoint_url=None):
    from neurosis_tpu_torch.trainer.loop import Trainer

    return Trainer(engine, default_root_dir=str(root), fast_dev_run=True, remote_checkpoint_url=remote_checkpoint_url)


def _batch(vae: bool = False) -> dict:
    g = torch.Generator().manual_seed(5)
    batch = {"image": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g)}
    if not vae:
        batch["caption_ids"] = torch.randint(0, 49408, (2, 77), generator=g)
    return batch


def _equal(a, b, where: str = "") -> None:
    """Nested dicts/lists of tensors and scalars, equal bitwise."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _equal(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    else:
        assert a == b, where


def _snapshot(engine, state) -> dict:
    from neurosis_tpu_torch.trainer.callbacks import state_payload

    import copy

    return copy.deepcopy(state_payload(engine, state))  # the optimizer's state tensors too, which steps update in place


def test_diffusion_round_trip_and_third_step(tmp_path):
    from neurosis_tpu_torch.trainer.callbacks import CheckpointCallback

    engine = _engine(1)
    assert [g.get("lr_scale") for g in engine.param_groups()] == [None, 0.5]
    state = engine.init(seed=3)
    batch = _batch()
    for _ in range(2):
        state, _ = engine.train_step(state, batch)
    assert state.optimizer.count == 2 and any("mu_codes" in s for s in state.optimizer.state.values())
    CheckpointCallback(every_n_train_steps=2).on_train_batch_end(_trainer(engine, tmp_path), state, None, {}, 2)
    assert (tmp_path / "checkpoints" / "2" / "state.pt").is_file()
    url = f"memory://test_torch_checkpoint_resume/{tmp_path.name}/sd15"
    remote = CheckpointCallback(dirpath=url, every_n_train_steps=2)
    remote.on_train_batch_end(_trainer(engine, tmp_path), state, None, {}, 2)
    remote.on_fit_end(None, state)  # waits for the write
    saved = _snapshot(engine, state)
    generator = state.generator.get_state()

    other = _engine(2)
    assert not torch.equal(other.trainable_parameters()[0], engine.trainable_parameters()[0])
    trainer = _trainer(other, tmp_path)
    resumed = trainer._start("validate")  # a resumed run's weights count as loaded
    assert resumed.step == 2 and trainer._weights_loaded
    _equal(_snapshot(other, resumed), saved)
    assert [g["schedule_count"] for g in resumed.optimizer.param_groups] == [2, 2]
    assert [g["lr"] for g in resumed.optimizer.param_groups] == [g["lr"] for g in state.optimizer.param_groups]

    state, m = engine.train_step(state, batch)
    resumed.generator.set_state(generator)
    resumed, m2 = other.train_step(resumed, batch)
    assert float(m["loss"]) == float(m2["loss"])
    _equal(_snapshot(other, resumed), _snapshot(engine, state))

    # the blob store's step 2, over the third step's state, from a root without checkpoints/
    trainer = _trainer(other, tmp_path / "elsewhere", remote_checkpoint_url=url)
    from_store = trainer._start("validate")
    assert from_store.step == 2 and trainer._weights_loaded
    _equal(_snapshot(other, from_store), saved)


def test_vae_round_trip_saves_params_step_and_ema(tmp_path):
    from neurosis_tpu_torch.trainer.callbacks import CheckpointCallback

    engine = _engine(1, vae=True)
    state = engine.init(seed=3)
    batch = _batch(vae=True)
    state, _ = engine.g_step(state, batch)
    state, _ = engine.d_step(state, batch)
    CheckpointCallback(every_n_train_steps=1).save(_trainer(engine, tmp_path), state, 2)
    saved = _snapshot(engine, state)
    assert "opt_state" not in saved and {"loss.discr", "loss.lpips"} & {n.rsplit(".", 3)[0] for n in saved["params"]}

    other = _engine(2, vae=True)
    resumed = _trainer(other, tmp_path)._start("fit")
    assert resumed.step == 2 and not resumed.g_optimizer.state  # JAX saves no VAE optimizer state either
    _equal(_snapshot(other, resumed), saved)


def test_keep_rotation_and_an_interrupted_save(tmp_path, monkeypatch):
    from neurosis_tpu_torch.trainer.callbacks import (STATE_FILE, CheckpointCallback, checkpoint_steps,
                                                      load_checkpoint)

    engine = _engine(1, vae=True)
    state = engine.init(seed=0)
    trainer = _trainer(engine, tmp_path)
    cb = CheckpointCallback(dirpath=str(tmp_path / "ck"), every_n_train_steps=1, keep=2)
    for step in range(1, 6):
        state.step = step
        cb.on_train_batch_end(trainer, state, None, {}, step)
    root = tmp_path / "ck"
    assert checkpoint_steps(root) == [4, 5]

    real_save = torch.save

    def interrupted(obj, f, *args, **kwargs):
        f.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", interrupted)
    state.step = 6
    with pytest.raises(OSError, match="disk full"):
        cb.save(trainer, state, 6)
    monkeypatch.setattr(torch, "save", real_save)
    assert checkpoint_steps(root) == [4, 5] and (root / "6.tmp").is_dir()
    assert load_checkpoint(root / "5" / STATE_FILE)["step"] == 5
    cb.save(trainer, state, 6)
    assert checkpoint_steps(root) == [5, 6] and sorted(p.name for p in root.iterdir()) == ["5", "6"]


def test_unreadable_checkpoints_raise_and_an_empty_folder_starts_fresh(tmp_path):
    from neurosis_tpu_torch.trainer.callbacks import CheckpointCallback, checkpoint_steps

    engine = _engine(1, vae=True)
    ckpt = tmp_path / "checkpoints"
    ckpt.mkdir()
    assert _trainer(engine, tmp_path)._start("fit").step == 0
    (ckpt / "3").mkdir()
    (ckpt / "3" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax checkpoint of the JAX package"):
        _trainer(engine, tmp_path)._start("fit")
    (ckpt / "3" / "_CHECKPOINT_METADATA").unlink()
    (ckpt / "3" / "state.pt").write_bytes(np.random.RandomState(0).bytes(256))
    with pytest.raises(ValueError, match="cannot read checkpoint"):
        _trainer(engine, tmp_path)._start("fit")

    from neurosis_tpu_torch.checkpoint.blob import BlobCheckpointIO

    state = _trainer(engine, tmp_path / "fresh")._start("fit")
    url = f"memory://test_torch_checkpoint_resume/{tmp_path.name}/vae"
    remote, local = (CheckpointCallback(dirpath=d, every_n_train_steps=1, keep=2)
                     for d in (url, f"file://{tmp_path}/local"))
    for step in (1, 2, 3):
        state.step = step
        for cb in (remote, local):
            cb.on_train_batch_end(_trainer(engine, tmp_path / "fresh"), state, None, {}, step)
    remote.on_fit_end(None, state)
    assert BlobCheckpointIO(url).list_steps() == [2, 3] and checkpoint_steps(tmp_path / "local") == [2, 3]
    saved = _snapshot(engine, state)
    with torch.no_grad():
        for p in engine.g_parameters():
            p.add_(1.0)
    resumed = _trainer(engine, tmp_path / "fresh", remote_checkpoint_url=url)._start("fit")
    assert resumed.step == 3
    _equal(_snapshot(engine, resumed), saved)
    with pytest.raises(ValueError, match="'nosuchscheme'"):
        CheckpointCallback(dirpath="nosuchscheme://bucket/run")

    # a fit stopped by SIGTERM (launch_pod's Terminated) finishes the write in flight before it raises
    import time

    from neurosis_tpu_torch.tools.launch_pod import Terminated
    from neurosis_tpu_torch.trainer.loop import Trainer
    from neurosis_tpu_torch.utils.fs import MemoryFileSystem

    class SlowStore(MemoryFileSystem):
        def open(self, path, mode="rb"):
            if mode == "wb":
                time.sleep(0.5)
            return super().open(path, mode)

    def stopped():
        yield {k: v.numpy() for k, v in _batch(vae=True).items()}  # a dataset's host batch
        raise Terminated("signal 15")

    url = f"memory://test_torch_checkpoint_resume/{tmp_path.name}/stopped"
    cb = CheckpointCallback(dirpath=url, every_n_train_steps=1, keep=2)
    cb.blob._fs = SlowStore()
    with pytest.raises(Terminated):
        Trainer(engine, max_steps=5, default_root_dir=str(tmp_path / "stopped"), callbacks=[cb]).fit(stopped)
    assert BlobCheckpointIO(url).list_steps() == [1]
