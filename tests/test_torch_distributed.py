"""The port's training on more than one rank, held to its one-process run
(CPU, gloo; ``tests/torch_dist_worker.py`` is the ranks' script).

Three sets of processes run at once, one a mesh: data 2, fsdp 2 and
data 2 x fsdp 2 (4 ranks), at sd15-tiny's and vae-tiny's dims. Each rank
starts as its own ``python`` process over a file store (``mp.spawn`` over TCP
lost a rank under FSDP2 in this sandbox), with one torch thread and a
timeout. Rank 0 of each set holds every scenario against the port's
one-process run of the same global batch and writes its errors as shares of
their tolerances; the module fixture reads them, so each (mesh, scenario) is
a test case of its own:

- 2 Adafactor steps with EMA, and 2 of CAME, of optax AdamW and of the 8-bit
  AdamW: the metrics (loss, grad norm, the log_sigmas per-row ones) rtol
  1e-5, parameters and EMA shadows atol 1e-6 / rtol 1e-5; the 8-bit codes
  equal and their scales rtol 1e-6;
- a VAE-GAN pair (G, D, G) over an EMA codebook with a BatchNorm PatchGAN
  and the adaptive GAN weight: metrics and the codebook buffers rtol 1e-5,
  the BatchNorm running statistics atol 1e-7 / rtol 1e-6, the codebook
  indices of every G step equal;
- on the two-rank meshes, a G/D pair over an ActNorm PatchGAN (its
  first-batch init made inside the wrapped forward, written back to the
  sharded parameters), and a checkpoint of the ranks resumed by one process
  and one of one process resumed by the ranks, each taking a third step.

Also here: the fsdp-2 step held against JAX's ``train_step`` jitted on a
(1, 2) mesh of this process's CPU devices through JAX's own
``shard_state``/``shard_batch``, with JAX's draws replayed; and the CLI's
``fit`` on the data-2 mesh against a one-process ``fit`` of the same config.

Sequence parallelism (ring attention on the mesh's context axis): the ring
over 2 and 4 ranks against the plain attention of the whole sequence and
against JAX's ``ring_attention_sharded`` on a context mesh of as many of
this process's CPU devices (3e-6/1e-4 forward, 2e-5/1e-3 grads, as
``tests/test_flash_attention.py:51,58``), with S not divisible by the ring
taking the whole sequence; and the CLI's ``fit`` with ``context_parallel:
2`` (2 ranks) and with fsdp 2 x context 2 (4 ranks) against a one-process
``fit`` of the same config (losses rtol 1e-5, parameters as the other fits).

The ranks start from a fixed environment (``_rank_env``): this process's
variables less every switch of either package, of the thread pools and of
the launchers, so that what an earlier test file left in a worker's
environment reaches no rank. The one-process fits run in a rank process too
(rank 0 of its set, before the mesh runs), so that every compared number is
computed in a process of that kind, on one torch thread. A failing case
prints its errors as shares of their tolerances and the tail of its mesh's
rank logs.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread, perturb, to_np  # noqa: F401

import torch_dist_worker as worker

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"data2": 2, "fsdp2": 2, "data2xfsdp2": 4}
RINGS = {"data2": 2, "data2xfsdp2": 4}  # the sets whose ranks run the ring, and its size
CONTEXT_FITS = {"cli_context2": "fsdp2", "cli_fsdp2_context2": "data2xfsdp2"}
# variables no rank inherits: either package's switches, thread pools, launchers, JAX's
_DROPPED = ("NEUROSIS_", "OMP_", "MKL_", "KMP_", "OPENBLAS_", "TORCH_", "ATEN_", "GLOO_", "NCCL_", "CUDA_",
            "XLA_", "JAX_", "TPU_", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
            "MASTER_PORT", "PYTHONHASHSEED", "PYTEST_")
COMMON = ["adafactor", "came", "adamw", "adamw8bit", "vae_pair"]
CASES = [(m, s) for m, n in MESHES.items()
         for s in COMMON + (["actnorm_pair", "ckpt_n_to_1", "ckpt_1_to_n"] if n == 2 else [])]
TIMEOUT = 600  # seconds a rank may take; about 70 alone


def _write_folder(folder: Path, n: int = 4) -> Path:
    from neurosis_tpu_torch.data.png import write_png

    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(n):
        write_png(folder / f"img_{i}.png", (rng.rand(40, 48, 3) * 255).astype(np.uint8))
        (folder / f"img_{i}.txt").write_text(f"tag{i}, a test image, simple")
    return folder


def _jax_inputs(out: Path):
    """JAX's engine of the worker's plain sd15-tiny config: its weights (the
    UNet perturbed, so zero-initialised layers take part), a batch of
    latents and the draws its ``train_step`` makes, written for the worker;
    returns what JAX's mesh step needs."""
    import jax
    import jax.numpy as jnp

    from neurosis_tpu.trainer.builder import build_engine
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict

    cfg = worker.sd_config(worker.OPTIMIZERS["adafactor"], ema=False, plain=True)
    engine = build_engine(copy.deepcopy(cfg))
    rng = np.random.RandomState(3)
    batch = {"image": rng.randint(0, 256, size=(2, 16, 16, 3)).astype(np.uint8),
             "latents": rng.randn(2, 8, 8, 4).astype(np.float32),
             "caption_ids": rng.randint(0, 49406, size=(2, 77)).astype(np.int32),
             "uncond_ids": np.full((1, 77), 49407, np.int32)}
    state, frozen = jax.jit(engine.init)(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    unet = perturb(state.params["model"], 1)
    state = state._replace(params={**state.params, "model": jax.tree_util.tree_map(jnp.asarray, unet)})
    # train_step's draws: next_rngs(state.rng, 2) → step_rng; loss(): split → loss_rng; the loss's t and noise
    step_rng = jax.random.split(state.rng, 3)[2]
    loss_rng = jax.random.split(step_rng)[1]
    t_rng, noise_rng, _ = jax.random.split(loss_rng, 3)
    t = np.asarray(jax.random.uniform(t_rng, (2,), dtype=jnp.float32))
    noise = np.asarray(jax.random.normal(noise_rng, batch["latents"].shape, dtype=jnp.float32))
    weights = {**jax_params_to_state_dict(unet, "model."),
               **jax_params_to_state_dict(to_np(frozen["conditioner"]), "conditioner.")}
    np.savez(out / "jax_inputs.tmp.npz", t=t, noise=noise, **{k: v for k, v in batch.items() if k != "image"},
             **{k: v.numpy() for k, v in weights.items()})
    os.rename(out / "jax_inputs.tmp.npz", out / "jax_inputs.npz")  # the fsdp-2 ranks wait for it
    return engine, state, frozen, batch


def _jax_mesh_step(engine, state, frozen, batch) -> dict:
    import jax

    from neurosis_tpu.parallel.mesh import make_mesh, shard_batch, shard_state
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict

    mesh = make_mesh(data=1, fsdp=2, devices=jax.devices()[:2])
    step_batch = {k: v for k, v in batch.items() if k != "image"}
    with mesh:
        new, metrics = jax.jit(engine.train_step)(shard_state(mesh, state, 2), shard_state(mesh, frozen, 2),
                                                  shard_batch(mesh, step_batch))
    assert any(leaf.sharding.spec != jax.sharding.PartitionSpec()
               for leaf in jax.tree_util.tree_leaves(new.params))  # the step ran on sharded leaves
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "params": {k: v.numpy() for k, v in jax_params_to_state_dict(to_np(new.params["model"]), "model.").items()},
            "before": {k: v.numpy() for k, v in jax_params_to_state_dict(to_np(state.params["model"]),
                                                                         "model.").items()}}


def _rank_env(data: Path) -> dict:
    """The ranks' environment: this process's, less ``_DROPPED``, plus the
    run's own settings."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(_DROPPED)}
    env.update(NEUROSIS_SMOKE_DATA=str(data), NEUROSIS_ALLOW_HASH_TOKENIZER="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PYTHONHASHSEED="0")
    return env


def _log_tail(out: Path, mesh: str, chars: int = 3000) -> str:
    return "\n".join(f"--- {mesh} rank {r} ---\n" + (out / f"{mesh}_{r}.log").read_text()[-chars:]
                     for r in range(MESHES[mesh]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    data = _write_folder(out / "data")
    env = _rank_env(data)
    procs = []
    for mesh, world in MESHES.items():
        for rank in range(world):
            # the CLI's fit reads torchrun's environment, as under a launcher
            rank_env = dict(env, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                            LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT="0")
            log = open(out / f"{mesh}_{rank}.log", "w")
            procs.append((mesh, rank, log, subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_dist_worker.py"), str(rank), str(out / f"{mesh}.store"),
                 str(out), mesh], stdout=log, stderr=subprocess.STDOUT, env=rank_env, cwd=str(out))))
    try:
        want_jax = _jax_mesh_step(*_jax_inputs(out))
        want_rings = {mesh: _jax_rings(n) for mesh, n in RINGS.items()}
        for mesh, rank, log, p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for *_, log, p in procs:
            if p.poll() is None:
                p.kill()
            log.close()
    for mesh, rank, _, p in procs:
        assert p.returncode == 0, f"{mesh} rank {rank}:\n" + (out / f"{mesh}_{rank}.log").read_text()[-4000:]
    return {"out": out, "jax": want_jax, "jax_rings": want_rings,
            **{mesh: json.loads((out / f"{mesh}.json").read_text()) for mesh in MESHES}}


def _shares(runs, mesh: str, errors: dict) -> str:
    """A failure's message: the errors as shares of their tolerances, the seconds, the ranks' logs."""
    return (f"{mesh}: " + json.dumps({k: v for k, v in errors.items()}, indent=1) + f"\nseconds: "
            f"{runs[mesh].get('seconds')}\n" + _log_tail(runs["out"], mesh))


@pytest.mark.parametrize("mesh,scenario", CASES)
def test_ranks_match_the_one_process_run(runs, mesh, scenario):
    errors = runs[mesh]["results"][scenario]
    assert errors and all(e <= 1.0 for e in errors.values()), _shares(runs, mesh, errors)


def _jax_rings(n: int) -> dict:
    """JAX's ``ring_attention_sharded`` on a ("context",) mesh of ``n`` CPU
    devices, forward and q/k/v grads of sum(O·dO), for each S of the ring
    inputs that ``n`` divides."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from neurosis_tpu.ops.ring_attention import ring_attention_sharded

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("context",))
    out = {}
    for label, s in (("ring", worker.RING_SHAPE[2]), ("odd", worker.RING_ODD_S)):
        if s % n:
            continue
        q, k, v, do = (jnp.asarray(a.copy()) for a in worker.ring_inputs(s))
        o, vjp = jax.vjp(lambda q, k, v: ring_attention_sharded(q, k, v, mesh), q, k, v)
        for name, x in zip(("o", "dq", "dk", "dv"), (o,) + vjp(do)):
            out[f"{label}/{name}"] = np.array(x)
    return out


@pytest.mark.parametrize("mesh", list(RINGS))
def test_ring_matches_the_whole_sequence(runs, mesh):
    """The ring over the set's ranks against the plain attention of the
    whole sequence (every rank gathering rank 0's bits), and at S not
    divisible by the ring the whole-sequence path, exactly."""
    errors = runs[mesh]["results"]["ring"]
    assert errors and all(e <= 1.0 for e in errors.values()), _shares(runs, mesh, errors)


@pytest.mark.parametrize("mesh", list(RINGS))
def test_ring_matches_jax_ring_attention_sharded(runs, mesh):
    got = np.load(runs["out"] / f"ring_{mesh}.npz")
    want = runs["jax_rings"][mesh]
    assert set(want) >= {"ring/o", "ring/dq", "ring/dk", "ring/dv"}
    for key, w in want.items():
        tol = worker.FWD if key.endswith("/o") else worker.GRAD
        np.testing.assert_allclose(got[key], w, atol=tol[0], rtol=tol[1], err_msg=f"{mesh} {key}")


@pytest.mark.parametrize("fit", list(CONTEXT_FITS))
def test_context_parallel_fit_matches_one_process(runs, fit):
    """``fit`` through the CLI with ``context_parallel: 2`` (the UNet's
    self-attention on the ring, its blocks checkpointed so that the ring is
    recomputed in the backward): rank 0 wrote a metrics line and a
    checkpoint a step, and both match the one-process ``fit`` of the same
    config."""
    out = runs["out"]
    # 2 steps x 4 transformer blocks (level 1's input, middle and two output ones), each run again in
    # its checkpointed backward
    assert runs[CONTEXT_FITS[fit]]["results"]["context_fit_ring_calls"] == 16
    (got_lines, got_ckpt), (one_lines, one_ckpt) = _read_fit(out / fit), _read_fit(out / "cli_one_remat")
    assert [r["step"] for r in got_lines] == [r["step"] for r in one_lines] == [1, 2], _log_tail(out, CONTEXT_FITS[fit])
    for a, b in zip(got_lines, one_lines):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    assert got_ckpt["step"] == one_ckpt["step"] == 2
    for k, v in one_ckpt["params"].items():
        assert worker.err(got_ckpt["params"][k], v, worker.F32) <= 1.0, k


def _read_fit(root: Path):
    lines = [json.loads(line) for line in (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    return lines, torch.load(root / "checkpoints" / "2" / "state.pt", weights_only=True)


def test_fsdp2_step_matches_jax_mesh_step(runs):
    want = runs["jax"]
    got = np.load(runs["out"] / "jax_step_port.npz")
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5, err_msg=_log_tail(runs["out"], "fsdp2"))
    np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"], rtol=1e-5)
    # the step's update, each tensor's within 1e-3 of its largest: JAX and
    # torch compute the gradient in other orders, and a factored statistic
    # taken over one rank's half of a leaf would be off by far more
    for k, before in want["before"].items():
        upd_want = want["params"][k] - before
        upd_got = got["params/" + k] - before
        scale = max(float(np.abs(upd_want).max()), 1e-12)
        assert float(np.abs(upd_got - upd_want).max()) <= 1e-3 * scale, k


def test_cli_fit_on_the_mesh_matches_one_process(runs):
    """``fit`` through the CLI on the data-2 mesh (``strategy: ddp``, as
    torchrun would launch it): rank 0 alone wrote one metrics line a step
    and one checkpoint a step, and both match a one-process ``fit``."""
    out = runs["out"]
    (mesh_lines, mesh_ckpt), (one_lines, one_ckpt) = _read_fit(out / "cli_mesh"), _read_fit(out / "cli_one")
    assert [r["step"] for r in mesh_lines] == [r["step"] for r in one_lines] == [1, 2]
    for a, b in zip(mesh_lines, one_lines):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    assert mesh_ckpt["step"] == one_ckpt["step"] == 2
    for k, v in one_ckpt["params"].items():
        assert worker.err(mesh_ckpt["params"][k], v, worker.F32) <= 1.0, k
