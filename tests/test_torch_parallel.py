"""The port's mesh arithmetic, batch placement and batch sampling held to
the JAX package's, and the one-rank wrapped path (in process; the
multi-rank runs are in tests/test_torch_distributed.py).

- ``_mesh_args`` and ``mesh_shape`` (the shapes and the errors of JAX's
  ``make_mesh``) over a table that holds ``sdxl-tpu-v5e.yaml``'s (8, 2);
- ``shard_batch``'s split/replicate decision per leaf, and the rows each
  rank takes, against the shards JAX's ``shard_batch`` puts on the device at
  the same mesh coordinate;
- ``ShardedBatchSampler`` and ``shard_batches_for_host`` index for index;
- the launcher's environments, the CLI's refusals, and a ``strategy:
  fsdp`` fit at one rank against the unwrapped fit.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

MESH_ARGS = [
    {},
    {"devices": 1},
    {"devices": 8, "fsdp": 2},
    {"strategy": "auto"},
    {"strategy": "ddp", "devices": 4},
    {"strategy": "fsdp"},
    {"strategy": "fsdp", "devices": 4},
    {"strategy": "fsdp", "fsdp": 2},
    {"devices": "auto", "fsdp": 4},
    {"context_parallel": 2},
    {"strategy": "fsdp", "context_parallel": 2},
]


@pytest.mark.parametrize("trainer_cfg", MESH_ARGS)
def test_mesh_args_are_jax_s(trainer_cfg):
    from neurosis_tpu.trainer.cli import _mesh_args as jax_mesh_args
    from neurosis_tpu_torch.trainer.cli import _mesh_args

    assert len(jax.devices()) == 8
    assert _mesh_args(dict(trainer_cfg), 8) == jax_mesh_args(dict(trainer_cfg))


def test_sdxl_tpu_v5e_mesh_is_data4_fsdp2_at_8_ranks():
    from neurosis_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.parallel.mesh import mesh_shape
    from neurosis_tpu_torch.trainer.cli import _mesh_args

    trainer = load_config(ROOT / "configs/sdxl/sdxl-tpu-v5e.yaml")["trainer"]
    devices, fsdp, context = _mesh_args(trainer, 8)
    assert (devices, fsdp, context) == (8, 2, 1)
    assert mesh_shape(8, None, fsdp, context) == (4, 2) == tuple(jax_make_mesh(None, fsdp).devices.shape)


@pytest.mark.parametrize("n,data,fsdp,context", [
    (8, None, 1, 1), (8, None, 2, 1), (8, 4, 2, 1), (8, 2, 4, 1), (6, None, 2, 1), (4, 1, 4, 1),
    (8, None, 3, 1), (8, 3, 2, 1), (6, 4, 1, 1), (8, None, 2, 3)])
def test_mesh_shape_and_errors_are_jax_make_mesh_s(n, data, fsdp, context):
    from neurosis_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from neurosis_tpu_torch.parallel.mesh import mesh_shape

    try:
        want = tuple(jax_make_mesh(data, fsdp, context, devices=jax.devices()[:n]).devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError, match=f"^{e}$".replace("(", r"\(").replace(")", r"\)")):
            mesh_shape(n, data, fsdp, context)
        return
    assert mesh_shape(n, data, fsdp, context) == want


def test_a_context_axis_is_refused_naming_the_ring():
    """No longer refused: a context axis is the mesh's third, last as in
    JAX's ``make_mesh``, and the CLI's axes give JAX's mesh."""
    from neurosis_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from neurosis_tpu.trainer.cli import _mesh_args as jax_mesh_args
    from neurosis_tpu_torch.parallel.mesh import mesh_shape
    from neurosis_tpu_torch.trainer.cli import _mesh_args

    jax_mesh = jax_make_mesh(None, 2, 2, devices=jax.devices()[:8])
    assert mesh_shape(8, None, 2, 2) == (2, 2, 2) == tuple(jax_mesh.devices.shape)
    assert jax_mesh.axis_names == ("data", "fsdp", "context")
    cfg = {"strategy": "fsdp", "fsdp": 2, "context_parallel": 2}
    devices, fsdp, context = _mesh_args(dict(cfg), 8)
    assert (devices, fsdp, context) == jax_mesh_args(dict(cfg))
    assert mesh_shape(8, None, fsdp, context) == (2, 2, 2)


def _batch(rows: int, extra: dict = None) -> dict:
    rng = np.random.RandomState(rows)
    out = {"image": rng.randint(0, 255, size=(rows, 4, 4, 3)).astype(np.uint8),
           "caption_ids": rng.randint(0, 100, size=(rows, 7)).astype(np.int32),
           "uncond_ids": np.zeros((1, 7), np.int32)}
    out.update(extra or {})
    return out


@pytest.mark.parametrize("data,fsdp", [(1, 2), (2, 1), (2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("rows,extra", [(8, None), (4, None), (6, None), (1, None),
                                        (8, {"meta": np.arange(4, dtype=np.float32)}),
                                        (8, {"step": np.float32(3.0)})])
def test_shard_batch_splits_and_replicates_as_jax(data, fsdp, rows, extra):
    from jax.sharding import PartitionSpec as P

    from neurosis_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from neurosis_tpu.parallel.mesh import shard_batch as jax_shard_batch
    from neurosis_tpu_torch.parallel.mesh import row_split, shard_batch

    batch = _batch(rows, extra)
    mesh = jax_make_mesh(data, fsdp, devices=jax.devices()[:data * fsdp])
    placed = jax_shard_batch(mesh, batch)
    _, _, split = row_split(batch, data)
    assert split == {k: v.sharding.spec == P("data") for k, v in placed.items()}
    for d in range(data):
        got, held = shard_batch(batch, data, d)
        if not any(split.values()):
            assert held is None
        for f in range(fsdp):
            device = mesh.devices[d, f]
            for k, v in placed.items():
                want = [s.data for s in v.addressable_shards if s.device == device][0]
                np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=f"{k} at ({d}, {f})")
                if held is not None and split[k]:
                    np.testing.assert_array_equal(got[k], batch[k][held.start:held.stop])


def test_shard_batch_across_nodes_takes_the_node_s_share():
    """Node k's batch is rows [k·B, (k+1)·B) of the global batch; its ranks
    split it over the node's share of the data axis, as JAX's
    make_array_from_process_local_data lays it out."""
    from neurosis_tpu_torch.parallel.mesh import shard_batch

    batch = _batch(4)
    out, held = shard_batch(batch, data=4, data_index=3, nodes=2, node=1)
    assert (held.start, held.stop, held.total) == (6, 8, 8)
    np.testing.assert_array_equal(out["image"], batch["image"][2:4])
    np.testing.assert_array_equal(out["uncond_ids"], batch["uncond_ids"])
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(_batch(3), data=4, data_index=0, nodes=2, node=0)


@pytest.mark.parametrize("replicas", [1, 2, 3, 4])
@pytest.mark.parametrize("drop_last", [False, True])
def test_sharded_batch_sampler_is_jax_s(replicas, drop_last):
    from neurosis_tpu.data.sampler import ShardedBatchSampler as JaxSampler
    from neurosis_tpu_torch.data.sampler import ShardedBatchSampler

    for n in (1, 5, 8, 11):
        batches = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(n)]
        for rank in range(replicas):
            for shuffle in (False, True):
                for seed in (0, 7):
                    a = ShardedBatchSampler(batches, replicas, rank, shuffle, seed, drop_last)
                    b = JaxSampler(batches, replicas, rank, shuffle, seed, drop_last)
                    assert len(a) == len(b)
                    for epoch in (0, 1):
                        a.set_epoch(epoch)
                        b.set_epoch(epoch)
                        assert list(a) == list(b), (n, rank, shuffle, seed, epoch)
    with pytest.raises(ValueError, match="invalid rank"):
        ShardedBatchSampler([[0]], replicas, replicas)


def test_shard_batches_for_host_is_jax_s(monkeypatch):
    from neurosis_tpu.data.sampler import shard_batches_for_host as jax_for_host
    from neurosis_tpu_torch.data.sampler import shard_batches_for_host

    class Dataset:
        def get_batch_iterator(self):
            return iter([[i, i + 10] for i in range(7)])

    for replicas in (1, 2, 3):
        for rank in range(replicas):
            assert list(shard_batches_for_host(Dataset(), replicas, rank, seed=42)) == \
                list(jax_for_host(Dataset(), replicas, rank, seed=42))
    # from the environment: 4 ranks, 2 a node → rank 3 is node 1 of 2
    for k, v in {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2"}.items():
        monkeypatch.setenv(k, v)
    assert list(shard_batches_for_host(Dataset(), seed=1)) == list(jax_for_host(Dataset(), 2, 1, seed=1))


@pytest.mark.parametrize("env,want", [
    ({}, (0, 1, 0, 1, "none", 0, 1)),
    ({"RANK": "5", "WORLD_SIZE": "8", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "4", "MASTER_ADDR": "h0",
      "MASTER_PORT": "1234"}, (5, 8, 1, 4, "torchrun", 1, 2)),
    ({"SLURM_JOB_ID": "9", "SLURM_PROCID": "3", "SLURM_NTASKS": "4", "SLURM_LOCALID": "1",
      "SLURM_NTASKS_PER_NODE": "2(x2)", "SLURM_JOB_NODELIST": "gpu[07-08]"}, (3, 4, 1, 2, "slurm", 1, 2)),
    ({"NEUROSIS_COORDINATOR": "10.0.0.1:8476", "NEUROSIS_NUM_PROCESSES": "2", "NEUROSIS_PROCESS_ID": "1"},
     (1, 2, 0, 1, "neurosis", 1, 2)),
])
def test_dist_env_reads_torchrun_slurm_and_neurosis(env, want):
    from neurosis_tpu_torch.parallel.mesh import dist_env

    e = dist_env(env)
    assert (e.rank, e.world_size, e.local_rank, e.local_world_size, e.source, e.node, e.nodes) == want
    if e.source == "slurm":
        assert e.master_addr == "gpu07"
    if e.source == "neurosis":
        assert (e.master_addr, e.master_port) == ("10.0.0.1", 8476)


def test_row_draws_are_the_global_draw_s_rows():
    from neurosis_tpu_torch.parallel import rows

    want = torch.randn((6, 3), generator=torch.Generator().manual_seed(1))
    with rows.sliced(rows.Rows(2, 4, 6)):
        got = rows.draw(torch.randn, (2, 3), generator=torch.Generator().manual_seed(1))
        scalar = rows.draw(torch.rand, (), generator=torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="per-row draw"):
            rows.draw(torch.rand, (3, 3), generator=torch.Generator())
    assert torch.equal(got, want[2:4])
    assert torch.equal(scalar, torch.rand((), generator=torch.Generator().manual_seed(1)))
    assert rows.current() is None


def test_cli_refuses_a_mesh_the_world_cannot_hold():
    """sdxl-tpu-v5e.yaml asks for 8 devices: with no launcher the world is
    one process, and fit refuses before it builds anything."""
    from neurosis_tpu_torch.trainer.cli import main

    with pytest.raises(ValueError, match="asks for 8 devices and the world has 1"):
        main(["fit", "-c", str(ROOT / "configs/sdxl/sdxl-tpu-v5e.yaml"), "--device", "cpu"])


def test_launch_pod_turns_sigterm_into_a_dumped_exception():
    from neurosis_tpu_torch.tools.launch_pod import Terminated, _device, _terminate

    with pytest.raises(Terminated):
        _terminate(15, None)
    assert issubclass(Terminated, Exception)  # the loop's `except Exception` writes the crash dump
    assert _device(["fit", "-c", "x.yaml", "--device", "cpu"]) == "cpu" and _device(["fit"]) == "cuda"


@pytest.mark.parametrize("strategy", ["fsdp", "ddp"])
def test_one_rank_wrapped_fit_is_the_unwrapped_fit(tmp_path, monkeypatch, strategy):
    """What the card runs at one rank: ``strategy: fsdp|ddp`` wraps the
    model with FSDP2 over a 1 x 1 mesh (a gloo group of one here) and its
    two steps and checkpoint equal the unwrapped run's."""
    import torch.distributed as dist
    import torch_dist_worker as worker

    from neurosis_tpu_torch.data.png import write_png
    from neurosis_tpu_torch.trainer.cli import main

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(data / f"img_{i}.png", (rng.rand(40, 48, 3) * 255).astype(np.uint8))
        (data / f"img_{i}.txt").write_text(f"tag{i}, a test image")
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(data))
    monkeypatch.setenv("NEUROSIS_ALLOW_HASH_TOKENIZER", "1")
    main(["fit", "-c", str(worker.cli_config(tmp_path / "plain")), "--device", "cpu"])
    try:
        main(["fit", "-c", str(worker.cli_config(tmp_path / "wrapped", strategy=strategy)), "--device", "cpu"])
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    def read(root):
        lines = [json.loads(x) for x in (root / "logs" / "metrics.jsonl").read_text().splitlines()]
        return lines, torch.load(root / "checkpoints" / "2" / "state.pt", weights_only=True)

    (a, ca), (b, cb) = read(tmp_path / "plain"), read(tmp_path / "wrapped")
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2]
    for x, y in zip(a, b):
        np.testing.assert_allclose(y["loss"], x["loss"], rtol=1e-6)
        np.testing.assert_allclose(y["grad_norm"], x["grad_norm"], rtol=1e-5)
    for k, v in ca["params"].items():
        assert worker.err(cb["params"][k], v, worker.F32) <= 1.0, k


def test_chip_smoke_phase17_configs_and_pair_tables(monkeypatch):
    """Phase 17's copies: the sdxl-tpu-v5e copy changes its mesh keys (and
    what a run there needs) and nothing of its model; a G step and a D step
    of vae.example.yaml's encoder and decoder (256 px, batch 2, fp32) launch
    what pair_totals sums from the cli_vae and cli_vae_logger tables."""
    import chip_smoke as cs
    from torch_parity import recorded_launches

    from neurosis_tpu_torch.config.yaml_reader import safe_load
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.trainer.cli import _mesh_args

    texts = cs.phase17_configs(ROOT)
    configs = {name: safe_load(text, name) for name, text in texts.items()}
    v5e = safe_load((ROOT / "configs/sdxl/sdxl-tpu-v5e.yaml").read_text(), "sdxl-tpu-v5e")
    for name, (devices, strategy, fsdp) in {"sdxl-fsdp": (1, "fsdp", 1), "sdxl-one": (1, None, 1),
                                            "sdxl-two-data": (2, "fsdp", 1), "sdxl-two-fsdp": (2, "fsdp", 2)}.items():
        trainer, model = configs[name]["trainer"], configs[name]["model"]["init_args"]
        assert (trainer["devices"], trainer.get("strategy"), trainer["fsdp"]) == (devices, strategy, fsdp)
        assert _mesh_args(trainer, devices)[:2] == (devices, fsdp)
        assert "ckpt_path" not in model and "ckpt_path" not in model["first_stage_model"]["init_args"]
        want = dict(v5e["model"]["init_args"])
        want.pop("ckpt_path")
        want["first_stage_model"] = dict(want["first_stage_model"], init_args={
            k: v for k, v in want["first_stage_model"]["init_args"].items() if k != "ckpt_path"})
        assert model == want and configs[name]["data"]["init_args"]["batch_size"] == 2
    assert configs["vae-ddp-resume"]["trainer"]["strategy"] == "ddp" and "strategy" not in configs["vae-one"]["trainer"]
    assert configs["sdxl-one-resume"]["data"]["init_args"]["num_workers"] == 0
    assert configs["vae-one"]["model"]["init_args"]["loss"]["init_args"]["disc_start"] == 1

    calls = recorded_launches(monkeypatch)
    dd = {k: v for k, v in configs["vae-one"]["model"]["init_args"]["ddconfig"].items()
          if k not in ("in_channels", "out_ch")}
    meta = dict(device="meta", generator=torch.Generator())
    enc, dec = Encoder(**dd, **meta), Decoder(**{k: v for k, v in dd.items() if k != "double_z"}, out_ch=3, **meta)
    x = torch.empty(2, 256, 256, 3, device="meta")
    dec(enc(x)[..., :4]).float().sum().backward()  # the G step
    with torch.no_grad():
        dec(enc(x)[..., :4])  # the D step's reconstruction
    fwd = sum(n for (entry, _), n in calls.items() if entry == "flash_fwd_f32")
    bwd = sum(n for (entry, _), n in calls.items() if entry == "flash_bwd_f32")
    assert set(entry for entry, _ in calls) == {"flash_fwd_f32", "flash_bwd_f32"}
    rows = {name: [] for name in cs.KERNELS}
    for path, sh, n, dt in cs.flash_tables(torch):
        if path in ("cli_vae", "cli_vae_logger") and dt == torch.float32:
            rows["flash_fwd_f32"].append(dict(path=path, per_step=n[0], ms=1.0, bound_ms=1.0))
            rows["flash_bwd_f32"].append(dict(path=path, per_step=n[1], ms=1.0, bound_ms=1.0))
    totals = cs.pair_totals(rows, "cli_vae", "cli_vae_logger")
    assert (totals["flash_fwd_f32"]["launches"], totals["flash_bwd_f32"]["launches"]) == (fwd, bwd) == (4, 2)
