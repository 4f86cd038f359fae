"""CLI entry point (port of neurosis_tpu/trainer/cli.py; parity:
trainer/cli.py:50-149, the LightningCLI surface).

    python -m neurosis_tpu_torch {fit,validate,test} -c config.yaml [--device cpu]
    python -m neurosis_tpu_torch predict -c config.yaml [--prompt P ...] [--steps N] [--out DIR]
        [--size PX] [--device cpu]

consumes the reference YAML shape: trainer args, model (engine node), data
(dataset node), the top-level image_logger node, trainer.logger (wandb
pass-through), trainer.callbacks. ``--device`` (default ``cuda``) is the
port's counterpart of ``JAX_PLATFORMS=cpu``: without it and without CUDA the
CLI raises. ``predict`` samples the prompts with the model's ``sampler:``
into ``--out`` (default ``<root>/predictions``).

The ``model_checkpoint:`` node saves the run's state every
``every_n_train_steps`` (keeping ``save_top_k``) under ``dirpath`` or
``<root>/checkpoints``, and a run started in the same root resumes from its
latest step. A remote ``dirpath`` (``gs://``, ``s3://``, ``memory://``, ...,
with the node's ``storage_options``) is a blob store, and the run resumes
from it, as from ``trainer.remote_checkpoint_url`` (cli.py:180-213). A
``SaveConfigCallback`` in ``trainer.callbacks`` that gives no ``config``
writes the run's resolved config. ``data.init_args.num_workers`` (default
2) batches load ahead in spawned worker processes (``prefetch_mode`` or
``NEUROSIS_PREFETCH``: ``process`` or ``thread``; 0 loads them in this
process).

``fit``, ``validate`` and ``test`` train on a (data, fsdp[, context]) mesh
of one process a card (``tools/launch_pod.py`` under ``torchrun``, SLURM or
the ``NEUROSIS_*`` environment): ``trainer.devices``, ``strategy``, ``fsdp``
and ``context_parallel`` give its shape as JAX's ``_mesh_args`` does
(cli.py:78-95), the world must hold exactly the devices asked for, and
``strategy: ddp|fsdp`` wraps the model even on one card.
``context_parallel: N`` > 1 adds the context axis: the UNet's self-attention
rides a ring of N ranks (``ops/ring_attention.py``). ``predict`` runs on one.

``trainer.profiler:`` adds a ``NeurosisProfiler`` (``trainer/profile.py``,
torch.profiler) callback, as JAX's cli.py:142-160 builds it: ``dirpath``, the
five ``schedule`` keys, ``record_module_names`` and ``capture_depth``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from pathlib import Path

logger = logging.getLogger(__name__)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    parser = argparse.ArgumentParser(prog="neurosis_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    fit = sub.add_parser("fit", help="train from a YAML config")
    val = sub.add_parser("validate", help="run loss-only evaluation from a YAML config")
    tst = sub.add_parser("test", help="run loss-only evaluation on the test split (`data_test:` node, else `data:`)")
    pred = sub.add_parser("predict", help="sample images from prompts with a trained model")
    for p in (fit, val, tst, pred):
        p.add_argument("-c", "--config", required=True, type=Path)
        p.add_argument("--device", default="cuda", help="the device to run on (default cuda; cpu for tests)")
    fit.add_argument("--max-steps", type=int, default=None)
    fit.add_argument("--fast-dev-run", action="store_true", default=None)
    val.add_argument("--max-batches", type=int, default=None)
    tst.add_argument("--max-batches", type=int, default=None)
    pred.add_argument("--prompt", action="append", default=None, help="repeatable prompt(s)")
    pred.add_argument("--steps", type=int, default=None, help="sampler steps override")
    pred.add_argument("--out", type=Path, default=None, help="output directory (default <root>/predictions)")
    pred.add_argument("--size", type=int, default=1024, help="image size (pixels, square)")
    args = parser.parse_args(argv)

    if args.command == "fit":
        return run_fit(args)
    if args.command == "validate":
        return run_eval(args, "val")
    if args.command == "test":
        return run_eval(args, "test")
    return run_predict(args)


def _wandb_config(trainer_cfg: dict):
    """trainer.logger list → wandb init kwargs (WandbLogger pass-through)."""
    loggers = trainer_cfg.get("logger") or []
    if isinstance(loggers, dict):
        loggers = [loggers]
    for node in loggers:
        cls_path = str(node.get("class_path", ""))
        if cls_path.rsplit(".", 1)[-1] == "WandbLogger":
            ia = dict(node.get("init_args") or {})
            cfg = {k: v for k, v in ia.items() if k in ("project", "name", "tags", "entity", "group", "mode")}
            if ia.get("save_dir"):
                cfg["dir"] = ia["save_dir"]
            return cfg
    return None


def _mesh_args(trainer_cfg: dict, world_size: int):
    """Lightning trainer.devices/strategy → (devices, fsdp, context) mesh
    axes, as JAX's (cli.py:78-95) with the world's ranks for its devices:
    ``strategy: auto|ddp`` = data-parallel over all devices; ``strategy:
    fsdp`` also shards parameters and optimizer state (the fsdp axis = all
    devices unless ``fsdp:`` gives its size); ``context_parallel: N`` is a
    ring-attention axis."""
    devices = trainer_cfg.get("devices")
    strategy = str(trainer_cfg.get("strategy", "") or "")
    fsdp = int(trainer_cfg.get("fsdp", 0) or 0)
    context = int(trainer_cfg.get("context_parallel", 1) or 1)
    if (strategy in ("auto", "ddp", "fsdp") or context > 1) and devices is None:
        devices = "auto"
    if strategy == "fsdp" and fsdp == 0:
        n = world_size if devices in ("auto", -1, None) else int(devices)
        fsdp = max(n // context, 1)
    return devices, max(fsdp, 1), context


def _mesh(trainer_cfg: dict, device: str):
    """The run's mesh, None for the one-card path (one process, no
    ``strategy: ddp|fsdp``). The world must hold the devices the config
    asks for: it never trains on fewer."""
    from ..parallel.mesh import dist_env, init_distributed, make_mesh, mesh_shape

    env = dist_env()
    devices, fsdp, context = _mesh_args(trainer_cfg, env.world_size)
    asked = env.world_size if devices in (None, "auto", -1, "-1") else int(devices)
    if asked != env.world_size:
        raise ValueError(f"trainer.devices asks for {asked} devices and the world has {env.world_size} "
                         f"(WORLD_SIZE={env.world_size}): launch {asked} processes, one a card (torchrun "
                         f"--nproc-per-node {asked} -m neurosis_tpu_torch.tools.launch_pod ...), or set devices")
    strategy = str(trainer_cfg.get("strategy", "") or "")
    if env.world_size == 1 and strategy not in ("ddp", "fsdp") and fsdp == 1 and context == 1:
        return None
    mesh_shape(env.world_size, None, fsdp, context)  # a world the axes do not divide raises before the group starts
    return make_mesh(init_distributed(device, env), None, fsdp, context)


def _image_logger(node: dict):
    """The top-level ``image_logger:`` node → ImageLogger (cli.py:160-179)."""
    from .callbacks import ImageLogger

    il = dict(node)
    return ImageLogger(
        every_n_train_steps=il.get("every_n_train_steps", 100),
        max_images=il.get("max_images", 4),
        num_steps=(il.get("log_func_kwargs") or {}).get("num_steps"),
        log_before_start=il.get("log_before_start", False),
        log_first_step=il.get("log_first_step", False),
        log_step_type=il.get("log_step_type", "global_step"),
        batch_size=il.get("batch_size", 1),
        accumulate_grad_batches=il.get("accumulate_grad_batches", 1),
        clamp=il.get("clamp", True),
        rescale=il.get("rescale", True),
        extra_log_keys=il.get("extra_log_keys") or (),
        wandb_log_table=il.get("wandb_log_table", False),
    )


def _callbacks(cfg: dict) -> list:
    """trainer.callbacks (Lightning class paths → the port's callbacks;
    unknown or unported entries warn and are skipped, so reference configs
    run unmodified); a SaveConfigCallback without a ``config`` gets ``cfg``."""
    from ..config.registry import resolve_class_path
    from .callbacks import DeviceStatsCallback, ModelSummaryCallback, SaveConfigCallback

    trainer_cfg = cfg.get("trainer", {}) or {}
    callbacks = []
    for node in trainer_cfg.get("callbacks") or []:
        cp = (node.get("class_path") or "") if isinstance(node, dict) else str(node)
        ia = (node.get("init_args") or {}) if isinstance(node, dict) else {}
        if cp.endswith("DeviceStatsMonitor"):
            callbacks.append(DeviceStatsCallback(every_n_train_steps=ia.get("every_n_train_steps", 100)))
        elif cp.endswith("ModelSummary"):
            callbacks.append(ModelSummaryCallback(max_depth=ia.get("max_depth", 2)))
        elif cp.endswith("LearningRateMonitor"):
            pass  # the schedule's lr is each param group's "lr", in the optimizer's state
        else:
            try:
                cls = resolve_class_path(cp)
                if cls is SaveConfigCallback and ia.get("config") is None:
                    ia = dict(ia, config=cfg)
                callbacks.append(cls(**ia))
            except Exception:
                logger.warning(f"skipping unsupported trainer callback {cp!r}")
    if trainer_cfg.get("profiler"):
        callbacks.append(_profiler(trainer_cfg["profiler"]))
    return callbacks


def _profiler(node):
    """``trainer.profiler:`` (the reference's NeurosisProfiler) → the port's
    step-windowed torch.profiler callback with module-name spans."""
    from .profile import NeurosisProfiler, ProfilerSchedule

    ia = (node.get("init_args") or {}) if isinstance(node, dict) else {}
    sched = ia.get("schedule") or {}
    known = {k: sched[k] for k in ("skip_first", "wait", "warmup", "active", "repeat") if k in sched}
    return NeurosisProfiler(dirpath=ia.get("dirpath", "./profiles"),
                            schedule=ProfilerSchedule(**known) if known else None,
                            record_module_names=ia.get("record_module_names", True),
                            capture_depth=ia.get("capture_depth", -1))


def _build(args):
    """Shared setup: config → (cfg, engine, dataset, trainer)."""
    import torch

    from .._device import resolve_device
    from ..checkpoint.blob import is_remote_url
    from ..config.loader import instantiate, load_config
    from .builder import build_engine
    from .loop import Trainer

    cfg = load_config(args.config)
    trainer_cfg = cfg.get("trainer", {}) or {}
    predict = getattr(args, "command", None) == "predict"
    mesh = None if predict else _mesh(trainer_cfg, args.device)
    if predict:
        from ..parallel.mesh import dist_env

        if dist_env().world_size > 1:
            raise ValueError("predict runs in one process on one card")
    device = mesh.dist.device if mesh is not None else resolve_device(args.device)
    seed = cfg.get("seed_everything", 42)

    engine = build_engine(cfg["model"], precision=trainer_cfg.get("precision"), device=device,
                          generator=torch.Generator(device).manual_seed(seed))
    dataset = instantiate(cfg["data"]) if "data" in cfg else None
    callbacks = _callbacks(cfg)
    if cfg.get("image_logger"):
        callbacks.append(_image_logger(cfg["image_logger"]))
    mc = dict(cfg.get("model_checkpoint") or {})
    if cfg.get("model_checkpoint"):
        from .callbacks import CheckpointCallback

        callbacks.append(CheckpointCallback(dirpath=mc.get("dirpath"),
                                            every_n_train_steps=mc.get("every_n_train_steps", 1000),
                                            keep=mc.get("save_top_k", mc.get("keep", 3)) or 3,
                                            storage_options=mc.get("storage_options")))
    remote = trainer_cfg.get("remote_checkpoint_url") or (mc.get("dirpath") if is_remote_url(mc.get("dirpath"))
                                                           else None)

    fast_dev = trainer_cfg.get("fast_dev_run", False)
    if getattr(args, "fast_dev_run", None) is not None:
        fast_dev = args.fast_dev_run
    max_steps = getattr(args, "max_steps", None) or trainer_cfg.get("max_steps", 1000)

    trainer = Trainer(
        engine,
        max_steps=max_steps,
        max_epochs=trainer_cfg.get("max_epochs"),
        log_every_n_steps=trainer_cfg.get("log_every_n_steps", 1),
        default_root_dir=trainer_cfg.get("default_root_dir", "./projects"),
        seed=seed,
        fast_dev_run=bool(fast_dev),
        callbacks=callbacks,
        wandb_config=_wandb_config(trainer_cfg),
        allow_random_weights=trainer_cfg.get("allow_random_weights", False),
        mesh=mesh,
        remote_checkpoint_url=remote,
        storage_options=mc.get("storage_options"),
        wandb_watch_steps=trainer_cfg.get("wandb_watch_steps", 0),
    )
    return cfg, engine, dataset, trainer


def _batch_factory(cfg: dict, dataset, mesh=None):
    """Dataset → per-epoch batch iterable (cli.py:220-252): index batches
    from ``get_batch_iterator()`` (this node's, rank-strided, when the mesh
    spans nodes: ``shard_batches_for_host``), loaded by
    ``data.init_args.num_workers`` (default 2) prefetch workers, or in this
    process for 0. Every rank of a node loads the node's whole batches."""
    from ..data.prefetch import get_batch, make_prefetcher, seeded_batches

    init_args = (cfg.get("data") or {}).get("init_args") or {}
    num_workers = int(init_args.get("num_workers", 2) or 0)
    mode = os.environ.get("NEUROSIS_PREFETCH") or init_args.get("prefetch_mode", "process")

    def index_batches():
        if mesh is not None and mesh.dist.env.nodes > 1:
            from ..data.sampler import shard_batches_for_host

            return iter(shard_batches_for_host(dataset, mesh.dist.env.nodes, mesh.dist.env.node,
                                               seed=cfg.get("seed_everything", 42)))
        return dataset.get_batch_iterator()

    def batches():
        if num_workers > 0:
            yield from make_prefetcher(mode)(dataset, index_batches(), num_workers=num_workers)
        else:
            for indices, seed in seeded_batches(dataset, index_batches()):
                yield get_batch(dataset, indices, seed)

    return batches


def run_fit(args) -> int:
    cfg, engine, dataset, trainer = _build(args)
    if dataset is None:
        raise ValueError("fit requires a `data:` node in the config")
    state = trainer.fit(_batch_factory(cfg, dataset, trainer.mesh))
    logger.info(f"fit complete at step {int(state.step)}")
    return 0


def run_eval(args, split: str) -> int:
    """``validate`` (split 'val', the `data:` node) or ``test`` (split
    'test': the `data_test:` node when present, else `data:`): loss-only
    evaluation, the means printed as one JSON line."""
    from ..config.loader import instantiate

    cfg, engine, dataset, trainer = _build(args)
    if split == "test" and cfg.get("data_test"):
        dataset = instantiate(cfg["data_test"])
    if dataset is None:
        raise ValueError(f"{'validate' if split == 'val' else 'test'} requires a `data:` node in the config")
    metrics = trainer.validate(_batch_factory(cfg, dataset, trainer.mesh), max_batches=args.max_batches)
    logger.info(f"{split}: " + ", ".join(f"{k}={v:.5f}" for k, v in metrics.items()))
    print(json.dumps({f"{split}/{k}": v for k, v in metrics.items()}))
    return 0


def run_predict(args) -> int:
    """Sample ``--prompt``s (repeatable) into ``--out``: ``sample_###.png``
    and ``grid.png`` (cli.py:295-306)."""
    cfg, engine, dataset, trainer = _build(args)
    if engine.sampler is None:
        raise ValueError("predict requires a `sampler:` in the model config")
    prompts = args.prompt or ["a photograph of an astronaut riding a horse"]
    out_dir = args.out or (trainer.root_dir / "predictions")
    for p in trainer.predict(prompts, out_dir=out_dir, size=args.size, num_steps=args.steps):
        logger.info(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
