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

Config nodes the port cannot honour yet raise ``NotImplementedError`` naming
their ROADMAP Queue 1 item, never pass in silence: ``model_checkpoint:``
(12), ``trainer.profiler:`` (11), more than one device, ``strategy: fsdp``
or ``context_parallel`` (10). ``data.num_workers`` prefetch is item 13:
batches load in this process.
"""

from __future__ import annotations

import argparse
import json
import logging
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


def _refuse_unported(cfg: dict, trainer_cfg: dict) -> None:
    """Raise on every node the port cannot honour yet (see the module doc)."""
    for node, item, what in (
        (cfg.get("model_checkpoint"), 12, "model_checkpoint: (the port's checkpoint saving and resume)"),
        (trainer_cfg.get("profiler"), 11, "trainer.profiler: (NeurosisProfiler on torch.profiler)"),
    ):
        if node:
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 item {item}")
    devices = trainer_cfg.get("devices")
    strategy = str(trainer_cfg.get("strategy", "") or "")
    fsdp = int(trainer_cfg.get("fsdp", 0) or 0)
    context = int(trainer_cfg.get("context_parallel", 1) or 1)
    if devices not in (None, "auto", 1, "1") or strategy == "fsdp" or fsdp > 1 or context > 1:
        raise NotImplementedError(f"devices={devices!r}, strategy={strategy!r}, fsdp={fsdp}, "
                                  f"context_parallel={context}: the port trains on one card; more is ROADMAP "
                                  "Queue 1 item 10")


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


def _callbacks(trainer_cfg: dict) -> list:
    """trainer.callbacks (Lightning class paths → the port's callbacks;
    unknown or unported entries warn and are skipped, so reference configs
    run unmodified)."""
    from ..config.registry import resolve_class_path
    from .callbacks import DeviceStatsCallback, ModelSummaryCallback

    callbacks = []
    for node in trainer_cfg.get("callbacks") or []:
        cp = (node.get("class_path") or "") if isinstance(node, dict) else str(node)
        ia = (node.get("init_args") or {}) if isinstance(node, dict) else {}
        if cp.endswith("DeviceStatsMonitor"):
            callbacks.append(DeviceStatsCallback(every_n_train_steps=ia.get("every_n_train_steps", 100)))
        elif cp.endswith("ModelSummary"):
            callbacks.append(ModelSummaryCallback(max_depth=ia.get("max_depth", 2)))
        elif cp.endswith("LearningRateMonitor"):
            pass  # no LR schedule is ported; the LR is the optimizer's own
        else:
            try:
                callbacks.append(resolve_class_path(cp)(**ia))
            except Exception:
                logger.warning(f"skipping unsupported trainer callback {cp!r}")
    return callbacks


def _build(args):
    """Shared setup: config → (cfg, engine, dataset, trainer)."""
    import torch

    from .._device import resolve_device
    from ..config.loader import instantiate, load_config
    from .builder import build_engine
    from .loop import Trainer

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    trainer_cfg = cfg.get("trainer", {}) or {}
    _refuse_unported(cfg, trainer_cfg)
    seed = cfg.get("seed_everything", 42)

    engine = build_engine(cfg["model"], precision=trainer_cfg.get("precision"), device=device,
                          generator=torch.Generator(device).manual_seed(seed))
    dataset = instantiate(cfg["data"]) if "data" in cfg else None
    workers = ((cfg.get("data") or {}).get("init_args") or {}).get("num_workers")
    if workers:
        logger.info(f"data.num_workers={workers}: batches load in this process (prefetch is ROADMAP Queue 1 "
                    "item 13)")

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
        callbacks=_callbacks(trainer_cfg) + ([_image_logger(cfg["image_logger"])] if cfg.get("image_logger")
                                             else []),
        wandb_config=_wandb_config(trainer_cfg),
        allow_random_weights=trainer_cfg.get("allow_random_weights", False),
    )
    return cfg, engine, dataset, trainer


def _batch_factory(dataset):
    """Dataset → per-epoch batch iterable, loaded in this process."""

    def batches():
        for idx_batch in dataset.get_batch_iterator():
            yield dataset.get_batch(idx_batch)

    return batches


def run_fit(args) -> int:
    cfg, engine, dataset, trainer = _build(args)
    if dataset is None:
        raise ValueError("fit requires a `data:` node in the config")
    state = trainer.fit(_batch_factory(dataset))
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
    metrics = trainer.validate(_batch_factory(dataset), max_batches=args.max_batches)
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
