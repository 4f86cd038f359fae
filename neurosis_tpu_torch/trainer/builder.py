"""Assemble engines from reference-shaped YAML config nodes (port of
neurosis_tpu/trainer/builder.py).

The reference DiffusionEngine and AutoencodingEngine init_args become the
port's engines by an explicit walk of the node tree against
``config.registry``. The precision is read before anything is built, since
the port's modules take their compute dtype at construction: every 16-bit
``trainer.precision`` gives a bf16 UNet (or bf16 VAE encoder and decoder);
the towers and the frozen first stage stay fp32; without the key everything
is fp32. Modules are built on ``device`` from one seeded ``generator``, in
the config's order.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import torch

from ..config.loader import _adapt_kwargs, _parameters, instantiate
from ..config.registry import resolve_class_path
from ..models.autoencoder import AutoencoderKL
from ..modules.encoders.embedding import GeneralConditioner
from ..schedulers import attach_schedule
from .engine import DiffusionEngine

logger = logging.getLogger(__name__)

_BF16_PRECISIONS = {"bf16", "bf16-mixed", "bf16-true", "16", "16-mixed", "16-true", 16}
_DIFFUSION = ("neurosis.models.DiffusionEngine", "neurosis.models.diffusion.DiffusionEngine")
_VAE = ("neurosis.models.autoencoder.AutoencodingEngine", "neurosis.models.autoencoder.AutoencodingEngineLegacy",
        "neurosis.models.autoencoder.AutoencoderKL", "neurosis.models.autoencoder.AutoencoderKLInferenceWrapper",
        "neurosis.models.autoencoder.DiffusersAutoencodingEngine")

OptimizerFactory = Callable[[list], torch.optim.Optimizer]


def compute_dtype(precision) -> Optional[torch.dtype]:
    """trainer.precision → the trainable backbone's compute dtype (JAX
    ``apply_precision``: every 16-bit precision is bf16; fp16 is never used)."""
    return torch.bfloat16 if precision in _BF16_PRECISIONS else None


def set_matmul_precision() -> None:
    """The port's one switch for TF32 in the library's fp32 convs and matmuls:
    off, so they compute in full fp32 as the plain versions and the card's
    fp32 gates do, until ROADMAP Queue 1 item 4 measures whether training
    keeps its tolerances with it on (torch's own default turns cuDNN's on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build_engine(model_node: dict, precision=None, device=None, generator: Optional[torch.Generator] = None):
    """`model:` YAML node → engine, dispatched by its exact class_path."""
    set_matmul_precision()
    cls_path = model_node.get("class_path", "")
    if cls_path in _DIFFUSION:
        build = build_diffusion_engine
    elif cls_path in _VAE:
        build = build_autoencoding_engine
    else:
        raise NotImplementedError(f"unsupported model class_path {cls_path!r}; known: {sorted(_DIFFUSION + _VAE)}")
    return build(model_node, compute_dtype(precision), device, generator)


def _numbers(kwargs: dict) -> dict:
    """Numeric strings as floats: YAML 1.1 reads ``3e-5`` (no dot) as a
    string, which the reference's CLI casts by the class's float annotation
    (the JAX package passes it on, and its schedule then fails)."""
    def number(v):
        try:
            return float(v) if isinstance(v, str) else v
        except ValueError:
            return v

    return {k: number(v) for k, v in kwargs.items()}


def build_optimizer(node: Optional[dict], scheduler_node: Optional[dict] = None) -> OptimizerFactory:
    """optimizer (and scheduler) nodes → ``params → torch.optim.Optimizer``.
    ``lr`` and ``learning_rate`` are renamed to the one the class takes. The
    JAX-only ``stacked:`` key (optax updates batched by shape group, the same
    math) has nothing to change in a per-parameter torch optimizer, so it is
    not read. ``params`` may be param groups: a group's ``lr_scale`` (a
    trainable embedder's own base_lr over the engine's) multiplies its lr, as
    JAX's ``optax.scale`` after the optimizer does. A scheduler other than
    ``AdafactorScheduler`` (which composes nothing) sets each group's lr to
    its base × ``sched(count)`` (``schedulers.attach_schedule``)."""
    if node is None:
        node = {"class_path": "optax.adamw", "init_args": {"learning_rate": 1e-4}}
    cls = resolve_class_path(node["class_path"])
    kwargs = dict(node.get("init_args") or {})
    takes = _parameters(cls) or set()
    for given, wanted in (("lr", "learning_rate"), ("learning_rate", "lr")):
        if given in kwargs and given not in takes and wanted in takes:
            kwargs[wanted] = kwargs.pop(given)
    kwargs = _adapt_kwargs(cls, _numbers(kwargs), node["class_path"])
    sched = None
    if scheduler_node is not None and "AdafactorScheduler" not in scheduler_node.get("class_path", ""):
        sched = instantiate(dict(scheduler_node, init_args=_numbers(scheduler_node.get("init_args") or {})))

    def factory(params) -> torch.optim.Optimizer:
        opt = cls(params, **kwargs)
        for group in opt.param_groups:
            if group.get("lr") is not None and "lr_scale" in group:
                group["lr"] = group["lr"] * group["lr_scale"]
        return attach_schedule(opt, sched) if sched is not None else opt

    return factory


def build_conditioner(node: dict, context: dict) -> tuple[GeneralConditioner, list[int]]:
    """GeneralConditioner node → module + trainable embedder indices."""
    emb_nodes = (node.get("init_args") or {}).get("emb_models", [])
    embedders, trainable = [], []
    for i, en in enumerate(emb_nodes):
        embedders.append(instantiate(en, context))
        if (en.get("init_args") or {}).get("is_trainable"):
            trainable.append(i)
    return GeneralConditioner(embedders), trainable


def build_first_stage(node: Optional[dict], context: dict) -> Optional[AutoencoderKL]:
    """The frozen fp32 AutoencoderKL, or None for ``IdentityFirstStage``
    (the engine then runs in pixel space). Its own ``ckpt_path`` is not read
    (nor by the JAX package): the engine's checkpoint fills
    ``first_stage_model.*``."""
    if node is None:
        return None
    resolve_class_path(node.get("class_path") or "")  # a path the port does not know raises
    if "IdentityFirstStage" in (node.get("class_path") or ""):
        return None
    args = node.get("init_args") or {}
    ddconfig = args.get("ddconfig")
    if ddconfig is None:
        logger.warning("first_stage_model without ddconfig — skipping")
        return None
    if args.get("ckpt_path"):
        logger.warning(f"first_stage_model.ckpt_path {args['ckpt_path']!r} is not read: the engine's ckpt_path "
                       "fills first_stage_model.*")
    return AutoencoderKL(ddconfig=dict(ddconfig), embed_dim=args.get("embed_dim", 4), **context)


def build_autoencoding_engine(model_node: dict, dtype=None, device=None, generator=None):
    """The reference AutoencodingEngine/AutoencoderKL `model:` node → VAE-GAN
    trainer (models/autoencoder.py:134-505 config surface). The engine's
    ``freeze_encoder``, ``freeze_decoder``, ``ema_decay``,
    ``adaptive_disc_weight`` and ``diff_boost_factor`` are read from the
    node (JAX's builder drops them and trains with its engine's defaults).
    ``ckpt_path`` is refused: the JAX package's sgm loader reads diffusion
    engines only."""
    from ..losses.vae_loss import AutoencoderPerceptual
    from ..models.vae import Decoder, Encoder
    from ..optimizers.adamw import adam
    from .vae_engine import AutoencodingEngine

    args = dict(model_node.get("init_args") or {})
    if args.get("ckpt_path"):
        raise NotImplementedError("ckpt_path: loading a VAE checkpoint into the VAE trainer is not ported (nor "
                                  "read by the JAX package's sgm loader): ROADMAP Queue 1 item 9")
    context = {"device": device, "generator": generator}
    dd = dict(args.get("ddconfig") or {})
    double_z = dd.pop("double_z", True)
    common = dict(
        ch=dd.get("ch", 128),
        ch_mult=dd.get("ch_mult", [1, 2, 4, 4]),
        num_res_blocks=dd.get("num_res_blocks", 2),
        attn_resolutions=dd.get("attn_resolutions", []),
        resolution=dd.get("resolution", 256),
        z_channels=dd.get("z_channels", 4),
        dropout=dd.get("dropout", 0.0),
        attn_type=dd.pop("attn_type", "vanilla"),
        dtype=dtype,
        **context,
    )
    encoder = Encoder(in_channels=dd.get("in_channels", 3), double_z=double_z, **common)
    decoder = Decoder(out_ch=dd.get("out_ch", 3), **common)
    loss = instantiate(args["loss"], context) if isinstance(args.get("loss"), dict) \
        else AutoencoderPerceptual(**context)
    regularizer = instantiate(args["regularizer_config"], context) \
        if isinstance(args.get("regularizer_config"), dict) else None
    g_opt = build_optimizer(args.get("optimizer"), args.get("scheduler"))  # JAX: the scheduler is G's
    d_opt = build_optimizer(args["disc_optimizer"]) if args.get("disc_optimizer") \
        else (lambda params: adam(params, 1e-4))  # optax.adam(1e-4), the JAX default
    disc_start = getattr(loss, "disc_start", -1)
    return AutoencodingEngine(
        encoder=encoder,
        decoder=decoder,
        loss=loss,
        regularizer=regularizer,
        g_optimizer=g_opt,
        d_optimizer=d_opt,
        kl_weight=float(args.get("kl_weight", 0.0)),
        input_key=args.get("input_key", "image"),
        disc_start=disc_start if isinstance(disc_start, int) else -1,
        use_ema=bool(args.get("use_ema", False)),
        ema_decay=float(args.get("ema_decay", 0.9999)),
        freeze_encoder=bool(args.get("freeze_encoder", False)),
        freeze_decoder=bool(args.get("freeze_decoder", False)),
        adaptive_disc_weight=bool(args.get("adaptive_disc_weight", False)),
        diff_boost_factor=float(args.get("diff_boost_factor", 3.0)),
        device=device,
    )


def build_diffusion_engine(model_node: dict, dtype=None, device=None, generator=None) -> DiffusionEngine:
    """The reference `model:` YAML node → DiffusionEngine, with its
    ``forward_hooks`` as ``engine.loss_hooks`` (the loop calls them)."""
    args = dict(model_node.get("init_args") or {})
    context = {"device": device, "generator": generator}

    unet = instantiate(args["model"], context, dtype=dtype)
    denoiser = instantiate(args["denoiser"], context)
    loss_fn = instantiate(args["loss_fn"], context) if "loss_fn" in args else None
    sampler = instantiate(args["sampler"], context) if "sampler" in args else None
    conditioner, trainable_idx = build_conditioner(args["conditioner"], context)
    first_stage = build_first_stage(args.get("first_stage_model"), context)
    optimizer = build_optimizer(args.get("optimizer"), args.get("scheduler"))

    # per-module LR param groups (models/diffusion.py:261-296): the UNet trains
    # at base_lr; each trainable embedder with its own base_lr is a param group
    # at base_lr_i / base_lr of the optimizer's lr (JAX: optax.scale of the update)
    emb_nodes = (args["conditioner"].get("init_args") or {}).get("emb_models", [])
    base_lr = args.get("base_lr")
    lr_scales = {}
    for i in trainable_idx if base_lr else []:
        emb_lr = (emb_nodes[i].get("init_args") or {}).get("base_lr")
        if emb_lr is not None:
            lr_scales[i] = float(emb_lr) / float(base_lr)

    engine = DiffusionEngine(
        model=unet,
        denoiser=denoiser,
        loss_fn=loss_fn,
        conditioner=conditioner,
        first_stage=first_stage,
        optimizer=optimizer,
        sampler=sampler,
        scale_factor=args.get("scale_factor", 0.18215),
        input_key=args.get("input_key", "image"),
        use_ema=bool(args.get("use_ema", False)),
        trainable_embedders=tuple(trainable_idx),
        lr_scales=lr_scales,
        device=device,
        identity_first_stage="IdentityFirstStage" in ((args.get("first_stage_model") or {}).get("class_path") or ""),
        log_sigmas=bool(args.get("log_sigmas", False)),
    )
    engine.ckpt_path = args.get("ckpt_path")
    engine.loss_hooks = [instantiate(h, context) for h in args.get("forward_hooks", []) or []]
    return engine
