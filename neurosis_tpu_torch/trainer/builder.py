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


def build_optimizer(node: Optional[dict], scheduler_node: Optional[dict] = None) -> OptimizerFactory:
    """optimizer node → ``params → torch.optim.Optimizer``. ``lr`` and
    ``learning_rate`` are renamed to the one the class takes. The JAX-only
    ``stacked:`` key (optax updates batched by shape group, the same math)
    has nothing to change in a per-parameter torch optimizer, so it is not
    read."""
    if scheduler_node is not None:
        raise NotImplementedError(f"scheduler {scheduler_node.get('class_path')!r}: LR schedules are not ported "
                                  "yet: ROADMAP Queue 1 item 8")
    if node is None:
        node = {"class_path": "optax.adamw", "init_args": {"learning_rate": 1e-4}}
    cls = resolve_class_path(node["class_path"])
    kwargs = dict(node.get("init_args") or {})
    takes = _parameters(cls) or set()
    for given, wanted in (("lr", "learning_rate"), ("learning_rate", "lr")):
        if given in kwargs and given not in takes and wanted in takes:
            kwargs[wanted] = kwargs.pop(given)
    kwargs = _adapt_kwargs(cls, kwargs)
    return lambda params: cls(params, **kwargs)


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
    """The frozen fp32 AutoencoderKL. Its own ``ckpt_path`` is not read (nor
    by the JAX package): the engine's checkpoint fills ``first_stage_model.*``."""
    if node is None:
        return None
    resolve_class_path(node.get("class_path") or "")  # IdentityFirstStage raises: not ported
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
    trainer (models/autoencoder.py:134-505 config surface)."""
    from ..losses.vae_loss import AutoencoderPerceptual
    from ..models.vae import Decoder, Encoder
    from .vae_engine import AutoencodingEngine

    args = dict(model_node.get("init_args") or {})
    for key, what in (("regularizer_config", "regularizers other than the KL posterior"),
                      ("ckpt_path", "loading a VAE checkpoint"), ("scheduler", "LR schedules")):
        if args.get(key):
            raise NotImplementedError(f"{key}: {what} for the VAE trainer are not ported yet: ROADMAP Queue 1 "
                                      f"item {'8' if key == 'scheduler' else '9'}")
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
    g_opt = build_optimizer(args.get("optimizer"))
    d_opt = build_optimizer(args["disc_optimizer"]) if args.get("disc_optimizer") \
        else (lambda params: torch.optim.Adam(params, lr=1e-4))  # optax.adam(1e-4), the JAX default
    disc_start = getattr(loss, "disc_start", -1)
    return AutoencodingEngine(
        encoder=encoder,
        decoder=decoder,
        loss=loss,
        g_optimizer=g_opt,
        d_optimizer=d_opt,
        kl_weight=float(args.get("kl_weight", 0.0)),
        input_key=args.get("input_key", "image"),
        disc_start=disc_start if isinstance(disc_start, int) else -1,
        use_ema=bool(args.get("use_ema", False)),
        device=device,
    )


def build_diffusion_engine(model_node: dict, dtype=None, device=None, generator=None) -> DiffusionEngine:
    """The reference `model:` YAML node → DiffusionEngine."""
    args = dict(model_node.get("init_args") or {})
    for key, item in (("forward_hooks", "11 (loss hooks)"), ("log_sigmas", "7 (the per-sample loss breakdown)")):
        if args.get(key):
            raise NotImplementedError(f"{key} is not ported yet: ROADMAP Queue 1 item {item}")
    context = {"device": device, "generator": generator}

    unet = instantiate(args["model"], context, dtype=dtype)
    denoiser = instantiate(args["denoiser"], context)
    loss_fn = instantiate(args["loss_fn"], context) if "loss_fn" in args else None
    sampler = instantiate(args["sampler"], context) if "sampler" in args else None
    conditioner, trainable_idx = build_conditioner(args["conditioner"], context)
    first_stage = build_first_stage(args.get("first_stage_model"), context)
    optimizer = build_optimizer(args.get("optimizer"), args.get("scheduler"))

    # per-module LR param groups (models/diffusion.py:261-296) come with the
    # configs that set them (sdxl-te, whose optimizer and scheduler wait too)
    emb_nodes = (args["conditioner"].get("init_args") or {}).get("emb_models", [])
    if args.get("base_lr") and any((emb_nodes[i].get("init_args") or {}).get("base_lr") is not None
                                   for i in trainable_idx):
        raise NotImplementedError("per-embedder base_lr param groups are not ported yet: ROADMAP Queue 1 item 8")

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
        device=device,
    )
    engine.ckpt_path = args.get("ckpt_path")
    return engine
