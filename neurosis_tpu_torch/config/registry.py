"""class_path registry: the reference's dotted names → the port's classes
(port of neurosis_tpu/config/registry.py).

Every path the JAX registry knows either resolves to a port class or raises
``NotImplementedError`` naming the ROADMAP item (Queue 1) that ports it, so a
config node the port cannot honour never passes in silence. A path into the
JAX package, ``neurosis_tpu.<module>.<Name>`` (which JAX's registry imports
as it stands), resolves to ``neurosis_tpu_torch.<module>.<Name>`` where the
port has that module and name, and raises ``ImportError`` otherwise; the
JAX package is never imported. The JAX
registry maps ``torch.optim.AdamW``, ``Adam`` and ``SGD`` to optax's
``adamw``, ``adam`` and ``sgd``, and so does the port (to its counterparts
of them, which train optax's math and take optax's arguments). Of optax's
other aliases, which JAX's registry imports, the port has its own copies
(``optimizers/optax_aliases.py``) of all but eight: six it refuses naming
their item, and two whose update needs the loss value, which neither
package's engine passes. Of the other real imports the JAX registry falls
back to, the port keeps only ``torch.*``.
"""

from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict

_D = "neurosis.modules.diffusion."
_SS = _D + "sampling.sigma_generators."
_ENC = "neurosis.modules.encoders."
_AE = "neurosis.modules.autoencoding."
_DS = "neurosis.dataset."

# path -> (module of the port, attribute)
_PORTED = {
    _D + "UNetModel": ("models.unet", "UNetModel"),
    _D + "openaimodel.UNetModel": ("models.unet", "UNetModel"),
    _D + "model.Encoder": ("models.vae", "Encoder"),
    _D + "model.Decoder": ("models.vae", "Decoder"),
    _D + "DiscreteDenoiser": ("diffusion.denoiser", "DiscreteDenoiser"),
    _D + "EpsPreconditioning": ("diffusion.preconditioning", "EpsPreconditioning"),
    _D + "EpsWeighting": ("diffusion.weighting", "EpsWeighting"),
    _D + "LegacyDDPMDiscretization": ("diffusion.discretization", "LegacyDDPMDiscretization"),
    _D + "StandardDiffusionLoss": ("diffusion.loss", "StandardDiffusionLoss"),
    _D + "sigma_sampling.DiscreteSampling": ("diffusion.sigma_generators", "DiscreteSigmaGenerator"),
    _SS + "DiscreteSigmaGenerator": ("diffusion.sigma_generators", "DiscreteSigmaGenerator"),
    **{_D + "sampling." + n: ("sampling.samplers", n) for n in (
        "EulerEDMSampler", "HeunEDMSampler", "EulerAncestralSampler", "DPMPP2SAncestralSampler", "DPMPP2MSampler",
        "LinearMultistepSampler")},
    **{"neurosis.modules.guidance." + n: ("sampling.guidance", n) for n in (
        "VanillaCFG", "IdentityGuider", "LinearPredictionGuider")},
    _ENC + "GeneralConditioner": ("modules.encoders.embedding", "GeneralConditioner"),
    "neurosis.models.text_encoder.FrozenCLIPEmbedder": ("modules.encoders.embedding", "FrozenCLIPEmbedder"),
    "neurosis.models.text_encoder.FrozenOpenCLIPEmbedder2": ("modules.encoders.embedding",
                                                             "FrozenOpenCLIPEmbedder2"),
    _ENC + "metadata.ConcatTimestepEmbedderND": ("modules.encoders.embedding", "ConcatTimestepEmbedderND"),
    "neurosis.models.text_encoder.FrozenCLIPT5Encoder": ("modules.encoders.clip_t5", "FrozenCLIPT5Encoder"),
    _ENC + "misc.IdentityEncoder": ("modules.encoders.embedding", "IdentityEncoder"),
    _ENC + "classed.ClassEmbedder": ("modules.encoders.misc", "ClassEmbedder"),
    _ENC + "classed.ClassEmbedderForMultiCond": ("modules.encoders.misc", "ClassEmbedderForMultiCond"),
    _ENC + "metadata.GaussianEncoder": ("modules.encoders.misc", "GaussianEncoder"),
    _ENC + "embedding.SpatialRescaler": ("modules.encoders.misc", "SpatialRescaler"),
    _ENC + "lowscale.LowScaleEncoder": ("modules.encoders.misc", "LowScaleEncoder"),
    "neurosis.models.DiffusionEngine": ("trainer.engine", "DiffusionEngine"),
    "neurosis.models.diffusion.DiffusionEngine": ("trainer.engine", "DiffusionEngine"),
    "neurosis.models.AutoencoderKL": ("models.autoencoder", "AutoencoderKL"),
    "neurosis.models.autoencoder.AutoencoderKL": ("models.autoencoder", "AutoencoderKL"),
    "neurosis.models.autoencoder.AutoencodingEngine": ("trainer.vae_engine", "AutoencodingEngine"),
    "neurosis.models.AutoencodingEngine": ("trainer.vae_engine", "AutoencodingEngine"),
    _AE + "losses.AutoencoderPerceptual": ("losses.vae_loss", "AutoencoderPerceptual"),
    _AE + "losses.AutoencoderLPIPSWithDiscr": ("losses.vae_loss", "AutoencoderLPIPSWithDiscr"),
    _DS + "aspect.AspectBucketList": ("data.aspect", "AspectBucketList"),
    _DS + "aspect.SDXLBucketList": ("data.aspect", "SDXLBucketList"),
    _DS + "aspect.WDXLBucketList": ("data.aspect", "WDXLBucketList"),
    _DS + "aspect.WDXLBucketList2": ("data.aspect", "WDXLBucketList2"),
    _DS + "imagefolder.ImageFolderDataset": ("data.imagefolder", "ImageFolderDataset"),
    _DS + "imagefolder.ImageFolderModule": ("data.imagefolder", "ImageFolderDataset"),
    _DS + "imagefolder.FolderSquareDataset": ("data.imagefolder", "FolderSquareDataset"),
    _DS + "imagefolder.FolderSquareModule": ("data.imagefolder", "FolderSquareDataset"),
    _DS + "imagefolder.FolderVAEDataset": ("data.imagefolder", "FolderVAEDataset"),
    _DS + "imagefolder.FolderVAEModule": ("data.imagefolder", "FolderVAEDataset"),
    "neurosis.optimizers.Adafactor": ("optimizers.adafactor", "Adafactor"),
    "neurosis.optimizers.AdafactorScheduler": ("optimizers.adafactor", "adafactor_relative_step_schedule"),
    **{f"optax.{n}": ("optimizers.adamw", n) for n in ("adamw", "adam", "sgd")},
    **{f"optax.{n}": ("optimizers.optax_aliases", n) for n in (
        "lion", "lamb", "adafactor", "nadamw", "nadam", "radam", "amsgrad", "adamax", "adamaxw", "adabelief",
        "rmsprop", "adagrad", "yogi", "novograd", "adan", "adadelta", "rprop", "sign_sgd", "lars")},
    "torch.optim.AdamW": ("optimizers.adamw", "adamw"),
    "torch.optim.Adam": ("optimizers.adamw", "adam"),
    "torch.optim.SGD": ("optimizers.adamw", "sgd"),
    "neurosis.optimizers.CAME": ("optimizers.came", "CAME"),
    "neurosis.optimizers.came.CAME": ("optimizers.came", "CAME"),
    "bitsandbytes.optim.AdamW8bit": ("optimizers.adamw8bit", "AdamW8bit"),
    **{"neurosis.schedulers." + n: ("schedulers.schedules", f) for n, f in (
        ("CosineWithWarmUp", "cosine_with_warmup"), ("CosineWithHardRestartsAndWarmUp", "cosine_with_hard_restarts"),
        ("LambdaWarmUpCosineScheduler2", "lambda_warmup_cosine_scheduler2"),
        ("LambdaLinearScheduler", "lambda_linear_scheduler"),
        ("CosineAnnealingWarmupRestarts", "cosine_annealing_warmup_restarts"),
        ("CosineDecayWithWarmup", "cosine_decay_with_warmup"), ("CosineWarmupSchedule", "cosine_warmup_schedule"),
        ("CosineWarmupStagedSchedule", "cosine_warmup_schedule_staged"),
        ("LinearWarmupSchedule", "linear_warmup_schedule"),
        ("LegacyCosineAnnealingWarmupRestarts", "legacy_cosine_annealing_warmup_restarts"))},
    "DeviceStatsMonitor": ("trainer.callbacks", "DeviceStatsCallback"),
    "lightning.pytorch.callbacks.DeviceStatsMonitor": ("trainer.callbacks", "DeviceStatsCallback"),
    "lightning.pytorch.callbacks.ModelSummary": ("trainer.callbacks", "ModelSummaryCallback"),
    _D + "Denoiser": ("diffusion.denoiser", "Denoiser"),
    **{_D + n: ("diffusion.preconditioning", n) for n in (
        "VPreconditioning", "VPreconditioningWithEDMcNoise", "EDMPreconditioning", "RectifiedFlowXLPreconditioning",
        "RectifiedFlowComfyPreconditioning")},
    **{_D + n: ("diffusion.weighting", n) for n in (
        "UnitWeighting", "EDMWeighting", "RectifiedFlowWeighting", "RectifiedFlowComfyWeighting",
        "MinSNRGammaModifier")},
    **{_D + n: ("diffusion.discretization", n) for n in (
        "EDMcDiscretization", "EDMcSimpleDiscretization", "EDMDiscretization", "TanZeroSNRDiscretization",
        "RectifiedFlowDiscretization", "RectifiedFlowComfyDiscretization")},
    _D + "sigma_sampling.EDMSampling": ("diffusion.sigma_generators", "EDMSigmaGenerator"),
    **{_SS + n: ("diffusion.sigma_generators", n) for n in (
        "EDMSigmaGenerator", "CosineScheduleSigmaGenerator", "TanScheduleSigmaGenerator",
        "RectifiedFlowSigmaGenerator", "RectifiedFlowComfySigmaGenerator")},
    "neurosis.models.IdentityFirstStage": ("models.autoencoder", "IdentityFirstStage"),
    "neurosis.models.autoencoder.IdentityFirstStage": ("models.autoencoder", "IdentityFirstStage"),
    **{_DS + "processing." + n: ("hooks.tag_loss", n) for n in ("TagFrequencyHook", "TagFreqScale", "TagRewards")},
    _D + "model.Model": ("models.vae", "Model"),
    **{p + n: ("models.autoencoder", n) for p in ("neurosis.models.", "neurosis.models.autoencoder.")
       for n in ("AutoencoderKLInferenceWrapper", "AEIntegerWrapper")},
    _AE + "losses.GeneralLPIPSWithDiscriminator": ("losses.discriminator_loss", "GeneralLPIPSWithDiscriminator"),
    _AE + "losses.VQLPIPSWithDiscriminator": ("losses.discriminator_loss", "VQLPIPSWithDiscriminator"),
    _AE + "losses.LatentLPIPS": ("losses.vae_loss", "LatentLPIPS"),
    _AE + "losses.AutoencoderDreamsim": ("losses.dreamsim", "AutoencoderDreamsim"),
    **{p: ("trainer.profile", "NeurosisProfiler") for p in (
        "neurosis.trainer.profile.NeurosisProfiler", "neurosis.trainer.profile.profiler.NeurosisProfiler",
        "NeurosisProfiler")},
    **{_AE + "regularizers." + n: ("modules.regularizers", n) for n in (
        "DiagonalGaussianRegularizer", "IdentityRegularizer")},
    **{_AE + "regularizers.quantize." + n: ("modules.regularizers", n) for n in (
        "VectorQuantizer", "GumbelQuantizer", "EMAVectorQuantizer", "VectorQuantizerWithInputProjection")},
}

_PORTED.update({_DS + m + c + k: ("data.mongo", c + "Dataset")
                for m, c in (("mongo.", "MongoAspect"), ("mongo.", "MongoSquare"), ("mongo.", "MongoVAE"),
                             ("mongo.aspect.", "MongoAspect"), ("mongo.nobucket.", "MongoSquare"),
                             ("mongo.nocaption.", "MongoVAE"))
                for k in ("Dataset", "Module")})

# paths the JAX registry knows and the port has not ported, by ROADMAP Queue 1 item
_OPTAX_ITEM = "14 (optax's other transforms)"
_NOT_PORTED: Dict[str, str] = {f"optax.{n}": _OPTAX_ITEM for n in (
    "noisy_sgd", "sm3", "fromage", "optimistic_gradient_descent", "optimistic_adam", "optimistic_adam_v2")}
# optax aliases whose update needs the loss value: JAX's engine calls
# ``optimizer.update(grads, state, params)`` (neurosis_tpu/trainer/engine.py:203)
# and cannot drive them either
_NEEDS_LOSS = ("optax.lbfgs", "optax.polyak_sgd")
_JAX_PACKAGE = "neurosis_tpu."


def resolve_class_path(path: str) -> Any:
    if path in _PORTED:
        module, name = _PORTED[path]
        return getattr(importlib.import_module(f"neurosis_tpu_torch.{module}"), name)
    if path in _NEEDS_LOSS:
        raise NotImplementedError(f"class_path {path!r} needs the loss value in its update, and the JAX package's "
                                  "engine passes only grads, state and params (optimizer.update(grads, state, "
                                  "params)): neither package can drive it")
    if path in _NOT_PORTED:
        raise NotImplementedError(f"class_path {path!r} is not ported yet: ROADMAP Queue 1 item {_NOT_PORTED[path]}")
    if path.startswith(_JAX_PACKAGE):
        return _port_counterpart(path)
    if path.startswith("optax."):
        raise NotImplementedError(f"class_path {path!r} is not ported yet (of optax the port takes the aliases of "
                                  f"optax 0.2.6 but {', '.join(sorted(_NOT_PORTED))} and {' and '.join(_NEEDS_LOSS)}):"
                                  f" ROADMAP Queue 1 item {_OPTAX_ITEM}")
    if path.startswith("torch."):
        module, _, name = path.rpartition(".")
        try:
            return getattr(importlib.import_module(module), name)
        except (ImportError, AttributeError) as e:
            raise ImportError(f"cannot resolve class_path {path!r}: {e}") from e
    raise ImportError(f"cannot resolve class_path {path!r}: no port class has that path")


def _port_counterpart(path: str) -> Any:
    """``neurosis_tpu.<module>.<Name>`` → ``neurosis_tpu_torch.<module>.<Name>``."""
    module, _, name = path[len(_JAX_PACKAGE):].rpartition(".")
    try:
        found = getattr(importlib.import_module(f"neurosis_tpu_torch.{module}"), name) if module else None
    except (ImportError, AttributeError):
        found = None
    if found is None or inspect.ismodule(found):
        raise ImportError(f"cannot resolve class_path {path!r}: the port has no neurosis_tpu_torch.{module}.{name}")
    return found


def known_paths() -> dict:
    """{path: 'ported' or the ROADMAP item that ports it} of every path named here."""
    return {**{p: "ported" for p in _PORTED}, **_NOT_PORTED}
