"""class_path registry: the reference's dotted names → the port's classes
(port of neurosis_tpu/config/registry.py).

Every path the JAX registry knows either resolves to a port class or raises
``NotImplementedError`` naming the ROADMAP item (Queue 1) that ports it, so a
config node the port cannot honour never passes in silence. Of the real
imports the JAX registry falls back to, the port keeps only ``torch.*``
(``torch.optim.AdamW`` is torch's own, not optax's).
"""

from __future__ import annotations

import importlib
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
    "optax.adamw": ("optimizers.adamw", "adamw"),
    "DeviceStatsMonitor": ("trainer.callbacks", "DeviceStatsCallback"),
    "lightning.pytorch.callbacks.DeviceStatsMonitor": ("trainer.callbacks", "DeviceStatsCallback"),
    "lightning.pytorch.callbacks.ModelSummary": ("trainer.callbacks", "ModelSummaryCallback"),
}

# paths the JAX registry knows and the port has not ported, by ROADMAP Queue 1 item
_DIFFUSION_MATH = ["Denoiser", "VPreconditioning", "VPreconditioningWithEDMcNoise", "EDMPreconditioning",
                   "RectifiedFlowXLPreconditioning", "RectifiedFlowComfyPreconditioning", "UnitWeighting",
                   "EDMWeighting", "RectifiedFlowWeighting", "RectifiedFlowComfyWeighting", "MinSNRGammaModifier",
                   "EDMcDiscretization", "EDMcSimpleDiscretization", "EDMDiscretization",
                   "TanZeroSNRDiscretization", "RectifiedFlowDiscretization", "RectifiedFlowComfyDiscretization",
                   "sigma_sampling.EDMSampling"]
_SIGMA_GENERATORS = ["EDMSigmaGenerator", "CosineScheduleSigmaGenerator", "TanScheduleSigmaGenerator",
                     "RectifiedFlowSigmaGenerator", "RectifiedFlowComfySigmaGenerator"]
_SCHEDULERS = ["CosineWithWarmUp", "CosineWithHardRestartsAndWarmUp", "LambdaWarmUpCosineScheduler2",
               "LambdaLinearScheduler", "CosineAnnealingWarmupRestarts", "CosineDecayWithWarmup",
               "CosineWarmupSchedule", "CosineWarmupStagedSchedule", "LinearWarmupSchedule",
               "LegacyCosineAnnealingWarmupRestarts"]
_NOT_PORTED: Dict[str, str] = {}
_NOT_PORTED.update({_D + n: "7 (the rest of the SD path's options)" for n in _DIFFUSION_MATH})
_NOT_PORTED.update({_SS + n: "7 (the rest of the SD path's options)" for n in _SIGMA_GENERATORS})
_NOT_PORTED.update({p: "7 (the rest of the SD path's options)" for p in (
    "neurosis.models.IdentityFirstStage", "neurosis.models.autoencoder.IdentityFirstStage")})
_OPTIMIZERS_ITEM = "8 (sdxl-te: optimizers and schedulers)"
_NOT_PORTED.update({p: _OPTIMIZERS_ITEM for p in (
    ["bitsandbytes.optim.AdamW8bit", "neurosis.optimizers.AdafactorScheduler", "neurosis.optimizers.CAME",
     "neurosis.optimizers.came.CAME"] + ["neurosis.schedulers." + n for n in _SCHEDULERS])})
_NOT_PORTED.update({p: "9 (the rest of the VAE-GAN stack)" for p in (
    [_D + "model.Model", "neurosis.models.AutoencoderKLInferenceWrapper",
     "neurosis.models.autoencoder.AutoencoderKLInferenceWrapper", "neurosis.models.AEIntegerWrapper",
     "neurosis.models.autoencoder.AEIntegerWrapper", _AE + "losses.GeneralLPIPSWithDiscriminator",
     _AE + "losses.VQLPIPSWithDiscriminator", _AE + "losses.LatentLPIPS"]
    + [_AE + "regularizers." + n for n in ("DiagonalGaussianRegularizer", "IdentityRegularizer")]
    + [_AE + "regularizers.quantize." + n for n in ("VectorQuantizer", "GumbelQuantizer", "EMAVectorQuantizer",
                                                    "VectorQuantizerWithInputProjection")])})
_NOT_PORTED.update({p: "11 (the rest)" for p in (
    ["neurosis.models.text_encoder.FrozenCLIPT5Encoder", _ENC + "misc.IdentityEncoder",
     _ENC + "classed.ClassEmbedder", _ENC + "classed.ClassEmbedderForMultiCond", _ENC + "metadata.GaussianEncoder",
     _ENC + "embedding.SpatialRescaler", _ENC + "lowscale.LowScaleEncoder",
     _AE + "losses.AutoencoderDreamsim", "neurosis.trainer.profile.NeurosisProfiler",
     "neurosis.trainer.profile.profiler.NeurosisProfiler", "NeurosisProfiler",
     _DS + "processing.TagFrequencyHook", _DS + "processing.TagFreqScale", _DS + "processing.TagRewards"]
    + [_DS + m + "." + c + k for m in ("mongo", "mongo.aspect", "mongo.nobucket", "mongo.nocaption")
       for c in ("MongoAspect", "MongoSquare", "MongoVAE") for k in ("Dataset", "Module")])})


def resolve_class_path(path: str) -> Any:
    if path in _PORTED:
        module, name = _PORTED[path]
        return getattr(importlib.import_module(f"neurosis_tpu_torch.{module}"), name)
    if path in _NOT_PORTED:
        raise NotImplementedError(f"class_path {path!r} is not ported yet: ROADMAP Queue 1 item {_NOT_PORTED[path]}")
    if path.startswith("optax."):
        raise NotImplementedError(f"class_path {path!r} is not ported yet (of optax the port takes optax.adamw): "
                                  f"ROADMAP Queue 1 item {_OPTIMIZERS_ITEM}")
    if path.startswith("torch."):
        module, _, name = path.rpartition(".")
        try:
            return getattr(importlib.import_module(module), name)
        except (ImportError, AttributeError) as e:
            raise ImportError(f"cannot resolve class_path {path!r}: {e}") from e
    raise ImportError(f"cannot resolve class_path {path!r}: no port class has that path")


def known_paths() -> dict:
    """{path: 'ported' or the ROADMAP item that ports it} of every path named here."""
    return {**{p: "ported" for p in _PORTED}, **_NOT_PORTED}
