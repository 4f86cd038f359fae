"""PyTorch/CUDA port of neurosis_tpu for one NVIDIA H100.

The package mirrors the JAX package's module layout (ops, modules, models,
diffusion, losses, optimizers, trainer, checkpoint, tools) and keeps its
activation layouts at public functions: NHWC in the UNet, [B, H, S, D] into
attention. Weights
are held in torch shapes (OIHW, (out, in)) under the torch dotted names the
JAX modules already use, so ``checkpoint.convert.jax_params_to_state_dict``
loads a JAX parameter tree with ``strict=True``.

The TPU kernels of the JAX package are hand-written CUDA kernels here
(``csrc/``), built with nvcc on first use into ``_build/``. Every kernel
wrapper runs its plain PyTorch version for CPU tensors and launches the
kernel for CUDA tensors.
"""

__all__ = ["resolve_device"]


def __getattr__(name: str):
    # torch is imported on first use, not with the package: the data prefetch
    # workers import the package's data modules and need numpy alone
    if name == "resolve_device":
        from ._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
