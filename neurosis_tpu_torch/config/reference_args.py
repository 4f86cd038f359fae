"""Arguments the JAX package's classes take that the port's do not.

A table by class path, {argument: JAX's default}, so the loader can tell a
reference argument that neither package takes (dropped) from one JAX honours
(refused unless at JAX's default), without importing JAX.
``tests/test_torch_reference_args.py`` rebuilds the table from the JAX
classes' signatures and the port's and asserts it equals this one.
"""

from __future__ import annotations

REQUIRED = "<required>"  # an argument JAX's class takes without a default

JAX_ONLY_ARGS: dict = {'bitsandbytes.optim.AdamW8bit': {'mask': None},
 'neurosis.models.AutoencodingEngine': {'adaptive_disc_weight': False,
                                        'diff_boost_factor': 3.0,
                                        'ema_decay': 0.9999,
                                        'freeze_decoder': False,
                                        'freeze_encoder': False,
                                        'regularizer': None},
 'neurosis.models.autoencoder.AutoencodingEngine': {'adaptive_disc_weight': False,
                                                    'diff_boost_factor': 3.0,
                                                    'ema_decay': 0.9999,
                                                    'freeze_decoder': False,
                                                    'freeze_encoder': False,
                                                    'regularizer': None},
 'neurosis.modules.diffusion.UNetModel': {'context_axis': None},
 'neurosis.modules.diffusion.model.Decoder': {'give_pre_end': False,
                                              'remat': False,
                                              'resamp_with_conv': True,
                                              'tanh_out': False},
 'neurosis.modules.diffusion.model.Encoder': {'remat': False, 'resamp_with_conv': True},
 'neurosis.modules.diffusion.openaimodel.UNetModel': {'context_axis': None},
 'optax.adamw': {'eps_root': 0.0, 'mask': None, 'mu_dtype': None, 'nesterov': False}}

# torch.optim.AdamW computes m̂/(√v̂ + eps): optax's eps_root (inside the root)
# and nesterov have no exact counterpart there, so they wait with item 8
_ITEMS = {
    "8 (the optimizers CAME, hybrid and stacked)": ("mask", "mu_dtype", "eps_root", "nesterov"),
    "9 (the rest of the VAE-GAN stack)": ("resamp_with_conv", "remat", "give_pre_end", "tanh_out",
                                          "adaptive_disc_weight", "diff_boost_factor", "ema_decay",
                                          "freeze_decoder", "freeze_encoder", "regularizer"),
    "10 (multi-GPU)": ("context_axis",),
}


def refusal_item(argument: str) -> str:
    """The ROADMAP Queue 1 item that ports ``argument``."""
    for item, names in _ITEMS.items():
        if argument in names:
            return item
    raise KeyError(f"no ROADMAP item names {argument!r}")
