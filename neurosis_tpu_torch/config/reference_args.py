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
 'optax.adadelta': {'weight_decay_mask': None},
 'optax.adafactor': {'weight_decay_mask': None},
 'optax.adamaxw': {'mask': None},
 'optax.adamw': {'mask': None},
 'optax.adan': {'mask': None},
 'optax.lamb': {'mask': None},
 'optax.lars': {'trust_ratio_mask': True, 'weight_decay_mask': True},
 'optax.lion': {'mask': None},
 'optax.nadamw': {'mask': None},
 'torch.optim.AdamW': {'mask': None}}

# optax's ``mask`` (a tree of the parameters' paths, or a function of the
# tree) cannot reach an optimizer that the JAX builder wraps in ``stacked``
# (it runs the transform on each bare leaf), and the port's optimizers see
# torch parameter lists, not Flax trees: see ROADMAP Queue 1 item 8
_ITEMS = {
    "8 (the optimizers: optax's mask)": ("mask", "weight_decay_mask", "trust_ratio_mask"),
}


def refusal_item(argument: str) -> str:
    """The ROADMAP Queue 1 item that ports ``argument``."""
    for item, names in _ITEMS.items():
        if argument in names:
            return item
    raise KeyError(f"no ROADMAP item names {argument!r}")
