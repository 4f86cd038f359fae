"""Kernel entry points of the port and their launch counters.

Each wrapper counts the launches of its CUDA kernel (``wrapper.launches``);
calls on CPU tensors run the plain version and count nothing.
"""

from .conv3x3 import conv3x3_nhwc, gn_silu_conv3x3_nhwc
from .flash_attention import flash_bwd, flash_bwd_f32, flash_fwd, flash_fwd_f32
from .flash_overlap import flash_fwd_chunked, flash_fwd_split2

KERNEL_WRAPPERS = {
    "flash_fwd": flash_fwd,
    "flash_bwd": flash_bwd,
    "flash_fwd_f32": flash_fwd_f32,
    "flash_bwd_f32": flash_bwd_f32,
    "flash_fwd_split2": flash_fwd_split2,
    "flash_fwd_chunked": flash_fwd_chunked,
    "conv3x3": conv3x3_nhwc,
    "gn_silu_conv3x3": gn_silu_conv3x3_nhwc,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
