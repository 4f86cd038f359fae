"""Module-name spans for profiler traces (port of
neurosis_tpu/utils/profiling.py; RecordModuleNames parity:
trainer/profile/profiler.py:236-299).

Inside ``record_module_names(max_depth)`` every ``nn.Module`` call opens a
``torch.profiler.record_function`` range named ``[mod]<path>(<Class>)``
(global forward pre- and post-hooks), so a profiler trace carries the class
of each module around the ops it ran. The labels follow JAX's: the dotted
path of the module in the tree of the outermost module being called (that
module itself by its class name), "(Class)" rather than ":Class", and no
deeper than ``max_depth`` path components (-1 or 0: every depth). Each
range's own device time is about 0: its kernels belong to the ops under it.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []  # (module, the record_function it opened or None, the names of its tree)
    return _state.stack


def _label(module: nn.Module, max_depth: int, roots: dict):
    """(label or None when deeper than max_depth, the names of the tree it
    is in: {id(module): dotted path} of its root's modules, made once a root)."""
    stack = _stack()
    names = stack[-1][2] if stack else None
    path = names.get(id(module)) if names is not None else None
    if path is None:  # the outermost call, or a module outside the caller's tree: a root
        if id(module) not in roots:
            roots[id(module)] = {id(m): name for name, m in module.named_modules()}
        return type(module).__name__, roots[id(module)]
    if max_depth > 0 and len(path.split(".")) > max_depth:
        return None, names
    return path, names


@contextlib.contextmanager
def record_module_names(max_depth: int = -1):
    """Open a ``[mod]path(Class)`` range around every module call made
    inside the context (depth-limited like the reference's
    RecordModuleNames(max_depth=...)). Results are unchanged."""
    roots: dict = {}

    def pre(module, args):
        label, names = _label(module, max_depth, roots)
        span = None
        if label is not None:
            span = torch.profiler.record_function(f"[mod]{label}({type(module).__name__})")
            span.__enter__()
        _stack().append((module, span, names))

    def post(module, args, output):
        stack = _stack()
        while stack:  # a call that raised left its frames: close them too
            mod, span, _ = stack.pop()
            if span is not None:
                span.__exit__(None, None, None)
            if mod is module:
                break

    handles = [nn.modules.module.register_module_forward_pre_hook(pre),
               nn.modules.module.register_module_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
        stack = _stack()
        while stack:
            _, span, _ = stack.pop()
            if span is not None:
                span.__exit__(None, None, None)
