"""YAML config loading with ${...} interpolation and class_path instantiation
(port of neurosis_tpu/config/loader.py).

The file is read by the port's own reader (``yaml_reader.safe_load``, the
subset of YAML the configs use; anything else raises with its line). The
interpolations are the JAX package's: ``${a.b.c}`` (the dotted path into the
config) and ``${oc.env:NAME,default}``.

``instantiate`` threads a ``device`` and a ``generator`` into every class
whose signature takes them, so the σ tables, the UNet and the towers are
built on the run's device from the run's seeded generator.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import os
import re
from pathlib import Path
from typing import Any, Mapping

from .registry import resolve_class_path
from .yaml_reader import safe_load

logger = logging.getLogger(__name__)

_INTERP = re.compile(r"\$\{([^}]+)\}")
_THREADED = ("device", "generator")


def load_config(path) -> dict:
    path = Path(path)
    return resolve_interpolations(safe_load(path.read_text(), str(path)))


def _lookup(root: Any, dotted: str) -> Any:
    cur = root
    for part in dotted.split("."):
        if isinstance(cur, Mapping):
            cur = cur[part]
        elif isinstance(cur, (list, tuple)):
            cur = cur[int(part)]
        else:
            raise KeyError(dotted)
    return cur


def resolve_interpolations(cfg: Any) -> Any:
    """Iteratively resolve ${dotted.path} and ${oc.env:VAR,default} strings."""

    def resolve_value(v: Any) -> Any:
        if not isinstance(v, str):
            return v
        m = _INTERP.fullmatch(v.strip())
        if m:  # whole-string interpolation preserves type
            return _resolve_expr(m.group(1), cfg)
        return _INTERP.sub(lambda mm: str(_resolve_expr(mm.group(1), cfg)), v)

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return resolve_value(node)

    # two passes handle chained interpolations
    out = walk(cfg)
    return walk(out)


def _resolve_expr(expr: str, root: Any) -> Any:
    expr = expr.strip()
    if expr.startswith("oc.env:"):
        body = expr[len("oc.env:"):]
        name, _, default = body.partition(",")
        return os.environ.get(name.strip(), default.strip() or None)
    return _lookup(root, expr)


def instantiate(node: Any, context: Mapping[str, Any] = None, **overrides) -> Any:
    """Recursively build the object graph from class_path/init_args nodes.
    ``context`` ({'device': ..., 'generator': ...}) reaches every class, at
    any depth, whose signature names them; ``overrides`` only the top node."""
    context = context or {}
    if isinstance(node, dict) and "class_path" in node:
        cls = resolve_class_path(node["class_path"])
        kwargs = {k: instantiate(v, context) for k, v in (node.get("init_args") or {}).items()}
        kwargs.update(node.get("dict_kwargs") or {})
        kwargs.update(overrides)
        params = _parameters(cls)
        for name in _THREADED:
            if name in context and name not in kwargs and params is not None and name in params:
                kwargs[name] = context[name]
        kwargs = _adapt_kwargs(cls, kwargs)
        return cls(**kwargs)
    if isinstance(node, dict):
        return {k: instantiate(v, context) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v, context) for v in node]
    return node


def _parameters(cls):
    """The keyword names ``cls`` takes, or None when it takes any."""
    try:
        if dataclasses.is_dataclass(cls):
            return {f.name for f in dataclasses.fields(cls)}
        sig = inspect.signature(cls)
    except (ValueError, TypeError):
        return None
    if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
        return None
    return set(sig.parameters)


def _adapt_kwargs(cls, kwargs: dict) -> dict:
    """Drop the arguments ``cls`` does not take, as the JAX package does
    (torch-only arguments of the reference such as ``verbose``); each one
    dropped is logged."""
    fields = _parameters(cls)
    if fields is None:
        return kwargs
    dropped = sorted(k for k in kwargs if k not in fields)
    for k in dropped:
        kwargs.pop(k)
    if dropped:
        logger.warning(f"{getattr(cls, '__name__', cls)} takes no {dropped}: dropped")
    return kwargs
