"""YAML config loading with ${...} interpolation and class_path instantiation
(port of neurosis_tpu/config/loader.py).

The file is read by the port's own reader (``yaml_reader.safe_load``, the
subset of YAML the configs use; anything else raises with its line). The
interpolations are the JAX package's: ``${a.b.c}`` (the dotted path into the
config) and ``${oc.env:NAME,default}``.

``instantiate`` threads a ``device`` and a ``generator`` into every class
whose signature takes them, so the σ tables, the UNet and the towers are
built on the run's device from the run's seeded generator.

An argument the port's class does not take is dropped only where the JAX
package's class does not take it either (the reference's torch-only
arguments, such as ``verbose``). Where JAX's class takes it
(``reference_args.JAX_ONLY_ARGS``), a value equal to JAX's default passes
(the class does what that default does) and any other raises
``NotImplementedError`` naming the ROADMAP item that ports it: a config is
never trained as something else in silence.
"""

from __future__ import annotations

import dataclasses
import inspect
import logging
import os
import re
from pathlib import Path
from typing import Any, Mapping

from .reference_args import JAX_ONLY_ARGS, refusal_item
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
        kwargs = _adapt_kwargs(cls, kwargs, node["class_path"])
        return cls(**kwargs)
    if isinstance(node, dict):
        return {k: instantiate(v, context) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v, context) for v in node]
    return node


def _parameters(cls):
    """The keyword names ``cls`` takes, or None when it takes any. A class
    whose ``__init__`` passes ``**kwargs`` on takes what the base that
    names its arguments takes; ``**kwargs`` that no base names are the
    class's own (any keyword)."""
    if dataclasses.is_dataclass(cls):
        return {f.name for f in dataclasses.fields(cls)}
    funcs = [b.__dict__["__init__"] for b in cls.__mro__ if "__init__" in b.__dict__] \
        if isinstance(cls, type) else [cls]
    names = set()
    for fn in funcs:
        if fn is object.__init__:
            return None if names or fn is not funcs[0] else set()
        try:
            params = inspect.signature(fn).parameters
        except (ValueError, TypeError):
            return None
        names |= {n for n, p in params.items() if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)}
        if not any(p.kind == p.VAR_KEYWORD for p in params.values()):
            return names - {"self"}
    return None


def _normal(v: Any) -> Any:
    """YAML lists and tuples compare alike."""
    return tuple(_normal(x) for x in v) if isinstance(v, (list, tuple)) else v


def _adapt_kwargs(cls, kwargs: dict, path: str = "") -> dict:
    """Drop the arguments neither ``cls`` nor JAX's class at ``path`` takes
    (logged); pass one JAX takes at its default; refuse one JAX takes at any
    other value."""
    fields = _parameters(cls)
    if fields is None:
        return kwargs
    jax_only = JAX_ONLY_ARGS.get(path, {})
    dropped = []
    for k in sorted(k for k in kwargs if k not in fields):
        value = kwargs.pop(k)
        if k not in jax_only:
            dropped.append(k)
        elif _normal(value) != _normal(jax_only[k]):
            raise NotImplementedError(f"{path} {k}={value!r} (the JAX package's default is {jax_only[k]!r}) is not "
                                      f"ported yet: ROADMAP Queue 1 item {refusal_item(k)}")
    if dropped:
        logger.warning(f"{getattr(cls, '__name__', cls)} takes no {dropped}: dropped")
    return kwargs
