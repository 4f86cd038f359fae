"""optax's other optimizers as torch optimizers (optax 0.2.6's aliases).

A config naming ``optax.<name>`` trains under the JAX package with optax's
chain, which its ``stacked`` wrapper runs leaf by leaf; these classes
compute the same chains leaf by leaf, in optax's order of operations, with
optax's signatures and defaults (the card's machine has no optax, so the
math is copied here). As in ``adamw.py``, each param group's ``lr`` is the
learning rate (``schedulers.attach_schedule`` schedules it) and a group
without one (``adafactor``'s and ``adadelta``'s default ``None``) takes
optax's identity in place of ``scale_by_learning_rate``. ``rprop`` reads its
``learning_rate`` once, as optax does: it is the initial step size.

The chains whose every op is elementwise run over multi-tensor
``torch._foreach_*`` ops, on each rank's own part of a parameter that FSDP2
shards. ``lamb``, ``lars``, ``novograd`` and ``adafactor`` take a norm or a
mean over each whole leaf, so they run leaf by leaf on the tensors as they
are (a DTensor reduces over the whole leaf). optax's ``mask`` arguments are
not taken (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .adamw import DtypeLike, OptaxAdam, _bias_correction, _local, _scaled_in_own_dtype, _with_grads, as_dtype


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _lr_scaled(updates: list, lr: Optional[float]) -> list:
    """optax's ``scale_by_learning_rate``: × −lr, or the identity without one."""
    if lr is not None:
        torch._foreach_mul_(updates, -lr)
    return updates


class _Chain(torch.optim.Optimizer):
    """One optax chain: ``_init`` fills a leaf's state, ``_update`` returns
    the chain's final updates (added to the parameters) for a group."""

    elementwise = True  # run on each rank's own part of a sharded leaf

    def __init__(self, params, lr, **hyper):
        super().__init__(params, dict(lr=lr, **hyper))

    def _init(self, group: dict, p: torch.Tensor, state: dict) -> None:
        pass

    def _update(self, group: dict, params: list, grads: list, state: dict, count: int) -> list:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params, grads = _with_grads(group)
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["count"] = 0
                    self._init(group, p, st)
                st["count"] += 1
            count = self.state[params[0]]["count"]
            keys = [k for k, v in self.state[params[0]].items() if isinstance(v, torch.Tensor)]
            state = {k: [self.state[p].get(k) for p in params] for k in keys}
            if self.elementwise:
                state = {k: _local(v) for k, v in state.items()}
                params, grads = _local(params), _local(grads)
            updates = self._update(group, params, grads, state, count)
            torch._foreach_add_(params, updates)
        return loss


def _ema_(moments: list, grads: list, decay: float, order: int = 1) -> None:
    """optax ``update_moment``: (1 − decay)·gᵒʳᵈᵉʳ + decay·t, in place."""
    torch._foreach_mul_(moments, decay)
    powered = grads if order == 1 else torch._foreach_mul(grads, grads)
    torch._foreach_add_(moments, torch._foreach_mul(powered, 1.0 - decay))


def _ema_in_dtype(stored: list, grads: list, decay: float) -> list:
    """optax ``update_moment`` order 1 on a moment kept in another dtype
    (``mu_dtype``): decay·m in m's dtype, the sum in the grads' dtype;
    the result stays in the grads' dtype (the caller casts it back)."""
    scaled = [m.to(g.dtype) for m, g in zip(_scaled_in_own_dtype(stored, decay), grads)]
    torch._foreach_add_(scaled, torch._foreach_mul(grads, 1.0 - decay))
    return scaled


def _store(stored: list, values: list) -> None:
    for m, v in zip(stored, values):
        m.copy_(v)


def _trace(updates: list, traces: list, decay: float, nesterov: bool) -> list:
    """optax ``trace``: t ← g + decay·t; the update t (or g + decay·t)."""
    new = torch._foreach_add(updates, torch._foreach_mul(traces, decay))
    out = torch._foreach_add(updates, torch._foreach_mul(new, decay)) if nesterov else [t.clone() for t in new]
    _store(traces, new)
    return out


def _nesterov_mu_hat(mu: list, grads: list, b1: float, count: int) -> list:
    """b1·μ/(1 − b1^(count+1)) + (1 − b1)·g/(1 − b1^count)."""
    mu_hat = torch._foreach_mul(torch._foreach_div(mu, _bias_correction(b1, count + 1)), b1)
    torch._foreach_add_(mu_hat, torch._foreach_mul(torch._foreach_div(grads, _bias_correction(b1, count)), 1.0 - b1))
    return mu_hat


# -- elementwise chains --------------------------------------------------------


class Lion(_Chain):
    """``chain(scale_by_lion, add_decayed_weights, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        mus = state["mu"]
        mixed = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mixed, [m.to(g.dtype) for m, g in zip(_scaled_in_own_dtype(mus, b1), grads)])
        updates = torch._foreach_sign(mixed)
        _store(mus, _ema_in_dtype(mus, grads, b2))
        if group["weight_decay"]:
            torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
        return _lr_scaled(updates, group["lr"])


class AMSGrad(_Chain):
    """``chain(scale_by_amsgrad, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p, dtype=group["mu_dtype"] or p.dtype)
        st["nu"] = torch.zeros_like(p)
        st["nu_max"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        mu = _ema_in_dtype(state["mu"], grads, b1)
        _ema_(state["nu"], grads, b2, 2)
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        nu_hat = torch._foreach_div(state["nu"], _bias_correction(b2, count))
        torch._foreach_maximum_(state["nu_max"], nu_hat)
        den = torch._foreach_add(state["nu_max"], group["eps_root"])
        den = torch._foreach_sqrt(den)
        torch._foreach_add_(den, group["eps"])
        updates = torch._foreach_div(mu_hat, den)
        _store(state["mu"], mu)
        return _lr_scaled(updates, group["lr"])


class Adamax(_Chain):
    """``chain(scale_by_adamax, add_decayed_weights, scale_by_learning_rate)``
    (``adamax`` without the decay, ``adamaxw`` with it)."""

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        _ema_(state["mu"], grads, b1)
        # optax update_infinity_moment: max(|g| + eps, b2·ν)
        absg = torch._foreach_abs(grads)
        torch._foreach_add_(absg, group["eps"])
        torch._foreach_mul_(state["nu"], b2)
        torch._foreach_maximum_(state["nu"], absg)
        updates = torch._foreach_div(torch._foreach_div(state["mu"], _bias_correction(b1, count)), state["nu"])
        if group["weight_decay"]:
            torch._foreach_add_(updates, torch._foreach_mul(params, group["weight_decay"]))
        return _lr_scaled(updates, group["lr"])


class AdaBelief(_Chain):
    """``chain(scale_by_belief, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = state["mu"], state["nu"]
        _ema_(mu, grads, b1)
        _ema_(nu, torch._foreach_sub(grads, mu), b2, 2)
        torch._foreach_add_(nu, group["eps_root"])
        mu_hat = _nesterov_mu_hat(mu, grads, b1, count) if group["nesterov"] else \
            torch._foreach_div(mu, _bias_correction(b1, count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(b2, count)))
        torch._foreach_add_(den, group["eps"])
        return _lr_scaled(torch._foreach_div(mu_hat, den), group["lr"])


class RAdam(_Chain):
    """``chain(scale_by_radam, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = state["mu"], state["nu"]
        _ema_(mu, grads, b1)
        _ema_(nu, grads, b2, 2)
        # ρ and r in fp32, as optax computes them from the int32 count
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _f32(b2) ** count
        ro = float(_f32(ro_inf) - 2 * _f32(count) * b2t / (1 - b2t))
        mu_hat = _nesterov_mu_hat(mu, grads, b1, count) if group["nesterov"] else \
            torch._foreach_div(mu, _bias_correction(b1, count))
        if ro < group["threshold"]:
            return _lr_scaled(mu_hat, group["lr"])
        r = float(torch.sqrt((_f32(ro) - 4.0) * (_f32(ro) - 2.0) * ro_inf
                             / (_f32((ro_inf - 4.0) * (ro_inf - 2.0)) * _f32(ro))))
        den = torch._foreach_div(nu, _bias_correction(b2, count))
        if group["eps_root"]:
            torch._foreach_add_(den, group["eps_root"])
        den = torch._foreach_sqrt(den)
        torch._foreach_add_(den, group["eps"])
        updates = torch._foreach_div(torch._foreach_mul(mu_hat, r), den)
        return _lr_scaled(updates, group["lr"])


class RMSProp(_Chain):
    """``chain(scale_by_rms or scale_by_stddev, scale_by_learning_rate,
    trace or identity)``."""

    def _init(self, group, p, st):
        st["nu"] = torch.full_like(p, group["initial_scale"])
        if group["centered"]:
            st["mu"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            st["trace"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        decay = group["decay"]
        nu = state["nu"]
        if group["centered"]:
            _ema_(state["mu"], grads, decay)
        _ema_(nu, grads, decay, 2)
        if group["bias_correction"]:
            nu_hat = torch._foreach_div(nu, _bias_correction(decay, count))
            mu_hat = torch._foreach_div(state["mu"], _bias_correction(decay, count)) if group["centered"] else None
        else:
            nu_hat, mu_hat = nu, state.get("mu")
        if group["centered"]:
            nu_hat = torch._foreach_sub(nu_hat, torch._foreach_mul(mu_hat, mu_hat))
        if group["eps_in_sqrt"]:
            scaling = torch._foreach_rsqrt(torch._foreach_add(nu_hat, group["eps"]))
        else:
            scaling = torch._foreach_sqrt(nu_hat)
            torch._foreach_add_(scaling, group["eps"])
            scaling = torch._foreach_reciprocal(scaling)
        updates = _lr_scaled(torch._foreach_mul(scaling, grads), group["lr"])
        if group["momentum"] is not None:
            updates = _trace(updates, state["trace"], group["momentum"], group["nesterov"])
        return updates


class Adagrad(_Chain):
    """``chain(scale_by_rss, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["sum_of_squares"] = torch.full_like(p, group["initial_accumulator_value"])

    def _update(self, group, params, grads, state, count):
        sums = state["sum_of_squares"]
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        inv = [torch.where(t > 0, torch.rsqrt(t + group["eps"]), 0.0) for t in sums]
        return _lr_scaled(torch._foreach_mul(inv, grads), group["lr"])


class Yogi(_Chain):
    """``chain(scale_by_yogi, scale_by_learning_rate)`` (optax's
    ``scale_by_yogi`` defaults: initial accumulators 1e-6, eps_root 0)."""

    initial_accumulator_value = 1e-6

    def _init(self, group, p, st):
        st["mu"] = torch.full_like(p, self.initial_accumulator_value)
        st["nu"] = torch.full_like(p, self.initial_accumulator_value)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        mu, nu = state["mu"], state["nu"]
        _ema_(mu, grads, b1)
        g2 = torch._foreach_mul(grads, grads)
        sign = torch._foreach_sign(torch._foreach_sub(nu, g2))
        torch._foreach_sub_(nu, torch._foreach_mul(torch._foreach_mul(sign, 1.0 - b2), g2))
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, _bias_correction(b2, count)))
        torch._foreach_add_(den, group["eps"])
        return _lr_scaled(torch._foreach_div(mu_hat, den), group["lr"])


class Adan(_Chain):
    """``chain(scale_by_adan, add_decayed_weights, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        for k in ("m", "v", "n", "g"):
            st[k] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2, b3 = group["b1"], group["b2"], group["b3"]
        m, v, n, prev = state["m"], state["v"], state["n"], state["g"]
        diff = [torch.zeros_like(g) for g in grads] if count == 1 else torch._foreach_sub(grads, prev)
        _ema_(m, grads, b1)
        _ema_(v, diff, b2)
        sq = torch._foreach_add(grads, torch._foreach_mul(diff, 1.0 - b2))
        _ema_(n, sq, b3, 2)
        m_hat = torch._foreach_div(m, _bias_correction(b1, count))
        v_hat = torch._foreach_div(v, _bias_correction(b2, count))
        n_hat = torch._foreach_div(n, _bias_correction(b3, count))
        u = torch._foreach_add(m_hat, torch._foreach_mul(v_hat, 1.0 - b2))
        den = torch._foreach_sqrt(torch._foreach_add(n_hat, group["eps_root"]))
        torch._foreach_add_(den, group["eps"])
        u = torch._foreach_div(u, den)
        _store(prev, grads)
        if group["weight_decay"]:
            torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
        return _lr_scaled(u, group["lr"])


class Adadelta(_Chain):
    """``chain(add_decayed_weights, scale_by_adadelta, scale_by_learning_rate)``."""

    def _init(self, group, p, st):
        st["e_g"] = torch.zeros_like(p)
        st["e_x"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        rho, eps = group["rho"], group["eps"]
        g = torch._foreach_add(grads, torch._foreach_mul(params, group["weight_decay"])) \
            if group["weight_decay"] else grads
        _ema_(state["e_g"], g, rho, 2)
        num = torch._foreach_sqrt(torch._foreach_add(state["e_x"], eps))
        den = torch._foreach_sqrt(torch._foreach_add(state["e_g"], eps))
        updates = torch._foreach_mul(torch._foreach_div(num, den), g)
        _ema_(state["e_x"], updates, rho, 2)
        return _lr_scaled(updates, group["lr"])


class Rprop(_Chain):
    """``chain(scale_by_rprop, scale(−1))``; ``learning_rate`` is the initial
    step size, read at the first step."""

    def _init(self, group, p, st):
        st["step_sizes"] = torch.full_like(p, group["lr"])
        st["prev_updates"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        updates = []
        for g, step_size, prev in zip(grads, state["step_sizes"], state["prev_updates"]):
            s = g * prev
            grown = torch.clamp(step_size * torch.where(s > 0, group["eta_plus"], group["eta_minus"]),
                                min=group["min_step_size"], max=group["max_step_size"])
            step_size.copy_(torch.where(s == 0, step_size, grown))
            # the update is the step stored at the previous call (zero where the sign flipped)
            updates.append(-torch.where(s < 0, torch.zeros_like(prev), prev))
            prev.copy_(torch.where(s < 0, torch.zeros_like(g), step_size * torch.sign(g)))
        return updates


class SignSGD(_Chain):
    """``chain(scale_by_sign, scale_by_learning_rate)``."""

    def _update(self, group, params, grads, state, count):
        return _lr_scaled(torch._foreach_sign(grads), group["lr"])


# -- chains with a reduction over each leaf -------------------------------------


def _norm(t: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(t.float()).to(t.dtype)


def _trust_ratio(update: torch.Tensor, param: torch.Tensor, trust_coefficient: float = 1.0,
                 eps: float = 0.0) -> torch.Tensor:
    """optax ``scale_by_trust_ratio`` at min_norm 0 on one leaf."""
    p_norm, u_norm = _norm(param), _norm(update)
    ratio = trust_coefficient * p_norm / (u_norm + eps)
    return update * torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(ratio), ratio)


class Lamb(_Chain):
    """``chain(scale_by_adam, add_decayed_weights, scale_by_trust_ratio,
    scale_by_learning_rate)``."""

    elementwise = False

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        updates = []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            mu.mul_(b1).add_(g * (1.0 - b1))
            nu.mul_(b2).add_(g * g * (1.0 - b2))
            u = (mu / c1) / (torch.sqrt(nu / c2 + group["eps_root"]) + group["eps"])
            if group["weight_decay"]:
                u = u + group["weight_decay"] * p
            updates.append(_trust_ratio(u, p) * -group["lr"])
        return updates


class Lars(_Chain):
    """``chain(add_decayed_weights, scale_by_trust_ratio,
    scale_by_learning_rate, trace)``."""

    elementwise = False

    def _init(self, group, p, st):
        st["trace"] = torch.zeros_like(p)

    def _update(self, group, params, grads, state, count):
        updates = []
        for p, g in zip(params, grads):
            u = g + group["weight_decay"] * p if group["weight_decay"] else g
            updates.append(_trust_ratio(u, p, group["trust_coefficient"], group["eps"]) * -group["lr"])
        return _trace(updates, state["trace"], group["momentum"], group["nesterov"])


class Novograd(_Chain):
    """``chain(scale_by_novograd, scale_by_learning_rate)``: ν a per-leaf
    EMA of ‖g‖², μ ← b1·μ + g/(√(ν + eps_root) + eps) + wd·p (the first
    step takes ‖g‖² and the bare sum)."""

    elementwise = False

    def _init(self, group, p, st):
        st["mu"] = torch.zeros_like(p)
        st["nu"] = torch.zeros((), dtype=p.dtype, device=p.device)

    def _update(self, group, params, grads, state, count):
        b1, b2 = group["b1"], group["b2"]
        updates = []
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            sq = _norm(g) ** 2
            nu.copy_(sq if count == 1 else (1 - b2) * sq + b2 * nu)
            add = g / (torch.sqrt(nu + group["eps_root"]) + group["eps"]) + group["weight_decay"] * p
            mu.copy_(add if count == 1 else b1 * mu + add)
            updates.append(mu * -group["lr"])
        return updates


def _factored_dims(param: torch.Tensor, factored: bool, min_dim: int) -> Optional[tuple[int, int]]:
    """optax ``_factored_dims`` on the leaf's JAX layout, as torch axes."""
    if not factored or param.ndim < 2:
        return None
    to_torch = getattr(param, "jax_layout", None) or tuple(range(param.ndim))
    jax_shape = tuple(param.shape[a] for a in to_torch)
    order = np.argsort(jax_shape)
    if jax_shape[order[-2]] < min_dim:
        return None
    return to_torch[int(order[-2])], to_torch[int(order[-1])]


class OptaxAdafactor(_Chain):
    """optax.adafactor's chain: ``scale_by_factored_rms``,
    ``clip_by_block_rms``, ``scale_by_learning_rate`` (unflipped),
    ``scale_by_param_block_rms``, ``ema`` (undebiased), ``add_decayed_weights``,
    ``scale(−1)``. Factored over the two largest axes of the JAX layout."""

    elementwise = False

    def _init(self, group, p, st):
        dims = _factored_dims(p, group["factored"], group["min_dim_size_to_factor"])
        if dims is not None:
            d1, d0 = dims
            st["v_row"] = torch.zeros_like(p.sum(dim=d0))
            st["v_col"] = torch.zeros_like(p.sum(dim=d1))
        else:
            st["v"] = torch.zeros_like(p)
        if group["momentum"] is not None:
            st["ema"] = torch.zeros_like(p, dtype=group["dtype_momentum"])

    def _update(self, group, params, grads, state, count):
        # optax _decay_rate_pow(count − offset): 1 − (i+1)^−rate, in fp32
        decay_t = 1.0 - _f32(count - group["decay_offset"]) ** (-_f32(group["decay_rate"]))
        decay, rest = float(decay_t), float(1.0 - decay_t)
        updates = []
        for p, g in zip(params, grads):
            st = self.state[p]
            g2 = g * g + group["eps"]
            dims = _factored_dims(p, group["factored"], group["min_dim_size_to_factor"])
            if dims is not None:
                d1, d0 = dims
                v_row = st["v_row"].mul_(decay).add_(rest * g2.mean(dim=d0))
                v_col = st["v_col"].mul_(decay).add_(rest * g2.mean(dim=d1))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = st["v"].mul_(decay).add_(rest * g2)
                u = g * v ** -0.5
            if group["clipping_threshold"] is not None:
                u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / group["clipping_threshold"], 1.0)
            if group["lr"] is not None:
                u = u * group["lr"]
            if group["multiply_by_parameter_scale"]:
                u = u * torch.clamp_min(torch.sqrt(torch.mean(p * p)), 1e-3)
            if group["momentum"] is not None:
                m = group["momentum"]
                new = (1.0 - m) * u + st["ema"].to(u.dtype) * torch.tensor(m, dtype=st["ema"].dtype).item()
                st["ema"].copy_(new)
                u = new
            if group["weight_decay_rate"] is not None:
                u = u + group["weight_decay_rate"] * p
            updates.append(-u)
        return updates


# -- optax's signatures ----------------------------------------------------------


def lion(params, learning_rate: float, b1: float = 0.9, b2: float = 0.99, mu_dtype: DtypeLike = None,
         weight_decay: float = 1e-3) -> Lion:
    return Lion(params, learning_rate, b1=b1, b2=b2, mu_dtype=as_dtype(mu_dtype), weight_decay=weight_decay)


def lamb(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
         eps_root: float = 0.0, weight_decay: float = 0.0) -> Lamb:
    return Lamb(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)


def adafactor(params, learning_rate: Optional[float] = None, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, decay_offset: int = 0, multiply_by_parameter_scale: float = True,
              clipping_threshold: Optional[float] = 1.0, momentum: Optional[float] = None,
              dtype_momentum: DtypeLike = "float32", weight_decay_rate: Optional[float] = None,
              eps: float = 1e-30, factored: bool = True) -> OptaxAdafactor:
    return OptaxAdafactor(params, learning_rate, min_dim_size_to_factor=min_dim_size_to_factor,
                          decay_rate=decay_rate, decay_offset=decay_offset,
                          multiply_by_parameter_scale=multiply_by_parameter_scale,
                          clipping_threshold=clipping_threshold, momentum=momentum,
                          dtype_momentum=as_dtype(dtype_momentum), weight_decay_rate=weight_decay_rate, eps=eps,
                          factored=factored)


def nadamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
           eps_root: float = 0.0, mu_dtype: DtypeLike = None, weight_decay: float = 1e-4, *,
           nesterov: bool = True) -> OptaxAdam:
    return OptaxAdam(params, learning_rate, b1, b2, eps, eps_root, weight_decay, mu_dtype, nesterov)


def nadam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, mu_dtype: DtypeLike = None, *, nesterov: bool = True) -> OptaxAdam:
    return OptaxAdam(params, learning_rate, b1, b2, eps, eps_root, 0.0, mu_dtype, nesterov)


def radam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, threshold: float = 5.0, *, nesterov: bool = False) -> RAdam:
    return RAdam(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, threshold=threshold,
                 nesterov=nesterov)


def amsgrad(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            eps_root: float = 0.0, mu_dtype: DtypeLike = None) -> AMSGrad:
    return AMSGrad(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, mu_dtype=as_dtype(mu_dtype))


def adamax(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Adamax:
    return Adamax(params, learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=0.0)


def adamaxw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
            weight_decay: float = 1e-4) -> Adamax:
    return Adamax(params, learning_rate, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)


def adabelief(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-16,
              eps_root: float = 1e-16, *, nesterov: bool = False) -> AdaBelief:
    return AdaBelief(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, nesterov=nesterov)


def rmsprop(params, learning_rate: float, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
            eps_in_sqrt: bool = True, centered: bool = False, momentum: Optional[float] = None,
            nesterov: bool = False, bias_correction: bool = False) -> RMSProp:
    return RMSProp(params, learning_rate, decay=decay, eps=eps, initial_scale=initial_scale, eps_in_sqrt=eps_in_sqrt,
                   centered=centered, momentum=momentum, nesterov=nesterov, bias_correction=bias_correction)


def adagrad(params, learning_rate: float, initial_accumulator_value: float = 0.1, eps: float = 1e-7) -> Adagrad:
    return Adagrad(params, learning_rate, initial_accumulator_value=initial_accumulator_value, eps=eps)


def yogi(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-3) -> Yogi:
    return Yogi(params, learning_rate, b1=b1, b2=b2, eps=eps)


def novograd(params, learning_rate: float, b1: float = 0.9, b2: float = 0.25, eps: float = 1e-6,
             eps_root: float = 0.0, weight_decay: float = 0.0) -> Novograd:
    return Novograd(params, learning_rate, b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)


def adan(params, learning_rate: float, b1: float = 0.98, b2: float = 0.92, b3: float = 0.99, eps: float = 1e-8,
         eps_root: float = 1e-8, weight_decay: float = 0.0) -> Adan:
    return Adan(params, learning_rate, b1=b1, b2=b2, b3=b3, eps=eps, eps_root=eps_root, weight_decay=weight_decay)


def adadelta(params, learning_rate: Optional[float] = None, rho: float = 0.9, eps: float = 1e-6,
             weight_decay: float = 0.0) -> Adadelta:
    return Adadelta(params, learning_rate, rho=rho, eps=eps, weight_decay=weight_decay)


def rprop(params, learning_rate: float, eta_minus: float = 0.5, eta_plus: float = 1.2, min_step_size: float = 1e-6,
          max_step_size: float = 50.0) -> Rprop:
    return Rprop(params, learning_rate, eta_minus=eta_minus, eta_plus=eta_plus, min_step_size=min_step_size,
                 max_step_size=max_step_size)


def sign_sgd(params, learning_rate: float) -> SignSGD:
    return SignSGD(params, learning_rate)


def lars(params, learning_rate: float, weight_decay: float = 0.0, trust_coefficient: float = 0.001,
         eps: float = 0.0, momentum: float = 0.9, nesterov: bool = False) -> Lars:
    return Lars(params, learning_rate, weight_decay=weight_decay, trust_coefficient=trust_coefficient, eps=eps,
                momentum=momentum, nesterov=nesterov)

