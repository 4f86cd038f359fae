"""The port's LR schedules (neurosis_tpu_torch/schedulers) against the JAX
package's (neurosis_tpu/schedulers), and their composition with a torch
optimizer (``attach_schedule``) against the JAX builder's.

Each of the ten schedules of the registry, built from its reference class
path in both registries, gives JAX's value at every step 0-300, exactly in
float64; the legacy cosine with restarts at cycle_mult 1.0 and 1.5.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from torch_parity import one_torch_thread  # noqa: E402,F401

WARM = dict(warm_up_steps=[10, 20], f_min=[0.1, 0.05], f_max=[1.0, 0.5], f_start=[0.0, 0.1],
            cycle_lengths=[100, 200])
SCHEDULES = [
    ("CosineWithWarmUp", dict(num_warmup_steps=25, num_training_steps=300, num_cycles=0.5)),
    ("CosineWithHardRestartsAndWarmUp", dict(num_warmup_steps=25, num_training_steps=300, num_cycles=3)),
    ("LambdaWarmUpCosineScheduler2", WARM),
    ("LambdaLinearScheduler", WARM),
    ("CosineAnnealingWarmupRestarts", dict(warm_up_steps=25, cycle_steps=50, lr_min=1e-6, lr_max=1e-3,
                                           lr_start=1e-5, decay_factor=0.9)),
    ("CosineDecayWithWarmup", dict(warmup_steps=25, total_steps=300, lr_min=0.01, lr_max=1.0)),
    ("CosineWarmupSchedule", dict(warm_up_steps=25, max_decay_steps=300, lr_min=1e-6, lr_max=1e-3, lr_start=1e-5)),
    ("CosineWarmupStagedSchedule", WARM),
    ("LinearWarmupSchedule", WARM),
    *[("LegacyCosineAnnealingWarmupRestarts", dict(first_cycle_steps=50, cycle_mult=mult, min_lr=3e-7,
                                                   warm_up_steps=25, gamma=0.9)) for mult in (1.0, 1.5)],
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedules_equal_jax(name, args):
    from neurosis_tpu.config.registry import resolve_class_path as jax_resolve

    from neurosis_tpu_torch.config.registry import resolve_class_path

    path = "neurosis.schedulers." + name
    got, want = resolve_class_path(path)(**args), jax_resolve(path)(**args)
    assert resolve_class_path(path).__module__ == "neurosis_tpu_torch.schedulers.schedules"
    values = [float(got(step)) for step in range(301)]
    assert values == [float(want(step)) for step in range(301)]
    assert len(set(values)) > 10  # the schedule moves over the range


def test_attach_schedule_counts_updates_as_optax_and_resumes():
    """The lr of update k is base × sched(k) (optax's count: the first update
    uses sched(0)); each group keeps its own base; the count and lr travel in
    the optimizer's state_dict, so a resumed optimizer continues the schedule."""
    from neurosis_tpu_torch.schedulers import attach_schedule, legacy_cosine_annealing_warmup_restarts

    sched = legacy_cosine_annealing_warmup_restarts(first_cycle_steps=50, min_lr=3e-7, warm_up_steps=25)

    def make():
        ps = [torch.nn.Parameter(torch.zeros(3)), torch.nn.Parameter(torch.zeros(2))]
        return ps, attach_schedule(torch.optim.SGD([{"params": ps[:1]}, {"params": ps[1:], "lr": 2e-5}], lr=3e-5),
                                   sched)

    ps, opt = make()
    used = []
    for _ in range(4):
        used.append([g["lr"] for g in opt.param_groups])
        for p in ps:
            p.grad = torch.ones_like(p)
        opt.step()
    assert used == [[3e-5 * sched(k), 2e-5 * sched(k)] for k in range(4)]
    assert used[0][0] == 3e-5 * 3e-7  # the config's min_lr as the first multiplier, as in JAX
    ps2, opt2 = make()
    opt2.load_state_dict(opt.state_dict())
    assert [(g["schedule_count"], g["lr"]) for g in opt2.param_groups] == [(4, 3e-5 * sched(4)), (4, 2e-5 * sched(4))]
    for p in ps2:
        p.grad = torch.ones_like(p)
    opt2.step()
    assert opt2.param_groups[0]["lr"] == 3e-5 * sched(5)


def test_builder_schedule_equals_jax_builders_learning_rate():
    """build_optimizer's lr at each count equals the learning rate the JAX
    builder feeds optax (base_lr × sched(count)); AdafactorScheduler composes
    nothing in either."""
    from neurosis_tpu.trainer import builder as jax_builder

    from neurosis_tpu_torch.optimizers.adamw8bit import AdamW8bit
    from neurosis_tpu_torch.trainer.builder import build_optimizer

    opt_node = {"class_path": "bitsandbytes.optim.AdamW8bit", "init_args": {"lr": 3e-5, "weight_decay": 0.0}}
    sched_node = {"class_path": "neurosis.schedulers.LegacyCosineAnnealingWarmupRestarts",
                  "init_args": dict(first_cycle_steps=50, cycle_mult=1.0, min_lr=3e-7, warm_up_steps=25, gamma=0.9)}
    captured = {}
    real = jax_builder.resolve_class_path

    def spy(path):
        fn = real(path)
        if path == "bitsandbytes.optim.AdamW8bit":
            def wrapped(**kw):
                captured.update(kw)
                return fn(**kw)
            return wrapped
        return fn

    jax_builder.resolve_class_path = spy
    try:
        jax_builder.build_optimizer(dict(opt_node, stacked=False), sched_node)
    finally:
        jax_builder.resolve_class_path = real
    p = torch.nn.Parameter(torch.zeros(8))
    opt = build_optimizer(opt_node, sched_node)([p])
    assert isinstance(opt, AdamW8bit)
    for count in range(60):
        assert opt.param_groups[0]["lr"] == captured["learning_rate"](count), count
        p.grad = torch.ones_like(p)
        opt.step()
    opt = build_optimizer({"class_path": "neurosis.optimizers.Adafactor", "init_args": {"scale_parameter": True}},
                          {"class_path": "neurosis.optimizers.AdafactorScheduler"})([p])
    assert "schedule_count" not in opt.param_groups[0] and opt.param_groups[0]["lr"] is None
