"""The profiler (port of neurosis_tpu/trainer/profile.py; parity:
trainer/profile/profiler.py:31-299 NeurosisProfiler), on ``torch.profiler``.

A step-windowed schedule (skip_first / wait / warmup / active / repeat, JAX's
``phase``) starts and stops ``torch.profiler.profile``: CUDA and CPU
activity on the card (the CPU ops say which module launched each kernel),
CPU only on the CPU. Each active window writes torch's Chrome-trace JSON
(``trace.json``) into an auto-numbered ``run_NNN`` directory under
``dirpath``. ``summary()`` is JAX's table: device time by op name, and by
module when ``record_module_names`` spans (``utils/profiling.py``) were on.

A kernel's module is the innermost ``[mod]`` range around the CPU op that
launched it (JAX's ``_mod_key`` takes the innermost ``[mod]`` scope of an
op's ``tf_op``); a backward op's is its forward op's (the same autograd
sequence number), as XLA keeps a transposed op's scope. Device time that no
CPU op claims, and ops outside every span, fall under "(no module span)".
On the CPU an op's device time is its self CPU time.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import torch

from ..utils.profiling import record_module_names

__all__ = ["ProfilerSchedule", "NeurosisProfiler", "record_module_names"]

logger = logging.getLogger(__name__)

NO_SPAN = "(no module span)"
TRACE_FILE = "trace.json"


@dataclasses.dataclass
class ProfilerSchedule:
    """Step windows (profiler.py:31-56)."""

    skip_first: int = 1
    wait: int = 0
    warmup: int = 1
    active: int = 3
    repeat: int = 1

    def phase(self, step: int) -> str:
        if step < self.skip_first:
            return "skip"
        s = step - self.skip_first
        cycle = self.wait + self.warmup + self.active
        if self.repeat > 0 and s >= cycle * self.repeat:
            return "done"
        pos = s % cycle
        if pos < self.wait:
            return "wait"
        if pos < self.wait + self.warmup:
            return "warmup"
        return "active"


def _mod_key(event) -> Optional[str]:
    """The innermost "[mod]path(Class)" range around a CPU event, if any."""
    while event is not None:
        if event.name.startswith("[mod]"):
            return event.name[len("[mod]"):]
        event = event.cpu_parent
    return None


def _backward_sequence(event) -> Optional[int]:
    """The autograd sequence number of the backward function around ``event``."""
    while event is not None:
        if event.name.startswith("autograd::engine::evaluate_function") and event.sequence_nr >= 0:
            return event.sequence_nr
        event = event.cpu_parent
    return None


def module_resolver(events):
    """A function of a CPU event of ``events`` that gives its module: the
    innermost "[mod]" range around it, or for an op of a backward function
    the range of the forward op with its autograd sequence number, else
    NO_SPAN."""
    forward_mod = {}  # sequence number -> module of the forward op that recorded it
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU and e.sequence_nr >= 0 \
                and not e.name.startswith("autograd::") and e.sequence_nr not in forward_mod:
            key = _mod_key(e)
            if key is not None:
                forward_mod[e.sequence_nr] = key

    def module_of(e) -> str:
        key = _mod_key(e)
        if key is None:
            seq = _backward_sequence(e)
            key = forward_mod.get(seq) if seq is not None else None
        return key or NO_SPAN

    return module_of


def aggregate(events, cuda: bool) -> dict:
    """{"op": rows, "module": rows} of a profile's ``events()``; a row is
    {key, count, device_time_us, avg_us}, sorted by device time."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    module_of = module_resolver(cpu)
    by_op, by_mod = {}, {}

    def add(rows, key, us, n=1):
        r = rows.setdefault(key, [0, 0.0])
        r[0] += n
        r[1] += us

    if cuda:
        for e in events:  # kernels and copies; the device's copies of the host's ranges are no work
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation:
                add(by_op, e.name, e.time_range.elapsed_us())
        claimed = [0, 0.0]
        for e in cpu:
            for k in e.kernels:
                add(by_mod, module_of(e), k.duration)
                claimed[0] += 1
                claimed[1] += k.duration
        total = [sum(r[0] for r in by_op.values()), sum(r[1] for r in by_op.values())]
        if total[0] > claimed[0]:
            add(by_mod, NO_SPAN, max(total[1] - claimed[1], 0.0), total[0] - claimed[0])
    else:
        for e in cpu:
            if e.is_user_annotation or e.name.startswith("[mod]") or e.is_async:
                continue
            add(by_op, e.name, e.self_cpu_time_total)
            add(by_mod, module_of(e), e.self_cpu_time_total)

    def rows(table):
        return sorted(({"key": k, "count": c, "device_time_us": us, "avg_us": us / max(c, 1)}
                       for k, (c, us) in table.items()), key=lambda r: -r["device_time_us"])

    return {"op": rows(by_op), "module": rows(by_mod)}


class NeurosisProfiler:
    """Step-driven torch.profiler wrapper; call ``step()`` once a train step
    (the trainer's ``on_train_batch_end``). It traces the ``active`` steps
    after the warmup into auto-numbered run directories. With
    ``record_module_names`` the trainer runs the fit inside
    ``utils/profiling.record_module_names(capture_depth)``. ``device``: the
    run's device (default: the trainer's at the first step, else CUDA)."""

    def __init__(self, dirpath: str = "./profiles", schedule: Optional[ProfilerSchedule] = None,
                 record_module_names: bool = True, capture_depth: int = -1, row_limit: int = 25,
                 device=None):
        self.schedule = schedule or ProfilerSchedule()
        self.base_dir = Path(dirpath)
        self.record_module_names = record_module_names
        self.capture_depth = capture_depth
        self.row_limit = row_limit
        self.device = None if device is None else torch.device(device)
        self._prof = None
        self._step = 0
        self._rows: dict = {}
        self.trace_dir: Optional[Path] = None

    @property
    def _cuda(self) -> bool:
        return (self.device or torch.device("cuda")).type == "cuda"

    def _next_dir(self) -> Path:
        self.base_dir.mkdir(parents=True, exist_ok=True)
        n = 0
        while (self.base_dir / f"run_{n:03d}").exists():
            n += 1
        d = self.base_dir / f"run_{n:03d}"
        d.mkdir()
        return d

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        self.trace_dir = self._next_dir()
        self._prof = profile(activities=activities)
        self._prof.start()
        logger.info(f"profiler: tracing → {self.trace_dir}")

    def step(self) -> None:
        phase = self.schedule.phase(self._step)
        if phase == "active" and self._prof is None:
            self._start()
        elif phase in ("done", "wait", "skip") and self._prof is not None:
            self.stop()
        self._step += 1

    def stop(self) -> None:
        """End an open trace: write it, and keep its rows for the summary."""
        if self._prof is None:
            return
        if self._cuda:
            torch.cuda.synchronize(self.device)
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(str(self.trace_dir / TRACE_FILE))
        self._rows = aggregate(prof.events(), self._cuda)
        logger.info(f"profiler: trace stopped, {self.trace_dir / TRACE_FILE}")

    # -- summary (profiler.py:177-188 key_averages().table() parity) --------

    def key_averages(self, by: str = "op") -> list[dict]:
        """The last trace's rows: by="op", one a kernel (op on the CPU) name;
        by="module", one an innermost "[mod]path(Class)" span. Rows:
        {key, count, device_time_us, avg_us}, sorted by device time."""
        return list(self._rows.get(by, []))

    def summary(self) -> str:
        """Device-time-sorted key-average table (``row_limit`` rows), by op,
        then by module span when there are "[mod]" spans."""
        self.stop()
        sections = []
        for by, title in (("op", "op key averages"), ("module", "module spans")):
            rows = self.key_averages(by=by)
            if by == "module" and (not rows or all(r["key"] == NO_SPAN for r in rows)):
                continue
            total = sum(r["device_time_us"] for r in rows) or 1.0
            width = max([len(r["key"][:60]) for r in rows[: self.row_limit]] + [len(title)])
            lines = [
                f"-- {title} " + "-" * max(0, 76 - len(title)),
                f"{'name'.ljust(width)}  {'count':>6}  {'total us':>12}  {'avg us':>10}  {'%':>6}",
            ]
            for r in rows[: self.row_limit]:
                lines.append(
                    f"{r['key'][:60].ljust(width)}  {r['count']:>6}  "
                    f"{r['device_time_us']:>12.1f}  {r['avg_us']:>10.1f}  "
                    f"{100.0 * r['device_time_us'] / total:>5.1f}%"
                )
            sections.append("\n".join(lines))
        return "\n".join(sections)

    # trainer-callback interface
    def on_train_batch_end(self, trainer, state, batch, metrics, step: int):
        if self.device is None:
            self.device = trainer.device
        self.step()

    def on_fit_end(self, trainer, state):
        self.stop()
        table = self.summary()
        if table:
            logger.info("profiler summary:\n%s", table)
