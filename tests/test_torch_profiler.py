"""The port's profiler on the CPU: ``ProfilerSchedule.phase`` against
JAX's over a grid of settings, ``record_module_names``' "[mod]path(Class)"
ranges (labels, depth, unchanged results), the module attribution of
``aggregate`` (an op to its innermost range, a backward op to its forward
op's), and a CPU fit of configs/smoke/vae-tiny.yaml with a
``trainer.profiler:`` node, which writes ``run_000/trace.json`` with the
spans and a summary with a module section.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch import nn  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
VAE_TINY = ROOT / "configs" / "smoke" / "vae-tiny.yaml"


def test_schedule_phases_match_jax():
    pytest.importorskip("jax")
    from neurosis_tpu.trainer.profile import ProfilerSchedule as JaxSchedule
    from neurosis_tpu_torch.trainer.profile import ProfilerSchedule

    for skip, wait, warm, active, repeat in itertools.product((0, 1, 3), (0, 2), (0, 1), (1, 3), (0, 1, 2)):
        args = dict(skip_first=skip, wait=wait, warmup=warm, active=active, repeat=repeat)
        ours, theirs = ProfilerSchedule(**args), JaxSchedule(**args)
        assert [ours.phase(i) for i in range(24)] == [theirs.phase(i) for i in range(24)], args
    assert [ProfilerSchedule(1, 1, 1, 2, 1).phase(i) for i in range(6)] == \
        ["skip", "wait", "warmup", "active", "active", "done"]


class Block(nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = nn.Linear(16, 16)
        self.out = nn.Linear(16, 16)

    def forward(self, x):
        return self.out(torch.nn.functional.silu(self.inner(x)))


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = nn.ModuleList(Block() for _ in range(2))

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        return x


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_record_module_names_spans_and_depth():
    from neurosis_tpu_torch.utils.profiling import record_module_names

    torch.manual_seed(0)
    net, x = Net(), torch.randn(4, 16)
    with record_module_names():
        y, prof = _profiled(lambda: net(x))
    names = {e.name for e in prof.events()}
    assert {"[mod]Net(Net)", "[mod]blocks.0(Block)", "[mod]blocks.1.inner(Linear)"} <= names
    with record_module_names(max_depth=2):
        _, prof = _profiled(lambda: net(x))
    names = {e.name for e in prof.events()}
    assert "[mod]blocks.0(Block)" in names and not any(n.startswith("[mod]blocks.0.inner") for n in names)
    assert torch.equal(y, net(x))  # spans change no result
    _, prof = _profiled(lambda: net(x))  # hooks gone after the context
    assert not any(e.name.startswith("[mod]") for e in prof.events())


def test_module_rows_take_ops_and_their_backward():
    from neurosis_tpu_torch.trainer.profile import NO_SPAN, aggregate
    from neurosis_tpu_torch.utils.profiling import record_module_names

    torch.manual_seed(0)
    net, x = Net(), torch.randn(64, 16)

    def step():
        net(x).square().mean().backward()

    with record_module_names():
        _, prof = _profiled(step)
    rows = aggregate(prof.events(), cuda=False)
    by_mod = {r["key"]: r for r in rows["module"]}
    for i in range(2):
        assert by_mod[f"blocks.{i}.inner(Linear)"]["device_time_us"] > 0
    # the backward of a Linear (AddmmBackward0's mm ops) counts under the Linear's span
    events = [e for e in prof.events() if e.name.startswith("autograd::engine::evaluate_function: AddmmBackward")]
    assert events
    ops = {r["key"] for r in rows["op"]}
    assert "aten::addmm" in ops and "aten::mm" in ops and not any(k.startswith("[mod]") for k in ops)
    assert sum(r["count"] for r in rows["op"]) == sum(r["count"] for r in rows["module"])
    assert NO_SPAN in by_mod  # the loss's ops run outside every module
    total = sum(r["device_time_us"] for r in rows["module"])
    traced = sum(r["device_time_us"] for k, r in by_mod.items() if k != NO_SPAN)
    assert traced / total > 0.3


def test_profiler_windows_and_run_dirs(tmp_path):
    from neurosis_tpu_torch.trainer.profile import NeurosisProfiler, ProfilerSchedule

    prof = NeurosisProfiler(str(tmp_path), ProfilerSchedule(skip_first=0, wait=1, warmup=1, active=2, repeat=2),
                            device="cpu")  # a trace ends at a wait (or done), as JAX's does
    net, x = Net(), torch.randn(8, 16)
    for _ in range(10):
        net(x)
        prof.step()
    prof.stop()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["run_000", "run_001"]
    assert prof.trace_dir == tmp_path / "run_001"
    trace = json.loads((prof.trace_dir / "trace.json").read_text())
    assert any(e.get("name") == "aten::addmm" for e in trace["traceEvents"])
    assert prof.key_averages("op")[0]["device_time_us"] >= prof.key_averages("op")[-1]["device_time_us"]
    assert "op key averages" in prof.summary()


def test_cli_fit_with_a_profiler_on_the_cpu(tmp_path, monkeypatch, caplog):
    """vae-tiny.yaml for 3 steps with trainer.profiler: (skip 1, active 1):
    the third step is traced into run_000 with its module spans; the
    summary has a module section."""
    import logging

    from neurosis_tpu_torch.data.png import write_png
    from neurosis_tpu_torch.trainer.cli import main

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(data / f"img_{i}.png", (rng.rand(64, 72, 3) * 255).astype(np.uint8))
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(data))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    prof_dir = tmp_path / "profiles"
    text = VAE_TINY.read_text().replace("  fast_dev_run: true\n", (
        "  fast_dev_run: false\n  max_steps: 3\n  profiler:\n    init_args:\n"
        f"      dirpath: {prof_dir}\n      schedule:\n        skip_first: 1\n        warmup: 0\n"
        "        active: 1\n")).replace("  max_steps: 1\n", "", 1)
    (tmp_path / "vae.yaml").write_text(text)
    caplog.set_level(logging.INFO)
    assert main(["fit", "-c", str(tmp_path / "vae.yaml"), "--device", "cpu"]) == 0
    trace = json.loads((prof_dir / "run_000" / "trace.json").read_text())
    spans = {e.get("name", "") for e in trace["traceEvents"]}
    assert "[mod]Encoder(Encoder)" in spans and "[mod]Decoder(Decoder)" in spans
    assert any(s.startswith("[mod]mid.block_1") for s in spans)
    assert not (prof_dir / "run_001").exists()
    summary = caplog.text[caplog.text.index("profiler summary"):]
    assert "module spans" in summary and "mid.attn_1(VAEAttnBlock)" in summary
