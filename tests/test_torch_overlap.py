"""The port of the flash-overlap experiment on the CPU: the plain version of
the split2 and chunked kernels against the Pallas kernels of
tools/overlap_bench.py (loaded by path, run in interpret mode), and the
port's tool against the TPU tool's case list.

fp32 inputs hold the algorithm at the JAX suite's forward tolerance (atol
3e-6, rtol 1e-4, tests/test_flash_attention.py); bf16 inputs, as the tool runs
them, at 2e-2 of the largest value (P and the output are rounded to bf16 on
both sides, at sums taken in another order).
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import rel_err  # noqa: E402

TOOL = Path(__file__).resolve().parents[1] / "tools" / "overlap_bench.py"


@pytest.fixture()
def tpu_tool(monkeypatch, tmp_path):
    """tools/overlap_bench.py as a module, its pallas_calls interpreted; its
    import-time compile-cache set-up is pointed at a temporary HOME and
    leaves the process's jax config alone."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location("tpu_overlap_bench", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    orig = tool.pl.pallas_call

    def interp(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(tool.pl, "pallas_call", interp)
    return tool


def _inputs(seed, b, h, sq, skv, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, sq, d).astype(np.float32), rng.randn(b, h, skv, d).astype(np.float32),
            rng.randn(b, h, skv, d).astype(np.float32))


def _port_fwd(variant, chunks, arrays, dtype):
    from neurosis_tpu_torch.tools.overlap_bench import variant_fwd

    q, k, v = (torch.tensor(a.copy()).to(dtype) for a in arrays)
    return variant_fwd(variant, chunks)(q, k, v).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split2_plain_matches_the_tpu_kernel(tpu_tool, dtype):
    arrays = _inputs(0, 1, 2, 256, 128)
    want = tpu_tool.split2_fwd(*(jnp.asarray(a.copy(), dtype) for a in arrays), 128)
    got = _port_fwd("split2", 2, arrays, getattr(torch, dtype))
    if dtype == "float32":
        np.testing.assert_allclose(got, np.asarray(want), atol=3e-6, rtol=1e-4)
    else:
        assert rel_err(got, np.asarray(want, np.float32)) < 2e-2


@pytest.mark.parametrize("n_chunks", [1, 2, 4, 8])
def test_chunked_plain_matches_the_tpu_kernel(tpu_tool, n_chunks):
    arrays = _inputs(n_chunks, 2, 1, 128, 256)
    want = tpu_tool.chunked_fwd(*(jnp.asarray(a.copy()) for a in arrays), 128, n_chunks)
    got = _port_fwd("chunked", n_chunks, arrays, torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-6, rtol=1e-4)
    # and the unchunked softmax: the chunk count changes the order of sums only
    from neurosis_tpu_torch.ops.flash_attention import LOG2_E, flash_fwd_plain

    q, k, v = (torch.tensor(a.copy()) for a in arrays)
    ref = flash_fwd_plain(q * (LOG2_E / 8.0), k, v)[0].numpy()
    np.testing.assert_allclose(got, ref, atol=3e-6, rtol=1e-4)


def test_ragged_chunks_raise():
    from neurosis_tpu_torch.ops.flash_overlap import flash_fwd_chunked, flash_fwd_split2

    q, kv = torch.zeros(1, 1, 64, 64), torch.zeros(1, 1, 77, 64)
    with pytest.raises(ValueError, match="no multiple"):
        flash_fwd_split2(q, kv, kv)
    with pytest.raises(ValueError, match="no multiple"):
        flash_fwd_chunked(q, kv, kv, 4)
    with pytest.raises(ValueError, match="no multiple"):
        flash_fwd_chunked(q, kv, kv, 0)
    assert flash_fwd_chunked(q, kv, kv, 7).shape == q.shape


def test_tool_keeps_the_tpu_tools_cases():
    """Labels and shapes of tools/overlap_bench.py:192-208, in order; the
    variant and chunk count of each follow from its call."""
    from neurosis_tpu_torch.tools.overlap_bench import CASES

    src = TOOL.read_text()
    rows = re.findall(r'\("([^"]+)", lambda q, k, v: (\w+)_fwd\(q, k, v, ([\d, ]+)\), (\d+), (\d+), (\d+), (\d+)\)', src)
    assert len(rows) == len(CASES) == 14
    for (label, kind, args, sq, skv, b, h), case in zip(rows, CASES):
        args = [int(a) for a in args.split(",")]
        chunks = {"base": 1, "split2": 2, "chunked": args[-1]}[kind]
        assert case == (label, kind, chunks, int(sq), int(skv), int(b), int(h))
        assert int(skv) % chunks == 0


def test_tool_checks_on_the_cpu_and_times_only_on_the_card(monkeypatch):
    from neurosis_tpu_torch.tools import overlap_bench as ob

    err = ob.check(ob.variant_fwd("base", 1), ob.variant_fwd("split2", 2), 128, 128, 1, 2, device="cpu")
    assert err < 2e-2  # bf16 outputs of values up to ~3: one rounding step apart at most
    with pytest.raises(RuntimeError, match="CUDA card"):
        ob.bench(ob.variant_fwd("base", 1), 64, 64, 1, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ob.main()
