"""The port's loss-curve check (neurosis_tpu_torch/tools/loss_curve.py)
against tools/loss_curve_stat.py and the JAX package.

- Its constants, σ table, and data and σ/noise streams are the tool's at
  the tool's 16×16, for 5 steps and two seeds.
- Its ``analyze`` gives the tool's report on the archived curves
  (projects/loss_curve/*.json).
- At tests/test_loss_curve_parity.py's tiny UNet, 5 fp32 steps of the
  port's arm match JAX's (tests/torch_loss_curve_jax.py) from the same
  numpy init, within that file's rtol 2e-3, atol 2e-4.
- chip_smoke.py phase 21's launch tables, on meta tensors.
- ``slow``: the JAX curve remade (seeds 0 and 1, 200 steps at 32×32, about
  an hour on 8 cores) holds the committed curve within the tool's rule.
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from torch_parity import one_torch_thread  # noqa: E402,F401
from torch_loss_curve_jax import run_jax  # noqa: E402

from neurosis_tpu_torch.tools import loss_curve as lc  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TINY_CFG = dict(in_channels=4, model_channels=32, out_channels=4, num_res_blocks=1, attention_resolutions=[2],
                channel_mult=[1, 2], num_heads=2, transformer_depth=1, context_dim=24)


def _tool():
    spec = importlib.util.spec_from_file_location("loss_curve_stat", ROOT / "tools" / "loss_curve_stat.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_streams_are_the_tool_s():
    tool = _tool()
    assert (lc.CFG, lc.BATCH, lc.LR, lc.DATA_SEED) == (tool.CFG, tool.BATCH, tool.LR, tool.DATA_SEED)
    sigmas = lc.ddpm_sigmas()
    np.testing.assert_array_equal(sigmas, tool.ddpm_sigmas())
    for (x, c), (tx, tc) in zip(lc.data_stream(5, res=tool.RES), tool.data_stream(5)):
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(c, tc)
    for seed in (0, 1):
        for (s, n), (ts, tn) in zip(lc.sigma_noise_stream(5, seed, sigmas, res=tool.RES),
                                    tool.sigma_noise_stream(5, seed, tool.ddpm_sigmas())):
            np.testing.assert_array_equal(s, ts)
            np.testing.assert_array_equal(n, tn)


def test_analyze_gives_the_tool_s_report():
    tool = _tool()
    paths = sorted(str(p) for p in (ROOT / "projects" / "loss_curve").glob("*_seed*.json"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = tool.analyze(paths)
    runs = [json.loads(Path(p).read_text()) for p in paths]
    report = lc.analyze(runs)
    assert json.loads(json.dumps(report)) == json.loads(out.getvalue())
    assert code == 0 and all(c["pass"] for c in report["checks"]) and len(report["checks"]) == 2


def test_the_port_s_arm_matches_jax_s_from_the_numpy_init():
    model, checksum = lc.build_unet(None, "cpu", TINY_CFG)
    got = lc.train(model, 5, seed=0, res=16, context_dim=TINY_CFG["context_dim"], lr=1e-3)
    want = run_jax(5, 0, 16, "fp32", cfg=TINY_CFG, lr=1e-3)
    assert want["init_checksum"] == checksum
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"], rtol=2e-3, atol=2e-4)
    assert got["losses"][-1] < got["losses"][0]


@pytest.mark.slow
def test_a_remade_jax_curve_holds_the_committed_one():
    committed = json.loads(Path(lc.JAX_CURVE).read_text())
    runs = []
    for seed in (0, 1):
        run = run_jax(committed["steps"], seed, committed["res"], committed["dtype"])
        assert run["init_checksum"] == committed["init_checksum"]
        runs.append({"side": "remade", "seed": seed, "dtype": committed["dtype"], "losses": run["losses"]})
    report = lc.analyze(runs + [committed])
    assert report["checks"][0]["pass"], report


def test_chip_smoke_phase21_tables(monkeypatch):
    """chip_smoke.py phase 21's launch tables: a bf16 step of the check's
    UNet at 32x32 latents, batch 2, on meta tensors through the stubbed
    kernels (forward, then backward)."""
    import sys

    from torch_parity import recorded_launches

    from neurosis_tpu_torch.models.unet import UNetModel

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    calls = recorded_launches(monkeypatch)
    model = UNetModel(**lc.CFG, dtype=torch.bfloat16, device="meta", generator=torch.Generator())
    x = torch.empty(lc.BATCH, lc.RES, lc.RES, 4, device="meta", dtype=torch.bfloat16)
    out = model(x, torch.empty(lc.BATCH, device="meta"), torch.empty(lc.BATCH, lc.CONTEXT_LEN, 768, device="meta"))
    fwd = dict(calls)
    calls.clear()
    out.float().sum().backward()
    bwd = dict(calls)
    flash = {k[1] + (40,): (n, bwd[("flash_bwd_bf16", (0, 0, None, None))] // 2)
             for k, n in fwd.items() if k[0] == "flash_fwd_bf16"}
    assert flash == cs.LOSS_CURVE_FLASH_SHAPES
    conv = {k[1]: (n, bwd[k]) for k, n in fwd.items() if k[0] == "conv3x3_bf16"}
    assert conv == cs.LOSS_CURVE_CONV_SHAPES
    assert {k[0] for k in list(fwd) + list(bwd)} == {"flash_fwd_bf16", "flash_bwd_bf16", "conv3x3_bf16"}
    assert cs.PATHS["loss_curve"][0] == "loss_curve" and cs.LOSS_CURVE_SEEDS == (0, 1)
