"""The port's VQ autoencoder trainer against the JAX package's
AutoencodingEngine on the CPU, and the VAE trainer's eval and resume.

(a) A VQ engine (VectorQuantizer codebook, VQLPIPSWithDiscriminator with
    the alex LPIPS and the adaptive d_weight, EMA at decay 0.9, optax.sgd) from the same
    weights: three generator steps (the GAN gate opens at the second) and
    then ``eval_step`` with the live weights and under the EMA shadows,
    every logged value within 1e-5 (or 1e-6 absolute: the mean logits sum
    terms of both signs to near 0, as in test_torch_vae_engine.py). The
    posterior of a VQ engine draws nothing, so both sides see the same
    latents. SGD moves each weight by lr × its grad, so fp32 noise in a
    grad stays noise in the weights.
(b) ``freeze_encoder`` leaves the encoder bit-identical.
(c) ``validate`` of configs/smoke/vae-tiny.yaml through the CLI's builders
    and loops, JAX's and the port's, on the same two batches of JAX's
    pipeline (the two pipelines seed their crops differently), from JAX's
    init loaded into the port, with the posterior's mode on both sides (the
    two frameworks draw differently): every metric within 1e-5.
(d) A VQ run saved after two steps and resumed carries its codebook, its
    EMA shadows and an EMA codebook's statistics: the resumed third step is
    bit-identical to the uninterrupted one.
(e) chip_smoke.py phase 16's launch tables are the VQ-f8 copy's encoder and
    decoder run on meta tensors through the stubbed kernels.
"""

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, one_torch_thread, perturb, recorded_launches, to_np  # noqa: E402,F401

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]
DD = dict(ch=32, ch_mult=[1], num_res_blocks=1, attn_resolutions=[], resolution=32, z_channels=4)
LOSS = dict(disc_start=1, disc_num_layers=1, perceptual_weight=0.1, disc_weight=0.6, codebook_weight=0.8,
            lpips_type="alex")  # the vgg trunk is held in test_torch_gan_losses.py
LR = 1e-5


def _images(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, size=(2, 32, 32, 3)).astype(np.uint8)


def _close_logs(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), (what, sorted(set(got) ^ set(want)))
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")


def _vq_pair():
    import optax

    from neurosis_tpu.losses.discriminator_loss import VQLPIPSWithDiscriminator as JL
    from neurosis_tpu.models.vae import Decoder as JDec
    from neurosis_tpu.models.vae import Encoder as JEnc
    from neurosis_tpu.modules.regularizers import VectorQuantizer as JVQ
    from neurosis_tpu.trainer.vae_engine import AutoencodingEngine as JEngine
    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.losses.discriminator_loss import VQLPIPSWithDiscriminator
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.modules.regularizers import VectorQuantizer
    from neurosis_tpu_torch.optimizers.adamw import sgd
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    opts = dict(sample_posterior=False, use_ema=True, ema_decay=0.9, disc_start=1, adaptive_disc_weight=True)
    jeng = JEngine(encoder=JEnc(**DD, double_z=False), decoder=JDec(out_ch=3, **DD), loss=JL(**LOSS),
                   regularizer=JVQ(n_e=16, e_dim=4, beta=0.25, log_perplexity=True), g_optimizer=optax.sgd(LR),
                   d_optimizer=optax.sgd(LR), **opts)
    jstate = jax.jit(jeng.init)(jax.random.PRNGKey(0), {"image": jnp.asarray(_images())})
    params = perturb(jstate.params, 1, 0.01)
    params["regularizer"]["embedding"] = np.random.RandomState(2).randn(16, 4).astype(np.float32)
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, params))
    from neurosis_tpu.modules.ema import ema_init

    jstate = dataclasses.replace(jstate, ema=ema_init({k: jstate.params[k] for k in jeng._g_keys()}))

    enc, dec = Encoder(**DD, double_z=False, device=CPU), Decoder(out_ch=3, **DD, device=CPU)
    reg, loss = VectorQuantizer(16, 4, beta=0.25, log_perplexity=True, device=CPU), VQLPIPSWithDiscriminator(
        **LOSS, device=CPU)
    for m, k in ((enc, "encoder"), (dec, "decoder"), (reg, "regularizer")):
        load_into(m, params[k])
    loss.load_state_dict({**jax_params_to_state_dict(params["loss"]),
                          **jax_params_to_state_dict(to_np(jstate.batch_stats))}, strict=True)
    teng = AutoencodingEngine(enc, dec, loss, lambda ps: sgd(ps, LR), lambda ps: sgd(ps, LR), regularizer=reg,
                              device=CPU, **opts)
    return jeng, jstate, teng


def test_vq_engine_g_steps_and_eval_step_match_jax():
    jeng, jstate, teng = _vq_pair()
    tstate = teng.init(seed=0)
    assert [n.split(".")[0] for n, _ in teng.named_g_parameters()][-1] == "regularizer"
    jbatch, tbatch = {"image": jnp.asarray(_images(3))}, {"image": torch.tensor(_images(3))}
    g_step = jax.jit(jeng.g_step)
    for i in range(3):
        jstate, jlog = g_step(jstate, jbatch)
        tstate, tlog = teng.g_step(tstate, tbatch)
        _close_logs(tlog, jlog, f"g step {i}")
    assert float(tlog["train/scalars/d_weight"]) != LOSS["disc_weight"]  # the adaptive weight
    got = dict(teng.regularizer.named_parameters())["embedding.weight"].detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jstate.params["regularizer"]["embedding"]), rtol=1e-5, atol=1e-7)
    _, jmetrics = jeng.eval_step(jstate, jbatch)
    _, tmetrics = teng.eval_step(tstate, tbatch)
    assert any(k.endswith("_ema") for k in tmetrics) and all(k.startswith(("val/", "total")) for k in tmetrics)
    _close_logs(tmetrics, jmetrics, "eval_step")


def test_freeze_encoder_leaves_it_bit_identical():
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    _, _, teng = _vq_pair()

    eng = AutoencodingEngine(teng.encoder, teng.decoder, teng.loss, teng.g_optimizer, teng.d_optimizer,
                             regularizer=teng.regularizer, sample_posterior=False, disc_start=1,
                             freeze_encoder=True, device=CPU)
    assert not any(n.startswith("encoder.") for n, _ in eng.named_g_parameters())
    before = {k: v.clone() for k, v in eng.encoder.state_dict().items()}
    dec_before = eng.decoder.conv_out.weight.detach().clone()
    state = eng.init(seed=0)
    for _ in range(2):
        state, _ = eng.g_step(state, {"image": torch.tensor(_images(4))})
    assert all(torch.equal(before[k], v) for k, v in eng.encoder.state_dict().items())
    assert all(p.grad is None for p in eng.encoder.parameters())
    assert not torch.equal(dec_before, eng.decoder.conv_out.weight)
    with pytest.raises(ValueError, match="nothing to train"):
        AutoencodingEngine(teng.encoder, teng.decoder, teng.loss, teng.g_optimizer, freeze_encoder=True,
                           freeze_decoder=True, device=CPU)


def test_validate_of_vae_tiny_matches_jax_s_loop(tmp_path, monkeypatch):
    from neurosis_tpu.trainer.cli import _batch_factory as jax_batches
    from neurosis_tpu.trainer.cli import _build as jax_build

    from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict
    from neurosis_tpu_torch.data.png import write_png
    from neurosis_tpu_torch.trainer.cli import _build

    folder = tmp_path / "data"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):
        write_png(folder / f"img_{i}.png", (rng.rand(80, 96, 3) * 255).astype(np.uint8))
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(folder))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    text = (ROOT / "configs" / "smoke" / "vae-tiny.yaml").read_text()
    config = tmp_path / "vae-tiny.yaml"
    config.write_text(text.replace('    image_key: "image"\n', '    image_key: "image"\n    num_workers: 0\n'))

    jcfg, jengine, jdataset, jtrainer = jax_build(argparse.Namespace(config=config, fast_dev_run=True,
                                                                     max_steps=None))
    jengine.sample_posterior = False
    captured = {}
    init = jengine.init

    def init_and_keep(rng_, batch):
        state = init(rng_, batch)
        state = dataclasses.replace(state, params=jax.tree_util.tree_map(jnp.asarray, perturb(state.params, 5, 0.01)))
        captured["state"] = state
        return state

    jengine.init = init_and_keep
    batches = [b for _, b in zip(range(2), jax_batches(jcfg, jdataset)())]  # the same crops on both sides
    want = jtrainer.validate(lambda: iter(batches), max_batches=2)

    cfg, engine, dataset, trainer = _build(argparse.Namespace(config=config, fast_dev_run=True, max_steps=None,
                                                              device=CPU))
    engine.sample_posterior = False
    state = captured["state"]
    load_into(engine.encoder, state.params["encoder"])
    load_into(engine.decoder, state.params["decoder"])
    engine.loss.load_state_dict({**jax_params_to_state_dict(to_np(state.params["loss"])),
                                 **jax_params_to_state_dict(to_np(state.batch_stats))}, strict=True)
    got = trainer.validate(lambda: iter(batches), max_batches=2)
    assert got["num_batches"] == 2.0 and "val/loss/total" in got and "val/loss/g" in got
    _close_logs(got, want, "validate")


@pytest.mark.parametrize("kind", ["VectorQuantizer", "EMAVectorQuantizer"])
def test_a_vq_run_resumes_its_codebook_and_statistics(kind, tmp_path):
    from neurosis_tpu_torch.losses.vae_loss import AutoencoderPerceptual
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.modules import regularizers
    from neurosis_tpu_torch.optimizers.adamw import sgd
    from neurosis_tpu_torch.trainer.callbacks import load_checkpoint, load_state_payload, state_payload
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    def engine():
        g = torch.Generator().manual_seed(0)
        reg = getattr(regularizers, kind)(16, 4, device=CPU)
        if kind == "EMAVectorQuantizer":
            with torch.no_grad():
                reg.embedding.weight.normal_(generator=g)
        return AutoencodingEngine(Encoder(**DD, double_z=False, device=CPU, generator=g),
                                  Decoder(out_ch=3, **DD, device=CPU, generator=g),
                                  AutoencoderPerceptual(perceptual_weight=0.0, device=CPU),
                                  lambda ps: sgd(ps, LR), regularizer=reg, use_ema=True, device=CPU)

    batches = [{"image": torch.tensor(_images(10 + i))} for i in range(3)]
    a = engine()
    state = a.init(seed=0)
    for b in batches[:2]:
        state, _ = a.g_step(state, b)
    path = tmp_path / "state.pt"
    torch.save(state_payload(a, state), path)
    state, want = a.g_step(state, batches[2])

    b = engine()
    resumed = load_state_payload(b, b.init(seed=0), load_checkpoint(path))
    assert resumed.step == 2
    if kind == "EMAVectorQuantizer":
        assert set(resumed.reg_stats) == {"embedding.weight", "embedding.cluster_size", "embedding.embed_avg"}
    else:
        assert "regularizer.embedding.weight" in load_checkpoint(path)["ema_params"]
    resumed, got = b.g_step(resumed, batches[2])
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for (n, p), (_, q) in zip(a.named_g_parameters(), b.named_g_parameters()):
        assert torch.equal(p, q), n
    for x, y in zip(list(a.regularizer.buffers()) + state.ema.params, list(b.regularizer.buffers()) + resumed.ema.params):
        assert torch.equal(x, y)


def test_chip_smoke_phase16_tables_are_the_models_launches(monkeypatch):
    """A generator step (forward with grad, then backward) and a
    discriminator step (forward without grad) of the VQ-f8 copy's encoder
    and decoder at 256 px, batch 8, in bf16 and in fp32, give phase 16's
    pair tables; two forwards without grad (live and EMA weights) give a
    validate batch's. Each of their rows is a row of phase 3's tables under
    its path, with its count."""
    import chip_smoke as cs

    from neurosis_tpu_torch.config.yaml_reader import safe_load
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    calls = recorded_launches(monkeypatch)
    model = safe_load(cs.phase16_configs(ROOT)["vq-f8"], "vq-f8")["model"]["init_args"]
    dd = {k: v for k, v in model["ddconfig"].items() if k not in ("double_z", "in_channels", "out_ch")}
    meta = dict(device="meta", generator=torch.Generator())

    def run(dtype, grad: bool) -> dict:
        enc, dec = Encoder(**dd, double_z=False, dtype=dtype, **meta), Decoder(**dd, out_ch=3, dtype=dtype, **meta)
        x = torch.empty(8, 256, 256, 3, device="meta")
        calls.clear()
        with torch.set_grad_enabled(grad):
            recons = dec(enc(x))
        fwd = dict(calls)
        calls.clear()
        if grad:
            recons.float().sum().backward()
        return fwd, dict(calls)

    for dtype, flash in ((torch.bfloat16, "flash_fwd_bf16"), (None, "flash_fwd_f32")):
        (g_fwd, g_bwd), (d_fwd, _) = run(dtype, True), run(dtype, False)
        fwd = {k: g_fwd[k] + d_fwd[k] for k in g_fwd}
        want_flash = {sh[:4]: n for sh, (n, _) in cs.VQ_FLASH_SHAPES.items()}
        assert {k[1]: n for k, n in fwd.items() if k[0] == flash} == want_flash
        assert {k[1]: n for k, n in g_bwd.items() if k[0].startswith("flash_bwd")} == \
            {(0, 0, 0, 0): sum(n for _, n in cs.VQ_FLASH_SHAPES.values())}  # the stub's backward args are not shapes
        if dtype is None:
            assert set(k[0] for k in list(fwd) + list(g_bwd)) == {"flash_fwd_f32", "flash_bwd_f32"}
            continue
        assert {k[1]: n for k, n in fwd.items() if k[0] == "gn_silu_conv3x3_bf16"} == cs.VQ_GN_CONV_SHAPES
        conv = {}
        for (entry, sh), n in fwd.items():
            if entry == "conv3x3_bf16":
                conv[sh] = (conv.get(sh, (0, 0))[0] + n, conv.get(sh, (0, 0))[1])
        for (entry, recorded), n in g_bwd.items():
            if entry == "conv3x3_bf16":  # a dgrad runs F -> C: listed under the conv's (B, H, W, C, F)
                b, h, w, c, f = recorded
                sh = (b, h, w, f, c)
                conv[sh] = (conv.get(sh, (0, 0))[0], conv.get(sh, (0, 0))[1] + n)
        assert conv == cs.VQ_CONV_SHAPES
    fwd, _ = run(None, False)
    assert {k[1]: 2 * n for k, n in fwd.items()} == {sh[:4]: n for sh, n in cs.VQ_VAL_F32_FLASH_SHAPES.items()}

    flash_rows = {(path, sh, dt): n for path, sh, n, dt in cs.flash_tables(torch)}
    for path, dt in (("cli_vq_bf16", torch.bfloat16), ("cli_vq_f32", torch.float32)):
        assert all(flash_rows[path, sh, dt] == n for sh, n in cs.VQ_FLASH_SHAPES.items())
    assert all(flash_rows["cli_vq_val", sh, torch.float32] == (n, 0) for sh, n in cs.VQ_VAL_F32_FLASH_SHAPES.items())
    assert {"cli_vq_f32", "cli_vq_bf16", "cli_vq_val", "cli_vae_val"} <= set(cs.PATHS)
