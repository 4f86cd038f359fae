"""The port's DreamSim against the JAX package's on the CPU:
``VisionTransformerB16`` for each of pre_norm / act / num_classes / eps at
tiny dims and at an input off its native grid (so the position embeddings
are resampled), ``DreamsimModel``, ``DreamsimEnsemble`` and
``AutoencoderDreamsim`` with tiny towers on both sides
(``VisionTransformerB16`` is swapped, in each package's module and in this
test only, for a subclass with tiny defaults), three VAE generator steps
with ``AutoencoderDreamsim`` against JAX's ``AutoencodingEngine`` (losses,
grads, updates; the towers untouched), the config path through the port's
builder, and the converters (the LoRA merge, the CLIP remap,
``convert_dreamsim_single`` from a safetensors file the test writes).
Inputs are seeded numpy copied into both frameworks; weights go JAX →
torch through ``jax_params_to_state_dict`` with ``strict=True``. fp32
atol 1e-5 / rtol 1e-4 (the JAX suite's).
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import grads_by_key, load_into, one_torch_thread, perturb, t, to_np  # noqa: E402,F401

CPU = "cpu"
TINY_VIT = dict(image_size=64, patch_size=16, embed_dim=32, depth=2, num_heads=4)
TINY_TOWER = dict(TINY_VIT, patch_size=32, depth=1)  # the swapped-in towers: 7x7 patches of the 224 px pairs
FP32 = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture
def tiny_towers(monkeypatch):
    """Both packages' VisionTransformerB16 with TINY_TOWER's defaults."""
    import neurosis_tpu.losses.dreamsim as jax_ds
    from neurosis_tpu_torch.losses import dreamsim

    class JaxTiny(jax_ds.VisionTransformerB16):
        image_size: int = TINY_TOWER["image_size"]
        patch_size: int = TINY_TOWER["patch_size"]
        embed_dim: int = TINY_TOWER["embed_dim"]
        depth: int = TINY_TOWER["depth"]
        num_heads: int = TINY_TOWER["num_heads"]

    class PortTiny(dreamsim.VisionTransformerB16):
        def __init__(self, **kw):
            super().__init__(**{**TINY_TOWER, **kw})

    monkeypatch.setattr(jax_ds, "VisionTransformerB16", JaxTiny)
    monkeypatch.setattr(dreamsim, "VisionTransformerB16", PortTiny)
    return jax_ds, dreamsim


def _pair(seed, batch=2, side=48):
    """[2, B, H, W, 3] in [0, 1]."""
    return np.random.RandomState(seed).rand(2, batch, side, side, 3).astype(np.float32)


@pytest.mark.parametrize("pre_norm,act,num_classes,eps", [(False, "gelu", 0, 1e-6), (True, "quick_gelu", 8, 1e-5),
                                                          (True, "gelu", 8, 1e-5), (False, "gelu", 8, 1e-6)])
@pytest.mark.parametrize("norm", [False, True])
def test_vit_matches_jax(pre_norm, act, num_classes, eps, norm):
    from neurosis_tpu.losses.dreamsim import VisionTransformerB16 as JaxViT
    from neurosis_tpu_torch.losses.dreamsim import VisionTransformerB16

    cfg = dict(TINY_VIT, pre_norm=pre_norm, act_layer=act, num_classes=num_classes, layer_norm_eps=eps)
    x = np.random.RandomState(0).randn(2, 96, 80, 3).astype(np.float32)  # a 6x5 grid from the native 4x4
    jm = JaxViT(**cfg)
    params = perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x.copy()), norm=norm)["params"], seed=2)
    want = jm.apply({"params": params}, jnp.asarray(x.copy()), norm=norm)
    tm = VisionTransformerB16(**cfg, final_norm=norm, device=CPU)
    load_into(tm, params)
    assert (tm.patch_embed.proj.bias is None) == pre_norm
    with torch.no_grad():
        got = tm(t(x))
    assert tuple(got.shape) == want.shape == (2, num_classes or 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def test_pos_encoding_raises_where_the_grid_does_not_come_out(monkeypatch):
    from neurosis_tpu_torch.losses import dreamsim

    monkeypatch.setattr(dreamsim, "bicubic_resize", lambda x, size, **kw: x[:, :-1])
    with pytest.raises(ValueError, match="positional encoding"):
        dreamsim.interpolate_pos_encoding(torch.zeros(1, 17, 8), 36, 6, 6)


@pytest.mark.parametrize("ensemble", [False, True])
def test_dreamsim_distance_matches_jax(tiny_towers, ensemble):
    jax_ds, dreamsim = tiny_towers
    x = _pair(3)
    if ensemble:
        jm, tm = jax_ds.DreamsimEnsemble(do_resize=True), dreamsim.DreamsimEnsemble(do_resize=True, device=CPU)
    else:
        jm = jax_ds.DreamsimModel(pre_norm=True, act_layer="quick_gelu", layer_norm_eps=1e-5, do_resize=True)
        tm = dreamsim.DreamsimModel(pre_norm=True, act_layer="quick_gelu", layer_norm_eps=1e-5, do_resize=True,
                                    device=CPU)
    params = perturb(jm.init(jax.random.PRNGKey(4), jnp.asarray(x.copy()))["params"], seed=5)
    want = jm.apply({"params": params}, jnp.asarray(x.copy()))
    load_into(tm, params)
    with torch.no_grad():
        got = tm(t(x))
    assert tuple(got.shape) == want.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("recon_type,ensemble", [("l1", True), ("l2", False)])
def test_autoencoder_dreamsim_matches_jax(tiny_towers, recon_type, ensemble):
    """The loss, its log, and its grad at the reconstruction; a bf16
    reconstruction meets fp32 inputs in fp32, as JAX promotes."""
    jax_ds, dreamsim = tiny_towers
    rng = np.random.RandomState(6)
    inputs, recons = (rng.rand(2, 40, 40, 3).astype(np.float32) * 2 - 1 for _ in range(2))
    cfg = dict(recon_type=recon_type, recon_weight=0.7, dreamsim_weight=1.3, ensemble=ensemble)
    jm = jax_ds.AutoencoderDreamsim(**cfg)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(7), jnp.asarray(inputs.copy()),
                                      jnp.asarray(recons.copy()))["params"], seed=8)

    def jloss(p, r):
        loss, log = jm.apply({"params": p}, jnp.asarray(inputs.copy()), r, split="val")
        return jnp.mean(loss), (loss, log)

    (_, (jl, jlog)), jgrad = jax.jit(jax.value_and_grad(jloss, argnums=1, has_aux=True))(
        params, jnp.asarray(recons.copy()))
    tm = dreamsim.AutoencoderDreamsim(**cfg, device=CPU)
    load_into(tm, params)
    assert not any(p.requires_grad for p in tm.parameters())
    r = t(recons, requires_grad=True)
    tl, tlog = tm(t(inputs), r, split="val")
    tl.mean().backward()
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **FP32)
    assert set(tlog) == set(jlog) == {f"val/loss/{k}" for k in ("total", "rec", "dreamsim")}
    for k, v in jlog.items():
        np.testing.assert_allclose(float(tlog[k]), float(v), **FP32)
    scale = float(np.abs(np.asarray(jgrad)).max())
    assert float(np.abs(r.grad.numpy() - np.asarray(jgrad)).max()) / scale < 1e-4

    jb, _ = jax.jit(lambda p, a, r: jm.apply({"params": p}, a, r))(params, jnp.asarray(inputs.copy()),
                                                                    jnp.asarray(recons.copy()).astype(jnp.bfloat16))
    tb, _ = tm(t(inputs), t(recons).bfloat16())
    assert tb.dtype == torch.float32 and jb.dtype == jnp.float32
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(jb), **FP32)


TINY_DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=64, z_channels=2,
               dropout=0.0)
LR = 1e-4


def test_vae_generator_steps_match_jax(tiny_towers):
    """Three generator steps of the VAE trainer with AutoencoderDreamsim
    (ensemble, L1) from the same weights and uint8 images, the posterior's
    mode, AdamW: logged losses within 1e-5, each grad within 5e-4 of its
    largest value, each update within 2e-2·lr where the grad is not fp32
    noise (AdamW moves a weight by about lr whatever its grad's size) and
    2.1·lr everywhere. The towers take no grad and do not move."""
    import optax

    jax_ds, dreamsim = tiny_towers
    from neurosis_tpu.models.vae import Decoder as JaxDecoder
    from neurosis_tpu.models.vae import Encoder as JaxEncoder
    from neurosis_tpu.ops.dequant import dequant_image as jax_dequant
    from neurosis_tpu.trainer.vae_engine import AutoencodingEngine as JaxEngine
    from neurosis_tpu_torch.models.vae import Decoder, Encoder
    from neurosis_tpu_torch.optimizers.adamw import adamw
    from neurosis_tpu_torch.trainer.vae_engine import AutoencodingEngine

    images = np.random.RandomState(9).randint(0, 256, size=(2, 64, 64, 3)).astype(np.uint8)
    jbatch, tbatch = {"image": jnp.asarray(images.copy())}, {"image": torch.tensor(images.copy())}
    jeng = JaxEngine(encoder=JaxEncoder(**TINY_DD, double_z=True, in_channels=3), decoder=JaxDecoder(**TINY_DD, out_ch=3),
                     loss=jax_ds.AutoencoderDreamsim(), g_optimizer=optax.adamw(LR), d_optimizer=optax.adamw(LR),
                     kl_weight=1e-6, sample_posterior=False)
    jstate = jax.jit(jeng.init)(jax.random.PRNGKey(0), jbatch)
    jstate = dataclasses.replace(jstate, params=jax.tree_util.tree_map(jnp.asarray, perturb(jstate.params, 1, 0.01)))
    params = to_np(jstate.params)
    enc, dec = Encoder(**TINY_DD, double_z=True, in_channels=3, device=CPU), Decoder(**TINY_DD, out_ch=3, device=CPU)
    loss = dreamsim.AutoencoderDreamsim(device=CPU)
    for m, k in ((enc, "encoder"), (dec, "decoder"), (loss, "loss")):
        load_into(m, params[k])
    teng = AutoencodingEngine(enc, dec, loss, g_optimizer=lambda ps: adamw(ps, LR), kl_weight=1e-6,
                              sample_posterior=False, device=CPU)
    assert not teng.has_discriminator and teng.train_step_schedule(1, 5) == 0
    tstate = teng.init(seed=0)
    assert {id(p) for g in tstate.g_optimizer.param_groups for p in g["params"]} == \
        {id(p) for p in list(enc.parameters()) + list(dec.parameters())}
    towers = {k: v.clone() for k, v in loss.state_dict().items()}
    named = {f"encoder.{k}": p for k, p in enc.named_parameters()}
    named.update({f"decoder.{k}": p for k, p in dec.named_parameters()})
    g_step = jax.jit(jeng.g_step)

    @jax.jit
    def jax_grads(params, step):
        x = jax_dequant(jbatch["image"])

        def loss_fn(g):
            p = dict(params, **g)
            _, recons, reg_log, _ = jeng.forward_with_stats(p, x, None, None, train=True)
            (l, _), _ = jeng._loss_apply(p["loss"], {}, x, recons, step, 0)
            return jnp.mean(l) + 1e-6 * jnp.mean(reg_log["kl_loss"])

        return jax.grad(loss_fn)({k: params[k] for k in ("encoder", "decoder")})

    for i in range(3):
        want_g = grads_by_key(jax_grads(jstate.params, jstate.step))
        prev, jprev = {k: p.detach().clone() for k, p in named.items()}, grads_by_key(jstate.params)
        jstate, jlog = g_step(jstate, jbatch)
        tstate, tlog = teng.g_step(tstate, tbatch)
        assert tstate.step == int(jstate.step) == i + 1
        assert set(tlog) == set(jlog)
        for k, v in jlog.items():
            np.testing.assert_allclose(float(tlog[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=(i, k))
        floor = 1e-3 * max(float(np.abs(g).max()) for g in want_g.values())
        want_p = grads_by_key(jstate.params)
        for k, g in want_g.items():
            scale = max(float(np.abs(g).max()), floor)
            assert float(np.abs(named[k].grad.numpy() - g).max()) / scale < 5e-4, (i, k, "grad")
            delta, jdelta = (named[k].detach() - prev[k]).numpy(), want_p[k] - jprev[k]
            real = np.abs(g) >= (1e-2 if i == 0 else 1e-1) * scale
            assert float(np.abs(delta - jdelta)[real].max(initial=0.0)) <= 2e-2 * LR, (i, k, "update")
            assert float(np.abs(delta - jdelta).max()) <= 2.1 * LR, (i, k, "update bound")
        assert all(p.grad is None for p in loss.parameters())
        assert all(torch.equal(v, towers[k]) for k, v in loss.state_dict().items())


def test_the_builder_takes_a_dreamsim_config(tiny_towers):
    """vae.example.yaml's model node with its loss swapped for
    AutoencoderDreamsim (tiny towers) builds through the port's builder as
    the JAX builder builds it: the registry resolves the path, the towers are the
    loss's frozen submodules, disc_optimizer is taken and unused."""
    from neurosis_tpu.config.registry import resolve_class_path as jax_resolve
    from neurosis_tpu_torch.config.registry import known_paths, resolve_class_path
    from neurosis_tpu_torch.losses.dreamsim import AutoencoderDreamsim
    from neurosis_tpu_torch.trainer.builder import build_engine

    path = "neurosis.modules.autoencoding.losses.AutoencoderDreamsim"
    assert resolve_class_path(path) is AutoencoderDreamsim and known_paths()[path] == "ported"
    assert jax_resolve(path).__name__ == "AutoencoderDreamsim"
    node = {"class_path": "neurosis.models.autoencoder.AutoencodingEngine", "init_args": {
        "input_key": "image", "kl_weight": 1e-6,
        "ddconfig": dict(TINY_DD, double_z=True, in_channels=3, out_ch=3),
        "loss": {"class_path": path, "init_args": {"recon_type": "l1", "recon_weight": 1.0, "dreamsim_weight": 1.0,
                                                   "ensemble": True}},
        "optimizer": {"class_path": "optax.adamw", "init_args": {"learning_rate": 4.5e-6}},
        "disc_optimizer": {"class_path": "optax.adamw", "init_args": {"learning_rate": 4.5e-6}}}}
    engine = build_engine(node, device=CPU, generator=torch.Generator(CPU).manual_seed(0))
    assert isinstance(engine.loss, AutoencoderDreamsim) and not engine.has_discriminator
    state = engine.init(0)
    assert state.d_optimizer is None
    trained = {id(p) for g in state.g_optimizer.param_groups for p in g["params"]}
    assert not trained & {id(p) for p in engine.loss.parameters()}
    assert not any(p.requires_grad for p in engine.loss.parameters())


def test_lora_merge_and_clip_remap_match_jax():
    from neurosis_tpu.losses import dreamsim_convert as jc
    from neurosis_tpu_torch.losses import dreamsim_convert as tc

    rng = np.random.RandomState(10)
    dim, rank, layers = 16, 2, 2
    base = {f"blocks.{i}.attn.qkv.weight": rng.randn(3 * dim, dim).astype(np.float32) for i in range(layers)}
    base["blocks.0.attn.proj.weight"] = rng.randn(dim, dim).astype(np.float32)
    lora = {}
    for i in range(layers - 1):  # the last layer has no adapter: kept, with a warning
        p = f"{tc.LORA_PREFIX}blocks.{i}.attn.qkv"
        lora[f"{p}.lora_A.weight"] = rng.randn(2 * rank, dim).astype(np.float32)
        lora[f"{p}.lora_B.weight"] = rng.randn(2 * dim, rank, 1).astype(np.float32)
    got, want = tc.merge_dreamsim_lora(base, lora), jc.merge_dreamsim_lora(base, lora)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(got["blocks.0.attn.qkv.weight"], base["blocks.0.attn.qkv.weight"])
    np.testing.assert_array_equal(got["blocks.1.attn.qkv.weight"], base["blocks.1.attn.qkv.weight"])

    sd = {"patch_embed.proj.weight": rng.randn(4, 3, 2, 2).astype(np.float32),
          "patch_embed.proj.bias": np.zeros(4, np.float32), "pos_drop.weight": np.ones(4, np.float32),
          "pos_drop.bias": np.zeros(4, np.float32), "head.weight": rng.randn(8, 4).astype(np.float32)}
    for variant in ("clip_vitb16_single", "open_clip_vitb16", "dino_vitb16_single"):
        got, want = tc.remap_clip(sd, variant), jc.remap_clip(sd, variant)
        assert set(got) == set(want), variant
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))


def _timm_vit_sd(rng, dim, depth, classes, pre_norm, grid, patch):
    """A random state dict of a merged DreamSim tower, timm's layout (fused qkv)."""
    def r(*shape):
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    sd = {"cls_token": r(1, 1, dim), "pos_embed": r(1, grid * grid + 1, dim),
          "patch_embed.proj.weight": r(dim, 3, patch, patch), "patch_embed.proj.bias": r(dim),
          "norm.weight": 1 + r(dim), "norm.bias": r(dim)}
    if pre_norm:
        sd.update({"pos_drop.weight": 1 + r(dim), "pos_drop.bias": r(dim), "head.weight": r(classes, dim)})
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + r(dim), f"{p}.norm1.bias": r(dim), f"{p}.attn.qkv.weight": r(3 * dim, dim),
                   f"{p}.attn.qkv.bias": r(3 * dim), f"{p}.attn.proj.weight": r(dim, dim),
                   f"{p}.attn.proj.bias": r(dim), f"{p}.norm2.weight": 1 + r(dim), f"{p}.norm2.bias": r(dim),
                   f"{p}.mlp.fc1.weight": r(4 * dim, dim), f"{p}.mlp.fc1.bias": r(4 * dim),
                   f"{p}.mlp.fc2.weight": r(dim, 4 * dim), f"{p}.mlp.fc2.bias": r(dim)})
    return sd


@pytest.mark.parametrize("variant", ["clip_vitb16", "dino_vitb16"])
def test_convert_dreamsim_single_matches_jax(tmp_path, tiny_towers, variant):
    """A merged single-tower checkpoint (TINY_TOWER's widths and grid), in
    the directory layout <variant>/<variant>_merged.safetensors, written by
    the port's writer; both packages convert it and agree on a distance."""
    import neurosis_tpu.losses.dreamsim_convert as jc
    from neurosis_tpu_torch.checkpoint.safetensors import save_file
    from neurosis_tpu_torch.losses import dreamsim_convert as tc

    pre_norm = variant.startswith("clip")
    patch = TINY_TOWER["patch_size"]
    sd = _timm_vit_sd(np.random.RandomState(11), 32, 2, 512, pre_norm, TINY_TOWER["image_size"] // patch, patch)
    (tmp_path / variant).mkdir()
    save_file(sd, tmp_path / variant / f"{variant}_merged.safetensors")
    jm, params = jc.convert_dreamsim_single(tmp_path, variant)
    tm, state = tc.convert_dreamsim_single(tmp_path, variant, device=CPU)
    assert params is not None and state is not None
    assert set(state) == set(tm.state_dict())
    x = _pair(12, batch=1, side=64)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x.copy()))
    with torch.no_grad():
        got = tm(t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    model, none = tc.convert_dreamsim_single(tmp_path / "absent", variant, device=CPU)
    assert none is None and isinstance(model, torch.nn.Module)


def test_cli_fits_a_dreamsim_config_on_the_cpu(tiny_towers, tmp_path, monkeypatch):
    """configs/smoke/vae-tiny.yaml with its loss swapped for
    AutoencoderDreamsim (tiny towers) fits through the port's CLI: two
    generator steps with finite losses, the dreamsim term logged."""
    import json
    from pathlib import Path

    from neurosis_tpu_torch.data.png import write_png
    from neurosis_tpu_torch.trainer.cli import main

    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.RandomState(13)
    for i in range(4):
        write_png(data / f"img_{i}.png", (rng.rand(64, 72, 3) * 255).astype(np.uint8))
    monkeypatch.setenv("NEUROSIS_SMOKE_DATA", str(data))
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    text = (Path(__file__).resolve().parents[1] / "configs" / "smoke" / "vae-tiny.yaml").read_text()
    start, end = text.index("    loss:\n"), text.index("    optimizer:\n")
    text = text[:start] + ("    loss:\n      class_path: neurosis.modules.autoencoding.losses.AutoencoderDreamsim\n"
                           "      init_args:\n        recon_type: l1\n        ensemble: true\n") + text[end:]
    text = text.replace("  fast_dev_run: true\n", "  fast_dev_run: false\n").replace("  max_steps: 1\n", "  max_steps: 2\n")
    (tmp_path / "ds.yaml").write_text(text)
    assert main(["fit", "-c", str(tmp_path / "ds.yaml"), "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in (tmp_path / "root" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["total"]) and r["train/loss/dreamsim"] > 0 for r in lines)


def test_chip_smoke_phase19_tables(monkeypatch):
    """chip_smoke.py phase 19's launch tables: a generator step of the
    bf16-mixed DreamSim copy of vae.example.yaml (256 px, batch 2), its
    encoder, decoder and loss on meta tensors through the stubbed kernels;
    the towers launch none. As written (fp32) the step is cli_vae's."""
    import sys
    from pathlib import Path

    from torch_parity import recorded_launches

    from neurosis_tpu_torch.losses.dreamsim import AutoencoderDreamsim
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    calls = recorded_launches(monkeypatch)
    dd = dict(ch=128, ch_mult=[1, 2, 4, 4], num_res_blocks=2, attn_resolutions=[], resolution=256, z_channels=4)
    meta = dict(device="meta", generator=torch.Generator())
    for dtype in (torch.bfloat16, None):
        enc = Encoder(**dd, double_z=True, in_channels=3, dtype=dtype, **meta)
        dec = Decoder(**dd, out_ch=3, dtype=dtype, **meta)
        x = torch.empty(2, 256, 256, 3, device="meta")
        calls.clear()
        recons = dec(enc(x)[..., :4])
        loss, _ = AutoencoderDreamsim(**meta)(x, recons)
        fwd = dict(calls)
        calls.clear()
        loss.mean().backward()
        bwd = dict(calls)
        flash = {k[1] + (512,): (n, bwd[("flash_bwd_f32" if dtype is None else "flash_bwd_bf16", (0, 0, 0, 0))])
                 for k, n in fwd.items() if k[0].startswith("flash_fwd")}
        if dtype is None:
            assert flash == cs.CLI_VAE_F32_FLASH_SHAPES and cs.TABLES_OF["cli_ds_f32"] == "cli_vae"
            assert {k[0] for k in list(fwd) + list(bwd)} == {"flash_fwd_f32", "flash_bwd_f32"}
            continue
        assert flash == cs.DS_FLASH_SHAPES
        assert {k[1]: n for k, n in fwd.items() if k[0] == "gn_silu_conv3x3_bf16"} == cs.DS_GN_CONV_SHAPES
        conv = {}
        for (entry, sh), n in list(fwd.items()) + [(k, -n) for k, n in bwd.items()]:
            if entry == "conv3x3_bf16":  # forward counts positive, dgrads negative
                key = sh if n > 0 else sh[:3] + (sh[4], sh[3])  # a dgrad of C -> F runs F -> C
                f, d = conv.get(key, (0, 0))
                conv[key] = (f + n, d) if n > 0 else (f, d - n)
        assert conv == cs.DS_CONV_SHAPES
