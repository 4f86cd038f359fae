"""The port's vision towers against the JAX package's on the CPU: both
bicubic resizes (``ops/resize.py``: ATen's, and ``jax.image.resize``'s),
the OpenCLIP image tower and ``FrozenOpenCLIPImageEmbedder``, DINOv2 (the
MLP and the fused SwiGLU, register tokens, the position embeddings
resampled to another grid) and ``create_dinov2`` from a safetensors file
the test writes. Inputs are seeded numpy copied into both frameworks;
weights go JAX → torch through ``jax_params_to_state_dict`` with
``strict=True``. Tolerances are the JAX suite's: fp32 atol 1e-5 / rtol 1e-4,
bf16 2e-2 of the largest value.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, one_torch_thread, perturb, rel_err, t  # noqa: E402,F401

CPU = "cpu"
RESIZE_CASES = [((256, 256), (224, 224)),  # the DreamSim loss and the CLIP embedder
                ((32, 32), (224, 224)),  # upsampling
                ((40, 72), (224, 160))]  # not square


def _images(shape, seed=0, batch=2):
    return np.random.RandomState(seed).rand(batch, *shape, 3).astype(np.float32) * 2 - 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out", RESIZE_CASES)
@pytest.mark.parametrize("align_corners,antialias", [(True, True), (False, True), (False, False)])
def test_bicubic_resize_matches_jax(shape, out, dtype, align_corners, antialias):
    from neurosis_tpu.ops.resize import bicubic_resize as jax_resize
    from neurosis_tpu_torch.ops.resize import bicubic_resize

    x = _images(shape)
    want = jax_resize(jnp.asarray(x.copy()).astype(dtype), out, align_corners=align_corners, antialias=antialias)
    got = bicubic_resize(t(x).to(getattr(torch, dtype)), out, align_corners=align_corners, antialias=antialias)
    assert str(got.dtype).endswith(dtype) and want.dtype == jnp.dtype(dtype)
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,out", RESIZE_CASES)
def test_jax_image_resize_matches_jax(shape, out, dtype):
    """Keys' a = -0.5 cubic of ``jax.image.resize`` (DreamSim's), in the
    image's dtype, and then the normalisation's promotion to fp32."""
    from neurosis_tpu_torch.losses.dreamsim import DINO_MEAN, DINO_STD
    from neurosis_tpu_torch.ops.resize import jax_image_resize

    x = _images(shape, seed=1) * 0.5 + 0.5
    want = jax.image.resize(jnp.asarray(x.copy()).astype(dtype), (2, *out, 3), "bicubic", antialias=True)
    got = jax_image_resize(t(x).to(getattr(torch, dtype)), out)
    assert str(got.dtype).endswith(dtype) and want.dtype == jnp.dtype(dtype)
    tol = dict(atol=1e-5, rtol=1e-4) if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    want_n = (want - jnp.asarray(DINO_MEAN)) / jnp.asarray(DINO_STD)
    got_n = (got - torch.from_numpy(DINO_MEAN)) / torch.from_numpy(DINO_STD)
    assert got_n.dtype == torch.float32 and want_n.dtype == jnp.float32
    np.testing.assert_allclose(got_n.numpy(), np.asarray(want_n), atol=tol["atol"] * 10, rtol=tol["rtol"])


def test_the_path_calls_no_interpolate(monkeypatch):
    """The resizes are the port's own matmuls: F.interpolate stays a test oracle."""
    import torch.nn.functional as F

    from neurosis_tpu_torch.ops.resize import bicubic_resize, jax_image_resize

    monkeypatch.setattr(F, "interpolate", lambda *a, **k: pytest.fail("F.interpolate called"))
    x = t(_images((40, 40)))
    bicubic_resize(x, (24, 24), align_corners=True)
    jax_image_resize(x, (24, 24))


TINY_TOWER = dict(image_size=56, patch_size=14, width=32, layers=2, heads=4, output_dim=24)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("unsqueeze_dim,output_tokens", [(False, False), (True, True)])
def test_openclip_image_embedder_matches_jax(unsqueeze_dim, output_tokens, dtype):
    from neurosis_tpu.models.text_encoder.clip_image import FrozenOpenCLIPImageEmbedder as JaxEmbedder
    from neurosis_tpu_torch.models.text_encoder.clip_image import FrozenOpenCLIPImageEmbedder

    x = _images((72, 64), seed=2)
    jdt = getattr(jnp, dtype) if dtype else None
    jm = JaxEmbedder(**TINY_TOWER, unsqueeze_dim=unsqueeze_dim, output_tokens=output_tokens, dtype=jdt)
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], seed=3)
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x.copy()))
    tm = FrozenOpenCLIPImageEmbedder(**TINY_TOWER, unsqueeze_dim=unsqueeze_dim, output_tokens=output_tokens,
                                     dtype=getattr(torch, dtype) if dtype else None, device=CPU)
    load_into(tm, params)
    assert not any(p.requires_grad for p in tm.parameters())
    with torch.no_grad():
        got = tm(t(x))
    assert len(got) == len(want) == (2 if output_tokens else 1)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        if dtype is None:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=1e-4)
        else:
            assert rel_err(g.float(), w.astype(jnp.float32)) < 2e-2


def _dino_pair(seed, **kw):
    from neurosis_tpu.models.dinov2 import DinoVisionTransformer as JaxDino
    from neurosis_tpu_torch.models.dinov2 import DinoVisionTransformer

    jm = JaxDino(**kw)
    x0 = jnp.zeros((1, kw["img_size"], kw["img_size"], 3))
    params = perturb(jax.jit(jm.init)(jax.random.PRNGKey(seed), x0)["params"], seed=seed)
    tm = DinoVisionTransformer(**kw, device=CPU)
    load_into(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("ffn,registers,antialias,side", [
    ("mlp", 0, False, 56),  # the training grid
    ("mlp", 0, False, 84),  # 4x4 → 6x6: position embeddings resampled up
    ("swiglufused", 4, True, 42),  # vitg14's FFN, registers, antialiased resample down
])
def test_dinov2_matches_jax(ffn, registers, antialias, side):
    kw = dict(embed_dim=32, depth=2, heads=4, patch_size=14, img_size=56, ffn_layer=ffn,
              num_register_tokens=registers, interpolate_antialias=antialias)
    jm, params, tm = _dino_pair(4, **kw)
    x = _images((side, side), seed=5) * 0.5 + 0.5
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x.copy()))
    with torch.no_grad():
        got = tm(t(x))
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-4)
    if ffn == "swiglufused":
        assert tuple(tm.blocks[0].mlp.w12.weight.shape) == (2 * 88, 32)  # round_to_8(2/3 · 128)


def _official_sd(dim, depth, n_reg, img=518, patch=14, seed=0):
    """A random state dict in the official dinov2 checkpoint's layout."""
    rng = np.random.RandomState(seed)
    n = (img // patch) ** 2

    def r(*shape, s=0.02):
        return (rng.randn(*shape) * s).astype(np.float32)

    sd = {"cls_token": r(1, 1, dim), "pos_embed": r(1, n + 1, dim), "mask_token": r(1, dim),
          "patch_embed.proj.weight": r(dim, 3, patch, patch), "patch_embed.proj.bias": r(dim),
          "norm.weight": 1 + r(dim), "norm.bias": r(dim)}
    if n_reg:
        sd["register_tokens"] = r(1, n_reg, dim)
    for i in range(depth):
        p = f"blocks.{i}"
        sd.update({f"{p}.norm1.weight": 1 + r(dim), f"{p}.norm1.bias": r(dim),
                   f"{p}.attn.qkv.weight": r(3 * dim, dim), f"{p}.attn.qkv.bias": r(3 * dim),
                   f"{p}.attn.proj.weight": r(dim, dim), f"{p}.attn.proj.bias": r(dim),
                   f"{p}.ls1.gamma": 1 + r(dim, s=0.1), f"{p}.norm2.weight": 1 + r(dim), f"{p}.norm2.bias": r(dim),
                   f"{p}.mlp.fc1.weight": r(4 * dim, dim), f"{p}.mlp.fc1.bias": r(4 * dim),
                   f"{p}.mlp.fc2.weight": r(dim, 4 * dim), f"{p}.mlp.fc2.bias": r(dim),
                   f"{p}.ls2.gamma": 1 + r(dim, s=0.1)})
    return sd


def test_create_dinov2_from_a_checkpoint_matches_jax(tmp_path, monkeypatch):
    """vits14_reg's layout cut to 2 blocks, written as safetensors by the
    port's writer and read by each package's loader; the 37² grid resampled
    to 16² at 224 px."""
    import neurosis_tpu.models.dinov2 as jax_dino
    from neurosis_tpu_torch.checkpoint.safetensors import save_file
    from neurosis_tpu_torch.models import dinov2

    for mod in (jax_dino, dinov2):
        monkeypatch.setitem(mod._ARCH, "vits14", (384, 2, 6, "mlp"))
    save_file(_official_sd(384, 2, 4), tmp_path / "dinov2_vits14_reg.safetensors")
    jm, params = jax_dino.create_dinov2("dinov2_vits14_reg", data_dir=str(tmp_path))
    tm, state = dinov2.create_dinov2("dinov2_vits14_reg", data_dir=str(tmp_path), device=CPU)
    assert params is not None and state is not None
    assert set(state) == set(tm.state_dict())  # every weight came from the file (mask_token is left over)
    x = _images((224, 224), seed=6, batch=1) * 0.5 + 0.5
    want = jax.jit(lambda p, a: jm.apply({"params": p}, a))(params, jnp.asarray(x.copy()))
    with torch.no_grad():
        got = tm(t(x))
    assert tuple(got["x_norm_patchtokens"].shape) == (1, 256, 384)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-4)


def test_create_dinov2_without_weights_keeps_the_default_init(tmp_path, caplog):
    from neurosis_tpu_torch.models.dinov2 import create_dinov2

    model, state = create_dinov2("dinov2_vits14", data_dir=str(tmp_path / "none"), device=CPU)
    assert state is None and model.num_register_tokens == 0 and model.interpolate_offset == 0.1
    assert "No DINOv2 weights found" in caplog.text
