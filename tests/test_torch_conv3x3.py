"""neurosis_tpu_torch conv3x3 / gn_silu_conv3x3 (plain versions, CPU) against
the JAX Pallas kernels under NEUROSIS_PALLAS_INTERPRET=1, forward and
backward, following tests/test_conv3x3.py and tests/test_fused_gn_conv.py:
bf16 within 5e-3 (conv) / 1e-2 (fused grads) of the largest value, fp32
within 1e-5."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import rel_err  # noqa: E402

os.environ.setdefault("NEUROSIS_PALLAS_INTERPRET", "1")

J_DT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
T_DT = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _to_oihw(w_hwio: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32)) if not isinstance(a, torch.Tensor) else a.float().numpy()


@pytest.mark.parametrize("dt,tol", [("bf16", 5e-3), ("fp32", 1e-5)])
def test_conv3x3_matches_jax(dt, tol):
    import neurosis_tpu.ops.conv3x3 as m
    from neurosis_tpu_torch.ops.conv3x3 import conv3x3

    assert m._INTERPRET
    rng = np.random.RandomState(0)
    x = rng.randn(1, 16, 16, 128).astype(np.float32)
    w = (rng.randn(3, 3, 128, 128) * 0.05).astype(np.float32)

    jx, jw = jnp.asarray(x.copy(), J_DT[dt]), jnp.asarray(w.copy(), J_DT[dt])
    out_j = m.conv3x3(jx, jw)
    gx_j, gw_j = jax.grad(lambda a, b: jnp.sum(m.conv3x3(a, b).astype(jnp.float32) ** 2), argnums=(0, 1))(jx, jw)

    tx = torch.tensor(x.copy(), dtype=T_DT[dt], requires_grad=True)
    tw = torch.tensor(_to_oihw(w), dtype=T_DT[dt], requires_grad=True)
    out_t = conv3x3(tx, tw)
    (out_t.float() ** 2).sum().backward()

    assert rel_err(_f32(out_t.detach()), _f32(out_j)) < tol
    assert rel_err(_f32(tx.grad), _f32(gx_j)) < tol
    assert rel_err(_f32(tw.grad), _to_oihw(_f32(gw_j))) < tol


@pytest.mark.parametrize("dt,tol", [("bf16", 1e-2), ("fp32", 1e-5)])
def test_gn_silu_conv3x3_matches_jax(dt, tol):
    import neurosis_tpu.ops.conv3x3 as m
    from neurosis_tpu_torch.ops.conv3x3 import gn_silu_conv3x3

    rng = np.random.RandomState(1)
    bsz, h, w_, c, f = 2, 16, 16, 64, 96
    x = rng.randn(bsz, h, w_, c).astype(np.float32)
    a = (1.0 + 0.2 * rng.randn(bsz, c)).astype(np.float32)
    b = (0.3 * rng.randn(bsz, c)).astype(np.float32)
    w = (rng.randn(3, 3, c, f) * 0.05).astype(np.float32)

    jx, jw = jnp.asarray(x.copy(), J_DT[dt]), jnp.asarray(w.copy(), J_DT[dt])
    ja, jb = jnp.asarray(a.copy()), jnp.asarray(b.copy())
    loss = lambda *args: jnp.sum(m.gn_silu_conv3x3(*args).astype(jnp.float32) ** 2)
    out_j = m.gn_silu_conv3x3(jx, ja, jb, jw)
    g_j = jax.grad(loss, argnums=(0, 1, 2, 3))(jx, ja, jb, jw)

    tx = torch.tensor(x.copy(), dtype=T_DT[dt], requires_grad=True)
    ta = torch.tensor(a.copy(), requires_grad=True)
    tb = torch.tensor(b.copy(), requires_grad=True)
    tw = torch.tensor(_to_oihw(w), dtype=T_DT[dt], requires_grad=True)
    out_t = gn_silu_conv3x3(tx, ta, tb, tw)
    (out_t.float() ** 2).sum().backward()

    assert rel_err(_f32(out_t.detach()), _f32(out_j)) < tol
    for name, gt, gj in zip("xab", (tx.grad, ta.grad, tb.grad), g_j[:3]):
        assert rel_err(_f32(gt), _f32(gj)) < tol, name
    assert rel_err(_f32(tw.grad), _to_oihw(_f32(g_j[3]))) < tol


def test_halo_is_zero_after_activation():
    """The padding ring is zero AFTER silu (silu(b) ≠ 0): with x = 0 and a
    bias b > 0, a border pixel sees fewer non-zero taps than a centre one."""
    from neurosis_tpu_torch.ops.conv3x3 import gn_silu_conv3x3_nhwc

    x = torch.zeros(1, 4, 4, 8)
    a = torch.ones(1, 8)
    b = torch.full((1, 8), 2.0)
    w = torch.ones(3, 3, 8, 1)
    out = gn_silu_conv3x3_nhwc(x, a, b, w)[0, :, :, 0]
    act = 2.0 * torch.sigmoid(torch.tensor(2.0))
    assert torch.allclose(out[1, 1], 9 * 8 * act)
    assert torch.allclose(out[0, 0], 4 * 8 * act)


@pytest.mark.parametrize(
    "x_shape,w_shape,stride,pad,dt",
    [
        ((1, 64, 64, 640), (3, 3, 640, 640), 1, 1, "bf16"),
        ((4, 32, 32, 1280), (3, 3, 1280, 640), 1, 1, "bf16"),
        ((4, 32, 32, 1920), (3, 3, 1920, 640), 1, 1, "bf16"),
        ((1, 64, 64, 640), (1, 1, 640, 640), 1, 0, "bf16"),  # 1x1
        ((1, 64, 64, 640), (3, 3, 640, 640), 2, 1, "bf16"),  # stride
        ((1, 64, 64, 640), (3, 3, 640, 640), 1, 1, "fp32"),  # dtype
        ((1, 8, 8, 640), (3, 3, 640, 640), 1, 1, "bf16"),  # tiny
        ((1, 64, 64, 320), (3, 3, 320, 320), 1, 1, "bf16"),  # unaligned channels
        ((1, 32, 32, 960), (3, 3, 960, 640), 1, 1, "bf16"),
        ((8, 128, 128, 128), (3, 3, 128, 128), 1, 1, "bf16"),  # VAE scale
    ],
)
def test_gate_matches_jax(x_shape, w_shape, stride, pad, dt):
    """Same layers take the kernel as in JAX: the port's gate is JAX's
    conv3x3_supported without its VMEM block search."""
    from neurosis_tpu.ops.conv3x3 import conv3x3_supported as jax_gate
    from neurosis_tpu_torch.ops.conv3x3 import conv3x3_supported, gn_silu_conv3x3_supported

    want = jax_gate(x_shape, w_shape, stride, pad, J_DT[dt])
    assert conv3x3_supported(x_shape, w_shape, stride, pad, T_DT[dt]) == want
    assert gn_silu_conv3x3_supported(x_shape, w_shape, stride, pad, T_DT[dt]) == want


def test_conv2d_dispatch(monkeypatch):
    """Conv2d sends gated bf16 convs to the conv3x3 entry and the rest to
    F.conv2d, with identical results either way on the CPU."""
    import neurosis_tpu_torch.modules.layers as layers

    calls = []
    real = layers.conv3x3
    monkeypatch.setattr(layers, "conv3x3", lambda x, w: calls.append(x.shape) or real(x, w))
    g = torch.Generator().manual_seed(0)
    conv = layers.Conv2d(128, 128, 3, dtype=torch.bfloat16, device="cpu")
    layers.init_parameters(conv, g)
    x = torch.randn(1, 32, 32, 128, generator=g)
    y = conv(x)
    assert calls == [(1, 32, 32, 128)] and y.dtype == torch.bfloat16
    conv(x[:, :16, :16])  # 256 pixels: below the gate
    assert len(calls) == 1


def _picker_shapes():
    """(B, H, W, C, F) of every launch chip_smoke.py's conv tables give the
    kernel (forward, dgrad with C and F swapped, fused), and the card tests'."""
    import chip_smoke as cs

    shapes = set()
    for table in (cs.CONV_SHAPES, cs.VAE_CONV_SHAPES, cs.SDXL_CONV_SHAPES):
        for b, h, w, c, f in table:
            shapes |= {(b, h, w, c, f), (b, h, w, f, c)}
    for table in (cs.GN_CONV_SHAPES, cs.VAE_GN_CONV_SHAPES, cs.SDXL_GN_CONV_SHAPES):
        shapes |= set(table)
    shapes |= {(2, 32, 32, 128, 256), (1, 32, 32, 256, 128), (1, 64, 64, 64, 64), (2, 16, 48, 96, 192),
               (1, 40, 28, 128, 128), (1, 7, 200, 64, 64), (2, 32, 32, 1280, 1280), (8, 64, 64, 512, 512),
               (1, 9, 201, 1920, 192), (1, 32, 32, 32, 64), (2, 32, 32, 128, 64)}
    return sorted(shapes)


@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("shape", _picker_shapes())
def test_conv_tile_covers_every_output_once(shape, prologue):
    """The kernel's blocks, as the picked tile lays them out (block (n, img, i,
    j): channels n·bn.., rows i·tr.., columns j·cw.., the overhang masked),
    cover each output pixel and channel exactly once, and a block's shared
    memory fits the H100's 232,448 bytes."""
    from neurosis_tpu_torch.ops.conv3x3 import MAX_SMEM, TILE_PIXELS, conv_smem_bytes, conv_tile

    b, h, w, _c, f = shape
    tr, cw, bn = conv_tile(b, h, w, f, 132, prologue)
    assert 1 <= tr <= h and 1 <= cw <= w and tr * cw <= TILE_PIXELS and bn in (64, 128, 160, 256) and f % bn == 0
    assert conv_smem_bytes(tr, cw, bn) <= MAX_SMEM
    hits = np.zeros((b, h, w, f), np.int32)
    for n0 in range(0, f, bn):
        for img in range(b):
            for h0 in range(0, h, tr):
                for w0 in range(0, w, cw):
                    hits[img, h0:h0 + tr, w0:w0 + cw, n0:n0 + bn] += 1
    assert (hits == 1).all()


def test_conv_tile_at_the_main_shapes():
    """8×16 pixel tiles at 64×64 and 32×32 (180 halo pixels for 128); at
    2×32×32 and 1280 channels 160-channel blocks (128 blocks, one wave on
    132 SMs) rather than 128 (160 blocks, 1.2 waves); the VAE's 512 channels
    in two blocks of 256; with the prologue, whose cost a block pays at any
    width, the widest block at 2×64×64×1280."""
    from neurosis_tpu_torch.ops.conv3x3 import conv_tile

    assert conv_tile(2, 32, 32, 1280, 132) == (8, 16, 160)
    assert conv_tile(8, 64, 64, 512, 132) == (8, 16, 256)
    assert conv_tile(2, 64, 64, 1280, 132) == (8, 16, 160)
    assert conv_tile(2, 64, 64, 1280, 132, prologue=True) == (8, 16, 256)
    assert conv_tile(1, 7, 200, 64, 132) == (7, 17, 64)  # twelve column tiles, the last ragged
