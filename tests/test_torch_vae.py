"""The port's VAE modules against their JAX twins at vae-tiny widths on the
CPU (configs/smoke/vae-tiny.yaml: ch 32, ch_mult [1, 2], 1 res block,
64 px): dequant, DiagonalGaussian, ResnetBlock in both branches,
VAEAttnBlock, Encoder, Decoder, AutoencoderKL.

Parameters come from the JAX init, perturbed so zero-init layers count, and
load with strict=True; inputs are seeded numpy copied into both frameworks.
fp32 holds the algorithm: forward within 1e-5 of the largest value for one
block, 1e-4 through a whole Encoder/Decoder; grads within 1e-4 (blocks) and
5e-4 (Encoder/Decoder, dozens of layers of fp32 sums in another order). The
bf16 fused ResnetBlock is held to 1.5e-2, the bf16 noise bound of
tests/test_fused_gn_conv.py.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import check_grads, load_into, one_torch_thread, perturb, rel_err, t  # noqa: E402,F401

os.environ.setdefault("NEUROSIS_PALLAS_INTERPRET", "1")
CPU = "cpu"
TINY_DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=64, z_channels=2,
               dropout=0.0)


def _fwd_and_grads(jm, m, p, x, tol_fwd, tol_grad):
    jx = jnp.asarray(x.copy())
    apply = jax.jit(lambda p_, a: jm.apply({"params": p_}, a))
    gp, gx = jax.jit(jax.grad(lambda p_, a: jnp.sum(apply(p_, a) ** 2), argnums=(0, 1)))(p, jx)
    tx = t(x, requires_grad=True)
    out = m(tx)
    assert rel_err(out.detach().numpy(), apply(p, jx)) < tol_fwd
    (out**2).sum().backward()
    assert rel_err(tx.grad.numpy(), gx) < tol_grad
    check_grads(m, gp, tol_grad)


def test_dequant_matches_jax():
    from neurosis_tpu.ops.dequant import dequant_image as jdq
    from neurosis_tpu_torch.ops.dequant import dequant_image

    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    got = dequant_image(torch.tensor(x.copy())).numpy()
    np.testing.assert_array_equal(got, np.asarray(jdq(jnp.asarray(x.copy()))))
    f = torch.rand(2, 3)
    assert dequant_image(f) is f


def test_diagonal_gaussian_matches_jax():
    from neurosis_tpu.modules.distributions import DiagonalGaussian as JDG
    from neurosis_tpu_torch.modules.distributions import DiagonalGaussian

    rng = np.random.RandomState(0)
    moments = (rng.randn(2, 4, 4, 8) * 4).astype(np.float32)
    moments[0, 0, 0, 4:] = [-40.0, 25.0, -30.0, 20.0]  # past the logvar clip at both ends
    eps = rng.randn(2, 4, 4, 4).astype(np.float32)
    jd = JDG.from_moments(jnp.asarray(moments.copy()))
    d = DiagonalGaussian.from_moments(t(moments))
    assert rel_err(d.logvar.numpy(), jd.logvar) == 0.0
    np.testing.assert_allclose(d.sample(eps=t(eps)).numpy(), np.asarray(jd.mean + jd.std * jnp.asarray(eps.copy())),
                               rtol=1e-6, atol=1e-6)
    assert rel_err(d.mode().numpy(), jd.mode()) == 0.0
    np.testing.assert_allclose(d.kl().numpy(), np.asarray(jd.kl()), rtol=1e-6)
    # drawn noise comes from the generator: one seed, one sample
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    assert torch.equal(d.sample(g1), d.sample(g2))


@pytest.mark.parametrize("c_in,c_out", [(32, 64), (64, 64)])
def test_resnet_block_fp32(c_in, c_out):
    from neurosis_tpu.models.vae import ResnetBlock as JRB
    from neurosis_tpu_torch.models.vae import ResnetBlock

    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, c_in).astype(np.float32)
    jm = JRB(in_channels=c_in, out_channels=c_out)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 2)
    m = ResnetBlock(c_in, c_out, device=CPU)
    load_into(m, p)
    assert not m._fuse_ok(t(x))
    _fwd_and_grads(jm, m, p, x, 1e-5, 1e-4)


def test_resnet_block_bf16_fused(monkeypatch):
    """At 32×32 with 128 → 256 channels in bf16 both packages run both
    norm→silu→conv pairs through the fused kernel (JAX interpreted, the
    port's plain version)."""
    from neurosis_tpu.models.vae import ResnetBlock as JRB
    from neurosis_tpu_torch.models.vae import ResnetBlock

    monkeypatch.setenv("NEUROSIS_FUSED_GN_CONV", "1")
    rng = np.random.RandomState(3)
    x = rng.randn(1, 32, 32, 128).astype(np.float32)
    jm = JRB(in_channels=128, out_channels=256, dtype=jnp.bfloat16)
    jx = jnp.asarray(x.copy(), jnp.bfloat16)
    p = perturb(jm.init(jax.random.PRNGKey(0), jx)["params"], 4)
    m = ResnetBlock(128, 256, dtype=torch.bfloat16, device=CPU)
    load_into(m, p)
    tx = t(x, torch.bfloat16)
    assert m._fuse_ok(tx) and m._fuse_ok(torch.empty(1, 32, 32, 256, dtype=torch.bfloat16))
    want = np.asarray(jm.apply({"params": p}, jx), np.float32)
    assert rel_err(m(tx).float().detach().numpy(), want) < 1.5e-2


def test_vae_attn_block():
    """1024 tokens: the port's dispatch takes the flash path (its plain
    version here), JAX its XLA attention on the CPU."""
    from neurosis_tpu.models.vae import VAEAttnBlock as JAB
    from neurosis_tpu_torch.models.vae import VAEAttnBlock
    from neurosis_tpu_torch.ops.attention import uses_flash

    rng = np.random.RandomState(5)
    x = rng.randn(2, 32, 32, 64).astype(np.float32)
    jm = JAB(in_channels=64)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 6)
    m = VAEAttnBlock(64, device=CPU)
    load_into(m, p)
    assert uses_flash(torch.empty(2, 1, 1024, 64), None)
    _fwd_and_grads(jm, m, p, x, 1e-5, 1e-4)


def test_encoder_decoder_tiny():
    from neurosis_tpu.models.vae import Decoder as JDec
    from neurosis_tpu.models.vae import Encoder as JEnc
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    rng = np.random.RandomState(7)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    jenc = JEnc(**TINY_DD, double_z=True, in_channels=3)
    p = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 8)
    enc = Encoder(**TINY_DD, double_z=True, in_channels=3, device=CPU)
    load_into(enc, p)
    _fwd_and_grads(jenc, enc, p, x, 1e-4, 5e-4)

    z = rng.randn(2, 32, 32, 2).astype(np.float32)
    jdec = JDec(**TINY_DD, out_ch=3)
    p = perturb(jdec.init(jax.random.PRNGKey(1), jnp.asarray(z.copy()))["params"], 9)
    dec = Decoder(**TINY_DD, out_ch=3, device=CPU)
    load_into(dec, p)
    _fwd_and_grads(jdec, dec, p, z, 1e-4, 5e-4)


def test_autoencoder_kl_encode_decode():
    from neurosis_tpu.models.autoencoder import AutoencoderKL as JAE
    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL

    dd = dict(TINY_DD, z_channels=4, double_z=True, in_channels=3, out_ch=3)
    rng = np.random.RandomState(10)
    x = rng.uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    jm = JAE(ddconfig=dd, embed_dim=4)
    jx = jnp.asarray(x.copy())
    p = perturb(jm.init(jax.random.PRNGKey(0), jx)["params"], 11)
    m = AutoencoderKL(dd, embed_dim=4, device=CPU)
    load_into(m, p)
    moments = m.encode(t(x))
    assert tuple(moments.shape) == (2, 32, 32, 8)
    assert rel_err(moments.detach().numpy(), jm.apply({"params": p}, jx, method="encode")) < 1e-4
    z = rng.randn(2, 32, 32, 4).astype(np.float32)
    want = jm.apply({"params": p}, jnp.asarray(z.copy()), method="decode")
    assert rel_err(m.decode(t(z)).detach().numpy(), want) < 1e-4
    assert rel_err(m(t(x)).detach().numpy(), jm.apply({"params": p}, jx)) < 1e-4
