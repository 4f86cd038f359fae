"""The Encoder/Decoder options of the port's VAE (neurosis_tpu_torch/models/vae.py),
the pixel-space ``Model`` and the two autoencoder wrappers, against the JAX
package on the CPU at tiny widths (ch 32, one or two levels, 16-32 px).

Parameters come from the JAX init, perturbed so zero-init layers count, and
load with strict=True. fp32: forwards and the grads of the input within
1e-5 of the largest value; the parameters' grads within 5e-4, as in
test_torch_vae.py (a bias' grad sums a large grad over every position, so
fp32 sums in another order cancel to ~2e-4). Remat is held to the same network without it
at 1e-6. Dropout masks cannot match JAX's bit for bit: p = 0 and eval are
held exactly, and the train-mode keep share within a binomial bound.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import check_grads, load_into, one_torch_thread, perturb, rel_err, t  # noqa: E402,F401

CPU = "cpu"
DD = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, resolution=32, z_channels=4)


def _fwd_and_grads(jm, m, p, x, tol_fwd=1e-5, tol_grad=5e-4, tol_in=None, **kw):
    jx = jnp.asarray(x.copy())
    apply = jax.jit(lambda p_, a: jm.apply({"params": p_}, a, **kw))
    gp, gx = jax.jit(jax.grad(lambda p_, a: jnp.sum(apply(p_, a) ** 2), argnums=(0, 1)))(p, jx)
    tx = t(x, requires_grad=True)
    out = m(tx, **kw)
    assert rel_err(out.detach().numpy(), apply(p, jx)) < tol_fwd
    (out**2).sum().backward()
    assert rel_err(tx.grad.numpy(), gx) < (tol_in or tol_fwd)
    check_grads(m, gp, tol_grad)


OPTIONS = {  # name: (Encoder/Decoder keyword arguments, decoder-only ones)
    "in_level_attention": (dict(attn_resolutions=[16, 32]), {}),
    "linear_attention": (dict(attn_resolutions=[16], attn_type="linear"), {}),
    "no_attention": (dict(attn_resolutions=[16], attn_type="none"), {}),
    "resample_without_conv": (dict(resamp_with_conv=False, attn_resolutions=[16]), {}),
    "give_pre_end": (dict(attn_resolutions=[]), dict(give_pre_end=True)),
    "tanh_out": (dict(attn_resolutions=[]), dict(tanh_out=True)),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_encoder_and_decoder_options_match_jax(name):
    from neurosis_tpu.models.vae import Decoder as JDec
    from neurosis_tpu.models.vae import Encoder as JEnc
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    kw, dec_kw = OPTIONS[name]
    # linear attention has no norm before it and no residual: the Decoder's
    # image is a product of the blocks' token sums over un-normalised
    # features (|x| ~ 30, a near-saturated softmax of k), so the fp32 noise
    # of one block (< 1e-6, test_linear_attention_block_matches_jax) reaches
    # 1.2e-5 in the image and 3.2e-4 in the latent's grad
    tol, tol_in = (2e-5, 5e-4) if kw.get("attn_type") == "linear" else (1e-5, None)
    rng = np.random.RandomState(1)
    if not dec_kw:
        x = rng.randn(2, 32, 32, 3).astype(np.float32)
        jenc = JEnc(**DD, **kw)
        p = perturb(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 2)
        enc = Encoder(**DD, **kw, device=CPU)
        load_into(enc, p)
        _fwd_and_grads(jenc, enc, p, x, tol, tol_in=tol_in)
    z = rng.randn(2, 16, 16, 4).astype(np.float32)
    jdec = JDec(out_ch=3, **DD, **kw, **dec_kw)
    p = perturb(jdec.init(jax.random.PRNGKey(1), jnp.asarray(z.copy()))["params"], 3)
    dec = Decoder(out_ch=3, **DD, **kw, **dec_kw, device=CPU)
    load_into(dec, p)
    _fwd_and_grads(jdec, dec, p, z, tol, tol_in=tol_in)
    if dec_kw.get("give_pre_end"):
        assert not hasattr(dec, "conv_out") and dec(t(z)).shape[-1] == 32


def test_linear_attention_block_matches_jax():
    from neurosis_tpu.models.vae import LinAttnBlock as JLin
    from neurosis_tpu_torch.models.vae import LinAttnBlock

    x = np.random.RandomState(0).randn(2, 16, 16, 64).astype(np.float32)
    jm = JLin(64)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()))["params"], 1)
    m = LinAttnBlock(64, device=CPU)
    load_into(m, p)
    _fwd_and_grads(jm, m, p, x, 1e-6, 1e-5)


def test_in_level_attention_names_and_order():
    """A block ``down.{i}.attn.{j}`` / ``up.{i}.attn.{j}`` after each
    ResnetBlock of a level whose resolution is listed."""
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    kw = dict(ch=32, ch_mult=[1, 2, 2], num_res_blocks=2, resolution=32, z_channels=4, attn_resolutions=[16])
    enc = Encoder(**kw, device="meta", generator=torch.Generator())
    dec = Decoder(out_ch=3, **kw, device="meta", generator=torch.Generator())
    attn = lambda m: sorted({".".join(k.split(".")[:4]) for k in m.state_dict() if ".attn." in k})
    assert attn(enc) == ["down.1.attn.0", "down.1.attn.1"]
    assert attn(dec) == ["up.1.attn.0", "up.1.attn.1", "up.1.attn.2"]


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_equals_no_remat(dropout):
    """Each ResnetBlock under torch.utils.checkpoint: the same loss and grads
    (1e-6), dropout's recompute drawing the same masks as its forward."""
    from neurosis_tpu_torch.models.vae import Decoder, Encoder

    x = torch.tensor(np.random.RandomState(4).randn(2, 32, 32, 3).astype(np.float32))
    kw = dict(DD, attn_resolutions=[16], dropout=dropout, device=CPU)
    results = []
    for remat in (False, True):
        enc = Encoder(**kw, remat=remat, generator=torch.Generator().manual_seed(5))
        dec = Decoder(out_ch=3, **kw, remat=remat, generator=torch.Generator().manual_seed(6))
        g = torch.Generator().manual_seed(7)
        loss = dec(enc(x, g)[..., :4], g).square().mean()
        loss.backward()
        grads = [p.grad.clone() for p in list(enc.parameters()) + list(dec.parameters())]
        results.append((loss.detach(), grads, torch.rand(1, generator=g)))
    (l0, g0, after0), (l1, g1, after1) = results
    assert rel_err(l1.numpy(), l0.numpy()) < 1e-6
    assert max(rel_err(b.numpy(), a.numpy()) for a, b in zip(g0, g1)) < 1e-6
    assert torch.equal(after0, after1)  # the generator ends where the forward's draws took it


def test_dropout_in_eval_and_at_zero_and_its_keep_share():
    from neurosis_tpu.models.vae import Decoder as JDec
    from neurosis_tpu_torch.models.vae import Decoder, ResnetBlock

    z = np.random.RandomState(8).randn(2, 16, 16, 4).astype(np.float32)
    jdec = JDec(out_ch=3, **DD, attn_resolutions=[], dropout=0.3)
    p = perturb(jdec.init(jax.random.PRNGKey(1), jnp.asarray(z.copy()))["params"], 9)
    want = np.asarray(jdec.apply({"params": p}, jnp.asarray(z.copy())))  # deterministic
    for drop in (0.3, 0.0):
        dec = Decoder(out_ch=3, **DD, attn_resolutions=[], dropout=drop, device=CPU)
        load_into(dec, p)
        assert rel_err(dec(t(z)).detach().numpy(), want) < 1e-5  # eval: no generator, no draw
        g = torch.Generator().manual_seed(0)
        state = g.get_state()
        if drop == 0.0:
            assert rel_err(dec(t(z), g).detach().numpy(), want) < 1e-5 and torch.equal(g.get_state(), state)
    from neurosis_tpu_torch.modules.layers import init_parameters

    block = ResnetBlock(32, 32, dropout=0.3, device=CPU)
    init_parameters(block, torch.Generator().manual_seed(0))
    seen = {}
    block.conv2.register_forward_pre_hook(lambda mod, args: seen.update(h=args[0]))
    block(torch.randn(4, 16, 16, 32), generator=torch.Generator().manual_seed(1))
    kept = float((seen["h"] != 0).float().mean())
    n = seen["h"].numel()
    assert abs(kept - 0.7) < 5 * (0.7 * 0.3 / n) ** 0.5  # within 5σ of the binomial share


@pytest.mark.parametrize("use_timestep,context", [(True, False), (False, False), (True, True)])
def test_pixel_space_model_matches_jax(use_timestep, context):
    from neurosis_tpu.models.vae import Model as JModel
    from neurosis_tpu.models.vae import ddpm_timestep_embedding as jemb
    from neurosis_tpu_torch.models.vae import Model, ddpm_timestep_embedding

    ts = np.array([3.0, 250.0], np.float32)
    for dim in (32, 33):  # an ulp of exp's frequency, times t = 250, moves sin by ~4e-6
        assert rel_err(ddpm_timestep_embedding(t(ts), dim).numpy(), jemb(jnp.asarray(ts), dim)) < 1e-5
    rng = np.random.RandomState(10)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    ctx = rng.randn(2, 16, 16, 2).astype(np.float32) if context else None
    kw = dict(ch=32, out_ch=3, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8], resolution=16,
              use_timestep=use_timestep)
    jm = JModel(**kw)
    jt = jnp.asarray(ts) if use_timestep else None
    jc = jnp.asarray(ctx.copy()) if context else None
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()), jt, jc)["params"], 11)
    m = Model(**kw, in_channels=5 if context else 3, device=CPU)
    load_into(m, p)
    assert ("temb.dense.0.weight" in m.state_dict()) == use_timestep
    gp, gx = jax.jit(jax.grad(lambda p_, a: jnp.sum(jm.apply({"params": p_}, a, jt, jc) ** 2), argnums=(0, 1)))(
        p, jnp.asarray(x.copy()))
    tx = t(x, requires_grad=True)
    out = m(tx, t(ts) if use_timestep else None, t(ctx) if context else None)
    assert rel_err(out.detach().numpy(), jm.apply({"params": p}, jnp.asarray(x.copy()), jt, jc)) < 1e-5
    (out**2).sum().backward()
    assert rel_err(tx.grad.numpy(), gx) < 1e-5
    check_grads(m, gp, 5e-4)


def test_autoencoder_wrappers_match_jax():
    """AutoencoderKLInferenceWrapper's encode (mode, and a sample from a
    draw), and AEIntegerWrapper's indices and decode through the codebook,
    with JAX parameter trees loaded by the wrapper itself."""
    from neurosis_tpu.models.autoencoder import AEIntegerWrapper as JAEI
    from neurosis_tpu.models.autoencoder import AutoencoderKL as JAE
    from neurosis_tpu.models.autoencoder import AutoencoderKLInferenceWrapper as JW
    from neurosis_tpu.modules.regularizers import VectorQuantizer as JVQ
    from neurosis_tpu_torch.models.autoencoder import AEIntegerWrapper, AutoencoderKL, AutoencoderKLInferenceWrapper
    from neurosis_tpu_torch.modules.regularizers import VectorQuantizer

    x = np.random.RandomState(12).uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    jx = jnp.asarray(x.copy())
    dd = dict(DD, attn_resolutions=[], double_z=True)
    jw = JW(ddconfig=dd, embed_dim=4)
    # the wrapper's own init path decodes its sample split in two: AutoencoderKL's init gives the real shapes
    p = perturb(JAE(ddconfig=dd, embed_dim=4).init(jax.random.PRNGKey(0), jx)["params"], 13)
    w = AutoencoderKLInferenceWrapper(dd, embed_dim=4, device=CPU)
    load_into(w, p)
    assert rel_err(w.encode(t(x)).detach().numpy(), jw.apply({"params": p}, jx, method="encode")) < 1e-5
    moments = w.quant_conv(w.encoder(t(x))).detach()
    g = torch.Generator().manual_seed(2)
    eps = torch.randn(moments[..., :4].shape, generator=torch.Generator().manual_seed(2))
    mean, logvar = moments.chunk(2, dim=-1)
    assert torch.allclose(w.encode(t(x), g), mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps)

    dd = dict(DD, attn_resolutions=[], double_z=False)
    jae = JAE(ddconfig=dd, embed_dim=4)
    variables = {"params": perturb(jae.init(jax.random.PRNGKey(1), jx)["params"], 14)}
    jvq = JVQ(n_e=16, e_dim=4)
    z = jae.apply(variables, jx, method="encode")
    vq_vars = {"params": {"embedding": 0.5 * np.random.RandomState(15).randn(16, 4).astype(np.float32)}}
    jwrap = JAEI(jae, variables, jvq, vq_vars, shape=(16, 16))
    wrap = AEIntegerWrapper(AutoencoderKL(dd, embed_dim=4, device=CPU), variables, VectorQuantizer(16, 4, device=CPU),
                            vq_vars, shape=(16, 16))
    idx = wrap.encode(t(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jwrap.encode(jx)))
    assert tuple(idx.shape) == (2, 256) and np.asarray(z).shape == (2, 16, 16, 4)
    assert rel_err(wrap.decode(idx).numpy(), jwrap.decode(jnp.asarray(idx.numpy()))) < 1e-5
