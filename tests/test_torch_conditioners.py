"""The conditioners the port refused before: T5 and ByT5, FrozenCLIPT5Encoder
(its two streams, the conditioner's concatenation, one UCG draw for both
streams, the per-stream uncond ids), IdentityEncoder, ClassEmbedder (its UCG
class) and ClassEmbedderForMultiCond, GaussianEncoder, SpatialRescaler and
LowScaleEncoder (JAX's noise level and noise replayed), each against its JAX
twin at tiny dims with the weights carried across by
``jax_params_to_state_dict`` (``strict=True``); the classes resolve from
their reference class paths; and one SD train step whose conditioner holds
FrozenCLIPT5Encoder, against JAX's components composed into the same step.

fp32 throughout; outputs within atol 1e-5 / rtol 1e-4 unless a test says.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import grads_by_key, load_into, one_torch_thread, perturb, to_np  # noqa: E402,F401

T5 = dict(vocab_size=100, d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)  # tests/test_t5_parity.py's
CLIP_T5 = dict(clip_width=64, clip_layers=2, clip_heads=2, t5_d_model=32, t5_d_kv=8, t5_d_ff=64, t5_num_layers=2,
               t5_num_heads=4, t5_vocab_size=100)
TOL = dict(atol=1e-5, rtol=1e-4)


def _ids(rng, b: int, vocab: int, length: int = 77) -> np.ndarray:
    return rng.randint(1, vocab, size=(b, length)).astype(np.int64)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


@pytest.mark.parametrize("gated_act", [True, False])
def test_t5_encoder_matches_jax(gated_act):
    from neurosis_tpu.models.text_encoder.t5 import T5EncoderModel as JT5
    from neurosis_tpu_torch.models.text_encoder.t5 import T5EncoderModel

    ids = _ids(np.random.RandomState(0), 2, T5["vocab_size"])
    ids[:, 40:] = 0  # pad, attended as the reference's fixed-length batches are
    jm = JT5(**T5, gated_act=gated_act)
    params = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 1)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(ids.copy())))
    model = T5EncoderModel(**T5, gated_act=gated_act, device="cpu")
    load_into(model, params)
    np.testing.assert_allclose(_np(model(torch.tensor(ids))), want, **TOL)


def test_t5_relative_position_buckets_match_jax():
    from neurosis_tpu.models.text_encoder.t5 import _rel_pos_bucket as jax_bucket
    from neurosis_tpu_torch.models.text_encoder.t5 import _rel_pos_bucket

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 77)[:, None]
    for buckets, distance in ((32, 128), (16, 64)):
        want = np.asarray(jax_bucket(jnp.asarray(rel), buckets, distance))
        np.testing.assert_array_equal(_rel_pos_bucket(torch.tensor(rel), buckets, distance).numpy(), want)


def test_byt5_tokenize_matches_jax():
    from neurosis_tpu.models.text_encoder.t5 import byt5_tokenize as jax_tok
    from neurosis_tpu_torch.models.text_encoder.t5 import byt5_tokenize

    texts = ["ab", "hello world", "crème brûlée, 東京", "x" * 100, ""]
    for n in (8, 77):
        np.testing.assert_array_equal(byt5_tokenize(texts, n), jax_tok(texts, n))
    assert byt5_tokenize("ab", 8).shape == (1, 8)


@pytest.mark.parametrize("cls", ["FrozenT5Embedder", "FrozenByT5Embedder"])
def test_t5_embedders_match_jax(cls):
    from neurosis_tpu.models.text_encoder import t5 as jt5
    from neurosis_tpu_torch.models.text_encoder import t5

    small = dict(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
    jemb = getattr(jt5, cls)(input_key="txt", **small)
    emb = getattr(t5, cls)(input_key="txt", **small, device="cpu")
    assert emb.token_key() == jemb.token_key() == "txt_t5_ids"
    assert emb.transformer.shared.weight.shape[0] == jemb.vocab_size
    ids = _ids(np.random.RandomState(1), 2, jemb.vocab_size)
    params = perturb(jemb.init(jax.random.PRNGKey(2), jnp.asarray(ids.copy()))["params"], 3)
    load_into(emb, params)
    assert not any(p.requires_grad for p in emb.parameters())
    (want,) = jemb.apply({"params": params}, jnp.asarray(ids.copy()))
    np.testing.assert_allclose(_np(emb(torch.tensor(ids))[0]), np.asarray(want), **TOL)


def _clip_t5_pair(seed: int = 4, ucg_rate: float = 0.5):
    from neurosis_tpu.modules.encoders.clip_t5 import FrozenCLIPT5Encoder as JCT5
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names
    from neurosis_tpu_torch.modules.encoders.clip_t5 import FrozenCLIPT5Encoder
    from neurosis_tpu_torch.modules.encoders.embedding import GeneralConditioner

    rng = np.random.RandomState(seed)
    batch = {"caption_ids": _ids(rng, 2, 49000), "caption_t5_ids": _ids(rng, 2, 100),
             "uncond_ids": _ids(rng, 1, 49000), "uncond_t5_ids": _ids(rng, 1, 100)}
    jcond = JCond(embedders=with_embedder_names([JCT5(**CLIP_T5, ucg_rate=ucg_rate)]))
    jb = {k: jnp.asarray(v.copy()) for k, v in batch.items()}
    params = perturb(jcond.init(jax.random.PRNGKey(5), jb, rng=None)["params"], 6)
    cond = GeneralConditioner([FrozenCLIPT5Encoder(**CLIP_T5, ucg_rate=ucg_rate, device="cpu")])
    load_into(cond, params)
    return jcond, params, cond, batch


def test_clip_t5_streams_and_concatenation_match_jax():
    jcond, params, cond, batch = _clip_t5_pair()
    emb = cond.embedders[0]
    assert emb.token_keys() == jcond.embedders[0].token_keys() == ["caption_ids", "caption_t5_ids"]
    assert emb.token_key() is None
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    clip_z, t5_z = emb((tb["caption_ids"], tb["caption_t5_ids"]))
    jclip, jt5 = jcond.embedders[0].apply({"params": params["embedders_0"]},
                                          (jnp.asarray(batch["caption_ids"].copy()),
                                           jnp.asarray(batch["caption_t5_ids"].copy())))
    np.testing.assert_allclose(_np(clip_z), np.asarray(jclip), **TOL)
    np.testing.assert_allclose(_np(t5_z), np.asarray(jt5), **TOL)
    out = cond(tb)
    want = jcond.apply({"params": params}, {k: jnp.asarray(v.copy()) for k, v in batch.items()}, rng=None)
    assert set(out) == set(want) == {"crossattn"} and out["crossattn"].shape == (2, 77, 64 + 32)
    np.testing.assert_allclose(_np(out["crossattn"]), np.asarray(want["crossattn"]), **TOL)


@pytest.mark.parametrize("own_t5_uncond", [True, False])
def test_clip_t5_ucg_swaps_both_streams_on_one_draw(own_t5_uncond):
    """One UCG draw swaps both streams, each to its own uncond row
    (``uncond_t5_ids``, else ``uncond_ids``), as JAX's conditioner does; and
    the CFG uncond batch is built alike."""
    jcond, params, cond, batch = _clip_t5_pair(7)
    if not own_t5_uncond:
        del batch["uncond_t5_ids"]
        batch["uncond_ids"] = batch["uncond_ids"] % 100  # a row both vocabularies hold
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v.copy()) for k, v in batch.items()}
    swapped = dict(jb, caption_ids=jnp.broadcast_to(jb["uncond_ids"], (2, 77)),
                   caption_t5_ids=jnp.broadcast_to(jb.get("uncond_t5_ids", jb["uncond_ids"]), (2, 77)))
    want = jcond.apply({"params": params}, swapped, rng=None)["crossattn"]
    got = cond(tb, ucg=[torch.tensor(True)])["crossattn"]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    kept = cond(tb, ucg=[torch.tensor(False)])["crossattn"]
    np.testing.assert_allclose(_np(kept), np.asarray(jcond.apply({"params": params}, jb, rng=None)["crossattn"]),
                               **TOL)
    c, uc = cond.get_unconditional_conditioning(tb)
    jc, juc = jcond.get_unconditional_conditioning({"params": params}, jb)
    np.testing.assert_allclose(_np(uc["crossattn"]), np.asarray(juc["crossattn"]), **TOL)
    np.testing.assert_allclose(_np(uc["crossattn"]), np.asarray(want), **TOL)


def test_class_embedders_match_jax():
    from neurosis_tpu.modules.encoders.misc import ClassEmbedder as JCls
    from neurosis_tpu.modules.encoders.misc import ClassEmbedderForMultiCond as JMulti
    from neurosis_tpu_torch.modules.encoders.misc import ClassEmbedder, ClassEmbedderForMultiCond

    c = np.array([1, 2, 9])  # 9: the UCG class
    for seq in (False, True):
        jemb = JCls(embed_dim=16, n_classes=10, add_sequence_dim=seq, input_key="cls")
        params = jemb.init(jax.random.PRNGKey(0), jnp.asarray(c))["params"]
        assert params["embedding"]["embedding"].shape == (10, 16)
        emb = ClassEmbedder(embed_dim=16, n_classes=10, add_sequence_dim=seq, input_key="cls", device="cpu")
        load_into(emb, params)
        assert emb.uncond_class() == jemb.uncond_class() == 9
        (want,) = jemb.apply({"params": params}, jnp.asarray(c))
        np.testing.assert_array_equal(_np(emb(torch.tensor(c))[0]), np.asarray(want))
        multi = ClassEmbedderForMultiCond(embed_dim=16, n_classes=10, add_sequence_dim=seq, device="cpu")
        load_into(multi, params)
        (jm,) = JMulti(embed_dim=16, n_classes=10, add_sequence_dim=seq).apply({"params": params},
                                                                              [jnp.asarray(c), jnp.asarray(c)])
        np.testing.assert_array_equal(_np(multi([torch.tensor(c), torch.tensor(c)])[0]), np.asarray(jm))


def test_class_embedder_in_the_conditioner_zeroes_ucg_rows_as_jax():
    """A numeric embedder's UCG zeroes whole rows; with the keep mask JAX
    draws replayed, the conditioner's 'vector' matches JAX's."""
    from neurosis_tpu.modules.encoders.embedding import GeneralConditioner as JCond
    from neurosis_tpu.modules.encoders.embedding import with_embedder_names
    from neurosis_tpu.modules.encoders.misc import ClassEmbedder as JCls
    from neurosis_tpu_torch.modules.encoders.embedding import GeneralConditioner
    from neurosis_tpu_torch.modules.encoders.misc import ClassEmbedder

    batch = {"cls": np.array([3, 1, 9, 4])}
    jcond = JCond(embedders=with_embedder_names([JCls(embed_dim=8, n_classes=10, input_key="cls", ucg_rate=0.5)]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jcond.init(jax.random.PRNGKey(1), jb, rng=None)["params"]
    key = jax.random.PRNGKey(9)
    want = jcond.apply({"params": params}, jb, rng=key)["vector"]
    # JAX's draw: split(rng) → sub; bernoulli(sub, 1 - rate, (B,))
    keep = np.asarray(jax.random.bernoulli(jax.random.split(key)[1], 0.5, (4,)))
    assert 0 < keep.sum() < 4
    cond = GeneralConditioner([ClassEmbedder(embed_dim=8, n_classes=10, input_key="cls", ucg_rate=0.5,
                                             device="cpu")])
    load_into(cond, params)
    got = cond({k: torch.tensor(v) for k, v in batch.items()}, ucg=[torch.tensor(keep)])["vector"]
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_identity_encoder_passes_through():
    from neurosis_tpu.modules.encoders.embedding import IdentityEncoder as JId
    from neurosis_tpu_torch.config.registry import resolve_class_path

    cls = resolve_class_path("neurosis.modules.encoders.misc.IdentityEncoder")
    x = np.random.RandomState(2).randn(2, 5).astype(np.float32)
    (want,) = JId(input_key="v").apply({}, jnp.asarray(x))
    np.testing.assert_array_equal(_np(cls(input_key="v")(torch.tensor(x))[0]), np.asarray(want))


def test_gaussian_encoder_matches_jax():
    from neurosis_tpu.modules.encoders.misc import GaussianEncoder as JGauss
    from neurosis_tpu_torch.modules.encoders.misc import GaussianEncoder

    x = np.random.RandomState(3).randn(2, 16, 16, 3).astype(np.float32)
    for flatten in (True, False):
        jenc = JGauss(ch=32, ch_mult=(1, 2), resolution=16, flatten_output=flatten, input_key="img")
        params = perturb(jenc.init(jax.random.PRNGKey(3), jnp.asarray(x.copy()))["params"], 4)
        enc = GaussianEncoder(ch=32, ch_mult=(1, 2), resolution=16, flatten_output=flatten, input_key="img",
                              device="cpu")
        load_into(enc, params)
        (want,) = jenc.apply({"params": params}, jnp.asarray(x.copy()))
        (got,) = enc(torch.tensor(x))
        assert got.shape == ((2, 64, 4) if flatten else (2, 8, 8, 4))
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("method,stages,mult,out_ch", [("bilinear", 2, 0.5, 8), ("bicubic", 1, 0.5, None),
                                                      ("nearest", 1, 0.5, None), ("bilinear", 1, 1.5, 5),
                                                      ("bicubic", 1, 0.75, None)])
def test_spatial_rescaler_matches_jax(method, stages, mult, out_ch):
    from neurosis_tpu.modules.encoders.misc import SpatialRescaler as JRes
    from neurosis_tpu_torch.modules.encoders.misc import SpatialRescaler

    x = np.random.RandomState(4).randn(2, 16, 12, 3).astype(np.float32)
    kw = dict(n_stages=stages, multiplier=mult, out_channels=out_ch, method=method, input_key="img")
    jres = JRes(**kw)
    params = jres.init(jax.random.PRNGKey(5), jnp.asarray(x.copy())).get("params", {})
    res = SpatialRescaler(**kw, device="cpu")
    if params:
        load_into(res, params)
    (want,) = jres.apply({"params": params}, jnp.asarray(x.copy()))
    (got,) = res(torch.tensor(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_model", [False, True])
def test_lowscale_encoder_matches_jax_with_its_draws(with_model):
    """JAX's noise level and noise (from the key it is given) passed in."""
    from neurosis_tpu.models.autoencoder import AutoencoderKL as JAE
    from neurosis_tpu.modules.encoders.misc import LowScaleEncoder as JLow
    from neurosis_tpu_torch.models.autoencoder import AutoencoderKL
    from neurosis_tpu_torch.modules.encoders.misc import LowScaleEncoder

    dd = dict(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[], resolution=16, z_channels=4,
              double_z=True, in_channels=3, out_ch=3, dropout=0.0)
    x = np.random.RandomState(5).randn(2, 16, 16, 3).astype(np.float32)
    jlow = JLow(model=JAE(ddconfig=dd, embed_dim=4) if with_model else None, output_size=12, max_noise_level=100,
                scale_factor=0.5, input_key="img")
    key = jax.random.PRNGKey(2)
    variables = jlow.init(jax.random.PRNGKey(0), jnp.asarray(x.copy()), rng=jax.random.PRNGKey(1))
    params = perturb(variables["params"], 6) if variables.get("params") else {}
    z, level = jlow.apply({"params": params}, jnp.asarray(x.copy()), rng=key)
    rng_level, rng_noise = jax.random.split(key)
    draws_level = np.asarray(jax.random.randint(rng_level, (2,), 0, 100))
    np.testing.assert_array_equal(draws_level, np.asarray(level))
    z_shape = (2, 8, 8, 4) if with_model else x.shape
    noise = np.asarray(jax.random.normal(rng_noise, z_shape, jnp.float32))

    model = AutoencoderKL(dd, embed_dim=4, device="cpu") if with_model else None
    low = LowScaleEncoder(model=model, output_size=12, max_noise_level=100, scale_factor=0.5, input_key="img")
    if with_model:  # JAX's encode-only use creates no decoder parameters: the port's keep their own
        from neurosis_tpu_torch.checkpoint.convert import jax_params_to_state_dict

        converted = jax_params_to_state_dict(to_np(params))
        own = {k for k in low.state_dict() if k not in converted}
        assert own and all(k.startswith(("model.decoder.", "model.post_quant_conv.")) for k in own), own
        low.load_state_dict({**low.state_dict(), **converted}, strict=True)
    got, got_level = low(torch.tensor(x), noise_level=torch.tensor(draws_level), noise=torch.tensor(noise))
    np.testing.assert_array_equal(got_level.numpy(), np.asarray(level))
    assert got.shape == z.shape == (2, 12, 12, z_shape[-1])
    np.testing.assert_allclose(_np(got), np.asarray(z), **TOL)
    g = torch.Generator().manual_seed(0)
    _, drawn = low(torch.tensor(x), generator=g)
    assert drawn.shape == (2,) and int(drawn.max()) < 100


@pytest.mark.parametrize("path,kwargs", [
    ("neurosis.models.text_encoder.FrozenCLIPT5Encoder", CLIP_T5),
    ("neurosis.modules.encoders.misc.IdentityEncoder", {}),
    ("neurosis.modules.encoders.classed.ClassEmbedder", dict(embed_dim=4, n_classes=3)),
    ("neurosis.modules.encoders.classed.ClassEmbedderForMultiCond", dict(embed_dim=4, n_classes=3)),
    ("neurosis.modules.encoders.metadata.GaussianEncoder", dict(ch=32, resolution=16)),
    ("neurosis.modules.encoders.embedding.SpatialRescaler", dict(out_channels=2)),
    ("neurosis.modules.encoders.lowscale.LowScaleEncoder", dict(output_size=4)),
])
def test_the_conditioners_resolve_from_their_reference_paths(path, kwargs):
    from neurosis_tpu.config.registry import resolve_class_path as jax_resolve
    from neurosis_tpu_torch.config.loader import instantiate

    built = instantiate({"class_path": path, "init_args": dict(kwargs, input_key="x")}, {"device": "cpu"})
    assert type(built).__name__ == jax_resolve(path).__name__


def test_sd_step_with_a_clip_t5_conditioner_matches_jax():
    """One DiffusionEngine.train_step whose conditioner is FrozenCLIPT5Encoder
    (crossattn 64 + 32 wide), against JAX's components with the same t and
    noise: loss and grad norm to 1e-5, each UNet grad to 2e-4 of its largest."""
    from test_torch_engine import NUM_IDX, TINY_UNET, _jax_step

    from neurosis_tpu.models.unet import UNetModel as JUNet
    from neurosis_tpu_torch.diffusion.denoiser import DiscreteDenoiser
    from neurosis_tpu_torch.diffusion.discretization import LegacyDDPMDiscretization
    from neurosis_tpu_torch.diffusion.loss import StandardDiffusionLoss
    from neurosis_tpu_torch.diffusion.sigma_generators import DiscreteSigmaGenerator
    from neurosis_tpu_torch.diffusion.preconditioning import EpsPreconditioning
    from neurosis_tpu_torch.diffusion.weighting import EpsWeighting
    from neurosis_tpu_torch.models.unet import UNetModel
    from neurosis_tpu_torch.optimizers.adafactor import Adafactor
    from neurosis_tpu_torch.trainer.engine import DiffusionEngine

    jcond, p_cond, cond, batch = _clip_t5_pair(8, ucg_rate=0.0)  # JAX's step runs its conditioner without UCG
    rng = np.random.RandomState(9)
    batch = dict(batch, latents=rng.randn(2, 16, 16, 4).astype(np.float32))
    ts, noise = np.array([0.3, 0.8], np.float32), rng.randn(2, 16, 16, 4).astype(np.float32)
    unet_cfg = dict(TINY_UNET, context_dim=96)
    jb = {k: jnp.asarray(v.copy()) for k, v in batch.items()}
    ctx = jcond.apply({"params": p_cond}, jb, rng=None)["crossattn"]
    junet = JUNet(**unet_cfg)
    p_unet = perturb(junet.init(jax.random.PRNGKey(0), jb["latents"], jnp.zeros((2,)), ctx)["params"], 10)
    tx, jstep = _jax_step(junet, jcond, p_cond, True)
    jparams = jax.tree_util.tree_map(jnp.asarray, p_unet)
    from neurosis_tpu.modules.ema import ema_init

    _, _, _, jloss, jgrads, jnorm = jstep(jparams, tx.init(jparams), ema_init(jparams), jb,
                                          jnp.asarray(ts.copy()), jnp.asarray(noise.copy()))

    unet = UNetModel(**unet_cfg, device="cpu")
    load_into(unet, p_unet)
    disc = LegacyDDPMDiscretization()
    engine = DiffusionEngine(
        model=unet, first_stage=None, conditioner=cond,
        denoiser=DiscreteDenoiser(EpsPreconditioning(), NUM_IDX, disc, device="cpu"),
        loss_fn=StandardDiffusionLoss(DiscreteSigmaGenerator(disc, NUM_IDX, device="cpu"), EpsWeighting()),
        optimizer=lambda ps: Adafactor(ps, scale_parameter=True, relative_step=True, warmup_init=True),
        use_ema=True, ema_decay=0.9999, device="cpu")
    state = engine.init(seed=0)
    tb = {k: torch.tensor(v.copy()) for k, v in batch.items()}
    state, metrics = engine.train_step(state, tb, t=torch.tensor(ts), noise=torch.tensor(noise))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-5)
    want = grads_by_key(jgrads)
    floor = 1e-3 * max(float(np.abs(g).max()) for g in want.values())
    for n, p in engine.model.named_parameters():
        scale = max(float(np.abs(want[n]).max()), floor)
        assert float(np.abs(p.grad.numpy() - want[n]).max()) / scale < 2e-4, n


def test_trainer_tokenizes_the_t5_stream_as_jax(tmp_path):
    """``Trainer(t5_tokenizer=...)`` adds ``caption_t5_ids`` and the empty
    prompt's ``uncond_t5_ids`` beside the CLIP ids, as JAX's loop does; an
    engine whose conditioner reads a T5 stream that nothing makes raises."""
    import types

    from neurosis_tpu.modules.encoders.clip_t5 import FrozenCLIPT5Encoder as JCT5
    from neurosis_tpu.trainer.loop import HashTokenizer as JHash
    from neurosis_tpu.trainer.loop import Trainer as JTrainer
    from neurosis_tpu_torch.models.text_encoder.t5 import byt5_tokenize
    from neurosis_tpu_torch.modules.encoders.clip_t5 import FrozenCLIPT5Encoder
    from neurosis_tpu_torch.trainer.loop import HashTokenizer, Trainer

    def engine(emb):
        return types.SimpleNamespace(conditioner=types.SimpleNamespace(embedders=[emb]), device=torch.device("cpu"))

    batch = {"caption": ["a cat", "two dogs on a sofa"], "image": np.zeros((2, 4, 4, 3), np.uint8)}
    port = Trainer(engine(FrozenCLIPT5Encoder(**CLIP_T5, device="cpu")), default_root_dir=str(tmp_path / "p"),
                   tokenizer=HashTokenizer(), t5_tokenizer=byt5_tokenize)
    jax_trainer = JTrainer(engine(JCT5(**CLIP_T5)), default_root_dir=str(tmp_path / "j"), tokenizer=JHash(),
                           t5_tokenizer=byt5_tokenize)
    got, want = port._host_arrays(batch), jax_trainer.prepare_batch(batch)
    assert set(got) == set(want) == {"caption_ids", "caption_t5_ids", "uncond_ids", "uncond_t5_ids", "image"}
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    bare = Trainer(engine(FrozenCLIPT5Encoder(**CLIP_T5, device="cpu")), default_root_dir=str(tmp_path / "b"),
                   tokenizer=HashTokenizer())
    with pytest.raises(ValueError, match="expects T5 token ids"):
        bare._host_arrays(batch)
