"""The conditioning options of the SD training path against the JAX package
on the CPU: caption dropout (UCG) through a five-embedder SDXL-layout
conditioner with JAX's own draws replayed (the text embedders' batch swaps
to the empty prompt, with and without a swap, and the size embedders'
per-sample keep masks), extended prompts ([B, chunks, 77]) through CLIP-L
and bigG, ``always_return_pooled`` on CLIP-L, and the trainer tokenizing in
chunks. Tolerances: 1e-5 of the largest value; the size embeddings 5e-4
absolute (cos and sin of arguments up to 2048 in fp32)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from test_torch_sdxl import SIZE_KEYS, TINY_BIGG, TINY_CLIP, _batch, _to_jax, _to_torch, _token_ids  # noqa: E402
from torch_parity import load_into, one_torch_thread, perturb, rel_err  # noqa: E402,F401


CPU = "cpu"
RATES = (0.5, 0.5, 0.6, 0.0, 0.6)  # CLIP-L, bigG, the three size embedders


def _conditioners(jbatch, seed, rates=RATES, **text_kw):
    from neurosis_tpu.modules.encoders import embedding as je
    from neurosis_tpu_torch.modules.encoders import embedding as te

    jembs = [je.FrozenCLIPEmbedder(ucg_rate=rates[0], **TINY_CLIP, **text_kw),
             je.FrozenOpenCLIPEmbedder2(ucg_rate=rates[1], always_return_pooled=True, legacy=False, **TINY_BIGG,
                                        **text_kw)]
    tembs = [te.FrozenCLIPEmbedder(ucg_rate=rates[0], **TINY_CLIP, **text_kw, device=CPU),
             te.FrozenOpenCLIPEmbedder2(ucg_rate=rates[1], always_return_pooled=True, legacy=False, **TINY_BIGG,
                                        **text_kw, device=CPU)]
    for key, rate in zip(SIZE_KEYS, rates[2:]):
        jembs.append(je.ConcatTimestepEmbedderND(outdim=16, input_key=key, ucg_rate=rate))
        tembs.append(te.ConcatTimestepEmbedderND(outdim=16, input_key=key, ucg_rate=rate))
    jcond = je.GeneralConditioner(embedders=je.with_embedder_names(jembs))
    p_cond = perturb(jcond.init(jax.random.PRNGKey(1), jbatch, rng=None)["params"], seed)
    tcond = te.GeneralConditioner(tembs)
    load_into(tcond, p_cond)
    return jcond, p_cond, tcond


def jax_ucg_draws(key, rates, batch_size):
    """JAX GeneralConditioner's UCG draws for ``key`` in its order
    (embedding.py:248-288): a swap per text embedder before it runs, a keep
    mask per numeric output after."""
    draws, rng = [], key
    for i, rate in enumerate(rates):
        if rate <= 0:
            continue
        rng, sub = jax.random.split(rng)
        if i < 2:
            draws.append(torch.tensor(bool(jax.random.uniform(sub) < rate)))
        else:
            draws.append(torch.tensor(np.asarray(jax.random.bernoulli(sub, 1.0 - rate, (batch_size,)))))
    return draws


def test_ucg_with_jax_draws():
    batch = _batch(np.random.RandomState(7), b=4)
    batch["uncond_ids"] = _token_ids(np.random.RandomState(8), 1)
    jbatch = _to_jax(batch)
    jcond, p_cond, tcond = _conditioners(jbatch, 9)
    plain = tcond(_to_torch(batch))
    seen_swap, seen_keep = set(), set()
    japply = jax.jit(lambda params, b, key: jcond.apply({"params": params}, b, rng=key))
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = japply(p_cond, jbatch, key)
        draws = jax_ucg_draws(key, RATES, 4)
        got = tcond(_to_torch(batch), ucg=draws)
        assert rel_err(got["crossattn"].numpy(), want["crossattn"]) < 1e-5
        assert float(np.abs(got["vector"].numpy() - np.asarray(want["vector"])).max()) < 5e-4
        seen_swap |= {bool(d) for d in draws[:2]}
        seen_keep |= {bool(x) for d in draws[2:] for x in d}
        swapped = not torch.equal(got["crossattn"][:, :, :64], plain["crossattn"][:, :, :64])
        assert swapped == bool(draws[0])
    assert seen_swap == seen_keep == {True, False}  # both branches of each draw were held


def test_ucg_draws_from_the_generator_and_not_without_one():
    from neurosis_tpu_torch.modules.encoders import embedding as te

    batch = _batch(np.random.RandomState(3), b=8)
    batch["uncond_ids"] = _token_ids(np.random.RandomState(4), 1)
    g = torch.Generator().manual_seed(5)  # the port's own seeded init: no JAX side here
    tcond = te.GeneralConditioner(
        [te.FrozenCLIPEmbedder(ucg_rate=RATES[0], **TINY_CLIP, device=CPU, generator=g),
         te.FrozenOpenCLIPEmbedder2(ucg_rate=RATES[1], always_return_pooled=True, **TINY_BIGG, device=CPU, generator=g)]
        + [te.ConcatTimestepEmbedderND(outdim=16, input_key=k, ucg_rate=r) for k, r in zip(SIZE_KEYS, RATES[2:])])
    tb = _to_torch(batch)
    plain = tcond(tb)
    assert all(torch.equal(plain[k], tcond(tb, generator=None)[k]) for k in plain)  # sampling and evaluation
    a, b = (tcond(tb, generator=torch.Generator().manual_seed(11)) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    outs = [tcond(tb, generator=torch.Generator().manual_seed(s)) for s in range(12)]
    zeroed = [int((o["vector"][:, 64:96] == 0).all(dim=1).sum()) for o in outs]  # original_size_as_tuple
    assert 0 < sum(zeroed) < 12 * 8  # some samples' size embeddings dropped, not all


@pytest.mark.parametrize("chunks", [3])
def test_extended_prompts_through_clip_l_and_bigg(chunks):
    rng = np.random.RandomState(chunks)
    ids = np.stack([_token_ids(rng, 2) for _ in range(chunks)], axis=1)
    batch = {"caption_ids": ids, **{k: v for k, v in _batch(rng).items() if k in SIZE_KEYS}}
    jbatch = _to_jax(batch)
    jcond, p_cond, tcond = _conditioners(jbatch, 10 + chunks, rates=(0.0,) * 5, extended_chunks=chunks)
    want = jcond.apply({"params": p_cond}, jbatch, rng=None)
    got = tcond(_to_torch(batch))
    assert got["crossattn"].shape == (2, chunks * 77, 128)
    assert rel_err(got["crossattn"].numpy(), want["crossattn"]) < 1e-5
    assert rel_err(got["vector"][:, :64].numpy(), np.asarray(want["vector"])[:, :64]) < 1e-5  # chunk 0's pooled


@pytest.mark.parametrize("layer", ["last", "pooled"])
def test_clip_l_always_return_pooled(layer):
    from neurosis_tpu.modules.encoders.embedding import FrozenCLIPEmbedder as JEmb
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder

    ids = _token_ids(np.random.RandomState(2), 2)
    jm = JEmb(layer=layer, always_return_pooled=True, **TINY_CLIP)
    p = perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(ids.copy()))["params"], 3)
    m = FrozenCLIPEmbedder(layer=layer, always_return_pooled=True, **TINY_CLIP, device=CPU)
    load_into(m, p)
    want = jm.apply({"params": p}, jnp.asarray(ids.copy()))
    got = m(torch.tensor(ids))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_err(g.numpy(), w) < 1e-5


def test_trainer_tokenizes_in_chunks_for_an_extended_embedder(tmp_path):
    """prepare_batch gives [B, chunks, 77] ids when an embedder of the
    caption sets extended_chunks and the tokenizer chunks, as JAX's loop."""
    from neurosis_tpu_torch.modules.encoders.embedding import FrozenCLIPEmbedder, GeneralConditioner
    from neurosis_tpu_torch.trainer.loop import Trainer

    class Tok:
        def __call__(self, texts):
            return np.ones((len(texts), 77), np.int32)

        def tokenize_extended(self, texts, chunks):
            return np.ones((len(texts), chunks, 77), np.int32)

    class Engine:
        device = torch.device(CPU)
        conditioner = GeneralConditioner([FrozenCLIPEmbedder(extended_chunks=3, **TINY_CLIP, device=CPU)])

    trainer = Trainer(Engine(), tokenizer=Tok(), default_root_dir=str(tmp_path))
    out = trainer.prepare_batch({"caption": ["a", "b"]})
    assert out["caption_ids"].shape == (2, 3, 77) and out["uncond_ids"].shape == (1, 77)
    Engine.conditioner = GeneralConditioner([FrozenCLIPEmbedder(**TINY_CLIP, device=CPU)])
    assert trainer.prepare_batch({"caption": ["a"]})["caption_ids"].shape == (1, 77)
