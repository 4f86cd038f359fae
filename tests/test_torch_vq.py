"""The port's latent regularizers (neurosis_tpu_torch/modules/regularizers.py)
against the JAX package's on the CPU: z_q, the loss and the log at 1e-6,
the codebook indices exactly, and the straight-through grads.

The latents are codebook entries plus small seeded noise, and each row's
best and second-best distances are checked to differ by more than 1e-4, so
that no tie decides an index. The Gumbel quantizer takes JAX's uniform draw
(turned into the same noise) and EMA-VQ's statistics are held after three
training calls.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from torch_parity import load_into, one_torch_thread, rel_err, t, to_np  # noqa: E402,F401

CPU = "cpu"
N_E, E_DIM = 16, 4


def _latents(codebook: np.ndarray, seed: int, shape=(2, 4, 4)) -> np.ndarray:
    """Codebook rows picked at random plus noise, with a clear nearest code."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, codebook.shape[0], size=shape)
    z = codebook[idx] + 0.3 * np.abs(codebook).mean() * rng.randn(*shape, codebook.shape[1])
    z = z.astype(np.float32)
    d = ((z.reshape(-1, 1, codebook.shape[1]) - codebook[None]) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    assert (two[:, 1] - two[:, 0]).min() > 1e-4
    return z


def _close(got, want, tol=1e-6, what=""):
    assert rel_err(np.asarray(got), np.asarray(want)) < tol, what


@pytest.mark.parametrize("log_perplexity", [False, True])
def test_vector_quantizer_matches_jax(log_perplexity):
    from neurosis_tpu.modules.regularizers import VectorQuantizer as JVQ
    from neurosis_tpu_torch.modules.regularizers import VectorQuantizer

    jm = JVQ(n_e=N_E, e_dim=E_DIM, beta=0.3, log_perplexity=log_perplexity)
    probe = jnp.zeros((1, 1, 1, E_DIM))
    params = to_np(jm.init(jax.random.PRNGKey(0), probe)["params"])
    params["embedding"] = np.random.RandomState(1).randn(N_E, E_DIM).astype(np.float32)
    z = _latents(params["embedding"], 2)
    m = VectorQuantizer(N_E, E_DIM, beta=0.3, log_perplexity=log_perplexity, device=CPU)
    load_into(m, params)
    w = np.random.RandomState(3).randn(*z.shape).astype(np.float32)

    def jfn(p, zz):
        z_q, log = jm.apply({"params": p}, zz)
        return jnp.sum(z_q * w) + log["loss/vq"], (z_q, log)

    (_, (jzq, jlog)), (gp, gz) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(z.copy()))
    tz = t(z, requires_grad=True)
    zq, log = m(tz)
    (zq * t(w)).sum().add(log["loss/vq"]).backward()
    _close(zq.detach(), jzq, what="z_q")
    assert torch.equal(log["indices"], torch.tensor(np.asarray(jlog["indices"]), dtype=torch.int64))
    assert torch.equal(log["min_encoding_indices"], log["indices"])
    np.testing.assert_allclose(float(log["loss/vq"]), float(jlog["loss/vq"]), rtol=1e-6)
    if log_perplexity:
        np.testing.assert_allclose(float(log["perplexity"]), float(jlog["perplexity"]), rtol=1e-6)
    _close(tz.grad, gz, what="straight-through grad")
    _close(m.embedding.weight.grad, gp["embedding"], what="codebook grad")
    ids = torch.tensor([[1, 5], [7, 15]])
    np.testing.assert_array_equal(m.get_codebook_entry(ids).detach().numpy(),
                                  np.asarray(jm.apply({"params": params}, jnp.asarray(ids.numpy()),
                                                      method="get_codebook_entry")))


@pytest.mark.parametrize("straight_through", [True, False])
def test_gumbel_quantizer_matches_jax_with_its_draw(straight_through):
    from neurosis_tpu.modules.regularizers import GumbelQuantizer as JGQ
    from neurosis_tpu_torch.modules.regularizers import GumbelQuantizer

    hidden = 6
    z = np.random.RandomState(4).randn(2, 3, 3, hidden).astype(np.float32)
    jm = JGQ(n_e=N_E, e_dim=E_DIM, num_hiddens=hidden, straight_through=straight_through, kl_weight=1e-2,
             temp_init=0.7)
    jz = jnp.asarray(z.copy())
    params = to_np(jm.init(jax.random.PRNGKey(0), jz)["params"])
    m = GumbelQuantizer(N_E, E_DIM, hidden, straight_through=straight_through, kl_weight=1e-2, temp_init=0.7,
                        device=CPU)
    load_into(m, params)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, z.shape[:-1] + (N_E,)))
    gumbel = -np.log(-np.log(u + 1e-20) + 1e-20)
    w = np.random.RandomState(5).randn(2, 3, 3, E_DIM).astype(np.float32)
    for rng, noise in ((key, t(gumbel)), (None, None)):
        def jfn(p, zz):
            z_q, log = jm.apply({"params": p}, zz, rng)
            return jnp.sum(z_q * w) + log["loss/vq"], (z_q, log)

        (_, (jzq, jlog)), (gp, gz) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, params), jz)
        m.zero_grad()
        tz = t(z, requires_grad=True)
        zq, log = m(tz, gumbel=noise)
        (zq * t(w)).sum().add(log["loss/vq"]).backward()
        _close(zq.detach(), jzq, what="z_q")
        assert torch.equal(log["indices"], torch.tensor(np.asarray(jlog["indices"]), dtype=torch.int64))
        np.testing.assert_allclose(float(log["loss/vq"]), float(jlog["loss/vq"]), rtol=1e-6)
        _close(tz.grad, gz, 1e-5, "grad of z")
        _close(m.embed.weight.grad, gp["embed.weight"], 1e-5, "codebook grad")


def test_ema_vector_quantizer_stats_after_three_training_calls():
    from neurosis_tpu.modules.regularizers import EMAVectorQuantizer as JEMA
    from neurosis_tpu_torch.modules.regularizers import EMAVectorQuantizer

    rng = np.random.RandomState(6)
    stats = {"embedding": rng.randn(N_E, E_DIM).astype(np.float32),
             "cluster_size": rng.uniform(0.5, 2.0, N_E).astype(np.float32),
             "embed_avg": rng.randn(N_E, E_DIM).astype(np.float32)}
    jm = JEMA(n_e=N_E, e_dim=E_DIM, beta=0.4, decay=0.9)
    m = EMAVectorQuantizer(N_E, E_DIM, beta=0.4, decay=0.9, device=CPU)
    with torch.no_grad():
        for name, v in stats.items():
            buf = "weight" if name == "embedding" else name
            getattr(m.embedding, buf).copy_(torch.tensor(v))
    jstats = jax.tree_util.tree_map(jnp.asarray, stats)
    for call in range(3):
        z = _latents(np.asarray(jstats["embedding"]), 10 + call)
        (jzq, jlog), upd = jm.apply({"ema_stats": jstats}, jnp.asarray(z.copy()), train=True, mutable=["ema_stats"])
        jstats = upd["ema_stats"]
        zq, log = m(t(z), train=True)
        _close(zq, jzq, what="z_q")
        assert torch.equal(log["indices"], torch.tensor(np.asarray(jlog["indices"]), dtype=torch.int64))
        np.testing.assert_allclose(float(log["loss/vq"]), float(jlog["loss/vq"]), rtol=1e-6)
    for name, buf in (("embedding", "weight"), ("cluster_size", "cluster_size"), ("embed_avg", "embed_avg")):
        _close(getattr(m.embedding, buf), jstats[name], what=name)
    before = m.embedding.weight.clone()
    m(t(z), train=False)
    assert torch.equal(before, m.embedding.weight)  # eval leaves the statistics


@pytest.mark.parametrize("output_dim", [None, 5])
def test_vector_quantizer_with_input_projection_matches_jax(output_dim):
    from neurosis_tpu.modules.regularizers import VectorQuantizerWithInputProjection as JVP
    from neurosis_tpu_torch.modules.regularizers import VectorQuantizerWithInputProjection

    z = np.random.RandomState(8).randn(2, 3, 3, 6).astype(np.float32)
    jm = JVP(input_dim=6, n_codes=N_E, codebook_dim=E_DIM, output_dim=output_dim, log_perplexity=True)
    jz = jnp.asarray(z.copy())
    params = to_np(jm.init(jax.random.PRNGKey(0), jz)["params"])
    m = VectorQuantizerWithInputProjection(6, N_E, E_DIM, output_dim=output_dim, log_perplexity=True, device=CPU)
    load_into(m, params)
    jzq, jlog = jm.apply({"params": params}, jz)
    zq, log = m(t(z))
    assert tuple(zq.shape) == tuple(jzq.shape)
    _close(zq.detach(), jzq, 1e-5, "z_q")
    assert torch.equal(log["indices"], torch.tensor(np.asarray(jlog["indices"]), dtype=torch.int64))
    for k in ("loss/vq", "perplexity"):
        np.testing.assert_allclose(float(log[k]), float(jlog[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("sample", [True, False])
def test_diagonal_gaussian_and_identity_regularizers_match_jax(sample):
    from neurosis_tpu.modules.regularizers import DiagonalGaussianRegularizer as JDG
    from neurosis_tpu.modules.regularizers import IdentityRegularizer as JId
    from neurosis_tpu_torch.modules.regularizers import DiagonalGaussianRegularizer, IdentityRegularizer

    moments = np.random.RandomState(9).randn(2, 4, 4, 8).astype(np.float32)
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.normal(key, (2, 4, 4, 4)))
    jz, jlog = JDG(sample=sample)(jnp.asarray(moments.copy()), key)
    z, log = DiagonalGaussianRegularizer(sample=sample)(t(moments), eps=t(eps))
    _close(z, jz, what="z")
    np.testing.assert_allclose(float(log["kl_loss"]), float(jlog["kl_loss"]), rtol=1e-6)
    z0, _ = DiagonalGaussianRegularizer(sample=sample)(t(moments))  # no draw: the mode
    np.testing.assert_array_equal(z0.numpy(), moments[..., :4])
    jz, jlog = JId()(jnp.asarray(moments.copy()))
    z, log = IdentityRegularizer()(t(moments))
    assert log == jlog == {} and np.array_equal(z.numpy(), np.asarray(jz))
