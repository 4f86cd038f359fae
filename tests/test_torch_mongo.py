"""The port's Mongo datasets (neurosis_tpu_torch/data/mongo.py) against the
JAX package's (neurosis_tpu/data/mongo.py), on the CPU, with the fakes of
tests/test_mongo_fakes.py (no pymongo, no blob store): the same query hash,
the same samples (crops, sizes, captions: images exact, float32 from the
same uint8 pixels) and the same aspect, square and VAE batch schedules for
the same rows and seed (exact); the metadata cache's miss, pull and hit,
the fork refresh, the retries, ``path_prefix`` on the port's own file
backend, the transform chain, ``S3ImageLoader``, the environment
variables JAX drops (upper-case ``MONGO_*``), and a CLI fit from the cache
that saves to and resumes from a ``memory://`` store.
"""

import io
import tempfile
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("PIL")
pytest.importorskip("pandas")

import neurosis_tpu.data.mongo as jm  # noqa: E402
import neurosis_tpu_torch.data.mongo as pm  # noqa: E402

from test_mongo_fakes import FakeClient, FakeFS, rows  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
PACKAGES = {"jax": jm, "port": pm}
SETTINGS = dict(uri="mongodb://fake", database="db", collection="images")


def _png(w=96, h=64, seed=0) -> bytes:
    from PIL import Image

    arr = (np.random.RandomState(seed).rand(h, w, 3) * 255).astype("uint8")
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _buckets(pkg: str):
    """A small bucket list (96 px squares' pixel count) in either package."""
    if pkg == "jax":
        from neurosis_tpu.data.aspect import AspectBucketList
    else:
        from neurosis_tpu_torch.data.aspect import AspectBucketList
    return AspectBucketList(n_buckets=5, edge_min=32, edge_max=160, edge_step=32, tgt_pixels=96 * 96, tolerance=40)


def _ds(pkg: str, tmp_path, cls: str, n: int = 8, blobs=None, **kwargs):
    mod = PACKAGES[pkg]
    if cls == "MongoAspectDataset":
        kwargs.setdefault("buckets", _buckets(pkg))
    ds = getattr(mod, cls)(settings=mod.MongoSettings(**SETTINGS), cache_dir=str(tmp_path / pkg / "cache"),
                           skip_preload=True, retries=3, retry_backoff=1.0, **kwargs)
    ds._client = FakeClient(rows(n))
    ds._fs = FakeFS(blobs if blobs is not None else {f"s3://bucket/img{i}.png": _png(seed=i) for i in range(n)})
    return ds


@pytest.mark.parametrize("query", [{}, {"filter": {"x": 1}}, {"filter": {"tags": {"$in": ["a", "b"]}},
                                                             "projection": {"_id": 0}, "sort": [["score", -1]],
                                                             "limit": 100}])
def test_query_hash_is_jax_s(query):
    want = jm.MongoSettings(**SETTINGS, query=jm.Query(**query)).query_hash()
    assert pm.MongoSettings(**SETTINGS, query=pm.Query(**query)).query_hash() == want
    assert pm.MongoSettings(**SETTINGS, query=query).query_hash() == want  # a config's dict becomes a Query


def test_environment_is_read_in_any_case(monkeypatch):
    """JAX keeps the key's case after the prefix and drops MONGO_URI and
    MONGO_TLS; the port reads them, as the reference's pydantic-settings does."""
    monkeypatch.setenv("MONGO_URI", "mongodb://x:1")
    monkeypatch.setenv("MONGO_TLS", "true")
    monkeypatch.setenv("mongo_database", "lower")
    jax_s, port_s = jm.MongoSettings.from_env(), pm.MongoSettings.from_env()
    assert (jax_s.uri, jax_s.tls, jax_s.database) == ("mongodb://localhost:27017", False, "lower")
    assert (port_s.uri, port_s.tls, port_s.database) == ("mongodb://x:1", True, "lower")
    assert pm.MongoSettings.from_env(tls="0").tls is False
    with pytest.raises(ValueError, match="not a boolean"):
        pm.MongoSettings(tls="maybe")
    monkeypatch.delenv("NEUROSIS_CACHE", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", "/elsewhere/tmp")  # the metadata cache follows TMPDIR
    assert pm.MongoSquareDataset(skip_preload=True).cache_dir == Path("/elsewhere/tmp/neurosis_cache")
    monkeypatch.setenv("NEUROSIS_CACHE", "/a/cache")
    assert pm.MongoSquareDataset(skip_preload=True).cache_dir == Path("/a/cache")


def test_metadata_pull_then_cache_hit(tmp_path):
    ds = _ds("port", tmp_path, "MongoSquareDataset")
    got = ds.preload()
    assert len(got) == 8 and ds._client.coll.find_calls == 1
    assert ds._cache_path().exists() and ds._cache_path().name.endswith(".rows.pkl")
    jax_ds = _ds("jax", tmp_path, "MongoSquareDataset")
    assert ds._cache_path().name.split("_")[1] == jax_ds._cache_path().name.split("_")[1]  # the same query hash
    assert ds._cache_path().name != jax_ds._cache_path().name

    again = _ds("port", tmp_path, "MongoSquareDataset")
    again._client = None  # any client use would raise: no pymongo here
    assert again.preload() == got
    again._client = FakeClient(rows(8))
    again.preload(force=True)
    assert again._client.coll.find_calls == 1
    other = _ds("port", tmp_path, "MongoSquareDataset")
    other.settings = pm.MongoSettings(**SETTINGS, query={"filter": {"x": 2}})
    other.preload()  # another hash: a miss, a pull from its own client
    assert other._client.coll.find_calls == 1
    with pytest.raises(ImportError, match="requires pymongo"):  # a miss with no client: pymongo is not installed
        pm.MongoSquareDataset(settings=other.settings, cache_dir=str(tmp_path / "empty"))


def test_fork_refresh_and_same_pid(tmp_path):
    import os

    ds = _ds("port", tmp_path, "MongoSquareDataset")
    client = ds._client
    ds._refresh_clients()
    assert ds._client is client
    ds._pid = os.getpid() - 1  # as in a forked child
    ds._refresh_clients()
    assert ds._client is None and ds._fs is None and ds._pid == os.getpid()
    ds._fs = FakeFS({})
    assert pm.pickle.loads(pm.pickle.dumps(ds))._fs is None  # a spawned worker opens its own


@pytest.mark.parametrize("fail_first,ok", [(2, True), (99, False)])
def test_fetch_retries_as_jax_does(tmp_path, monkeypatch, fail_first, ok):
    calls = {}
    for pkg, mod in PACKAGES.items():
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        ds = _ds(pkg, tmp_path, "MongoSquareDataset", blobs={"s3://x": b"blob"})
        ds._fs.fail_first = fail_first
        if ok:
            assert ds._get_image_bytes("s3://x") == b"blob"
        else:
            with pytest.raises(RuntimeError, match="failed to fetch"):
                ds._get_image_bytes("s3://x")
        calls[pkg] = ds._fs.calls["s3://x"]
    assert calls["port"] == calls["jax"] == 3


def _same_batches(jax_ds, port_ds, batches: int = 2):
    jax_ds.preload()
    port_ds.preload()
    sched = list(jax_ds.get_batch_iterator())
    assert list(port_ds.get_batch_iterator()) == sched and sched
    for indices in sched[:batches]:
        want, got = jax_ds.get_batch(indices), port_ds.get_batch(indices)
        assert sorted(want) == sorted(got)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            else:
                assert list(got[k]) == list(want[k]), k
    return sched


@pytest.mark.parametrize("cls,kwargs", [("MongoAspectDataset", dict(batch_size=2)),
                                        ("MongoSquareDataset", dict(batch_size=3, resolution=32)),
                                        ("MongoVAEDataset", dict(batch_size=2, resolution=32))])
def test_samples_and_schedules_are_jax_s(tmp_path, cls, kwargs):
    jax_ds, port_ds = _ds("jax", tmp_path, cls, seed=7, **kwargs), _ds("port", tmp_path, cls, seed=7, **kwargs)
    sched = _same_batches(jax_ds, port_ds)
    if cls == "MongoAspectDataset":
        assert np.array_equal(port_ds.bucket_idx, jax_ds.samples["bucket_idx"].to_numpy())
        assert all(len({int(port_ds.bucket_idx[i]) for i in b}) == 1 for b in sched)
    if cls == "MongoVAEDataset":
        assert "caption" not in port_ds[0]


def test_path_prefix_on_the_port_s_file_backend(tmp_path):
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(4):
        (img_dir / f"img{i}.png").write_bytes(_png(seed=i))
    local = [{"s3_url": f"img{i}.png", "caption": f"c{i}", "aspect": 1.5, "resolution": [96, 64]} for i in range(4)]
    made = {}
    for pkg, mod in PACKAGES.items():
        ds = mod.MongoSquareDataset(settings=mod.MongoSettings(**SETTINGS), cache_dir=str(tmp_path / pkg),
                                    skip_preload=True, resolution=32, batch_size=2, fs_type="file",
                                    path_prefix=str(img_dir), seed=3)
        ds._client = FakeClient(local)
        made[pkg] = ds
    assert type(made["port"].fs).__module__ == "neurosis_tpu_torch.utils.fs"
    _same_batches(made["jax"], made["port"])


def test_transform_chain_is_jax_s(tmp_path):
    def chain(pkg):
        if pkg == "jax":
            from neurosis_tpu.data.processing import DataTransform
        else:
            from neurosis_tpu_torch.data.processing import DataTransform

        class AddSourceTag(DataTransform):
            def __init__(self):
                super().__init__("source_tag", ["caption"])

            def __call__(self, sample, raw=None):
                return dict(sample, caption=sample["caption"] + f", src:{raw['s3_url'].split('/')[-1]}")

        class Brighten(DataTransform):
            def __init__(self):
                super().__init__("brighten", ["image"], ["image"])

            def __call__(self, sample, raw=None):
                return dict(sample, image=np.clip(sample["image"] + 0.1, -1.0, 1.0))

        return [AddSourceTag(), Brighten()]

    dss = {pkg: _ds(pkg, tmp_path, "MongoSquareDataset", n=2, batch_size=2, resolution=32, data_transforms=chain(pkg))
           for pkg in PACKAGES}
    _same_batches(dss["jax"], dss["port"], batches=1)
    assert dss["port"][0]["caption"].endswith("src:img0.png")
    assert repr(dss["port"].data_transforms[0]) == "AddSourceTag(name='source_tag', in=['caption'], out=['caption'])"


def test_s3_loader_drops_failed_urls():
    loader = pm.S3ImageLoader(max_workers=2, retries=1)
    loader._fs = FakeFS({"s3://a": b"A", "s3://b": b"B"})
    assert loader.fetch(["s3://a", "s3://b", "s3://missing"]) == {"s3://a": b"A", "s3://b": b"B"}

    class NoMultiGet(FakeFS):
        def cat(self, url, on_error=None):
            if isinstance(url, list):
                raise NotImplementedError
            return super().cat(url)

    loader._fs = NoMultiGet({"s3://a": b"A"})
    assert loader.fetch(["s3://a", "s3://missing"]) == {"s3://a": b"A"}


def test_cli_fit_from_the_cache_saves_and_resumes_remotely(tmp_path, monkeypatch):
    """``python -m neurosis_tpu_torch fit`` of vae-tiny from a MongoVAEDataset
    whose metadata is cached (no pymongo): a ``memory://`` model_checkpoint
    dirpath keeps the newest step, the resolved config is written by the
    SaveConfigCallback the config names by its JAX path, and a second fit with
    ``trainer.remote_checkpoint_url`` resumes from the store."""
    import json

    from neurosis_tpu_torch.checkpoint.blob import BlobCheckpointIO
    from neurosis_tpu_torch.config.loader import load_config
    from neurosis_tpu_torch.config.yaml_reader import safe_load
    from neurosis_tpu_torch.data.png import write_png
    from neurosis_tpu_torch.trainer.cli import main

    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        write_png(folder / f"img{i}.png", (rng.rand(72, 64 + 8 * i, 3) * 255).astype(np.uint8))
    settings = dict(uri="mongodb://cli", database="db", collection="images", query={"filter": {"split": "train"}})
    cache = tmp_path / "cache"
    pm.BaseMongoDataset(settings=pm.MongoSettings(**settings), cache_dir=str(cache), skip_preload=True).write_cache(
        [{"s3_url": f"img{i}.png", "caption": "", "split": "train"} for i in range(4)])
    url = f"memory://test_torch_mongo/{tmp_path.name}/vae"
    text = (ROOT / "configs" / "smoke" / "vae-tiny.yaml").read_text()
    data = ("data:\n  class_path: neurosis.dataset.mongo.MongoVAEDataset\n  init_args:\n    settings:\n"
            "      class_path: neurosis_tpu.data.mongo.MongoSettings\n      init_args:\n        uri: mongodb://cli\n"
            "        database: db\n        collection: images\n        query:\n          filter:\n"
            "            split: train\n"
            f"    cache_dir: {cache}\n    fs_type: file\n    path_prefix: {folder}\n    resolution: 64\n"
            "    batch_size: 2\n    image_key: image\n    num_workers: 0\n"
            f"model_checkpoint:\n  dirpath: {url}\n  every_n_train_steps: 1\n  save_top_k: 1\n")
    callbacks = "  callbacks:\n    - class_path: neurosis_tpu.trainer.callbacks.SaveConfigCallback\n"
    head = text[:text.index("\ndata:\n") + 1].replace("  fast_dev_run: true\n", "  fast_dev_run: false\n" + callbacks)
    monkeypatch.setenv("NEUROSIS_SMOKE_ROOT", str(tmp_path / "root"))
    first, second = tmp_path / "first.yaml", tmp_path / "second.yaml"
    first.write_text(head.replace("  max_steps: 1\n", "  max_steps: 2\n") + data)
    second.write_text(head.replace("  max_steps: 1\n", f"  max_steps: 3\n  remote_checkpoint_url: {url}\n") + data)
    assert main(["fit", "-c", str(first), "--device", "cpu"]) == 0
    assert BlobCheckpointIO(url).list_steps() == [2]
    assert safe_load((tmp_path / "root" / "config.yaml").read_text()) == load_config(first)
    assert main(["fit", "-c", str(second), "--device", "cpu"]) == 0
    assert BlobCheckpointIO(url).list_steps() == [3]
    steps = [json.loads(x)["step"] for x in (tmp_path / "root" / "logs" / "metrics.jsonl").read_text().splitlines()]
    assert steps == [1, 2, 3]  # the second fit resumed at step 2 and ran one
