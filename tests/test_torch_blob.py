"""Blob-store checkpoints of the port (neurosis_tpu_torch/checkpoint/blob.py
over utils/fs.py) against the JAX package's BlobCheckpointIO, on the CPU.

``is_remote_url`` has JAX's truth table. Save, list, latest, prune, remove,
a missing step and an async write with its wait list the same steps as
JAX's on every backend: the port's ``file://`` and ``memory://`` and an
injected fsspec ``MemoryFileSystem``; payloads come back bitwise. A base
holding JAX's msgpack steps, an unknown scheme and a scheme without fsspec
raise, naming them; a failed async write raises at ``wait``; a memory
store is refused under a mesh of several processes. No test names a cloud
scheme (gcsfs, installed here, would reach for the network).
"""

import sys

import numpy as np
import pytest
import torch

pytest.importorskip("fsspec")
jax = pytest.importorskip("jax")

from neurosis_tpu.checkpoint import blob as jax_blob  # noqa: E402
from neurosis_tpu_torch.checkpoint import blob  # noqa: E402
from neurosis_tpu_torch.utils import fs  # noqa: E402

from torch_parity import one_torch_thread  # noqa: E402,F401

URLS = ["memory://ckpts", "gs://bucket/path", "s3://b/k", "az://c/d", "http://host/x", "/local/dir", "relative/dir",
        "file:///local/dir", "file://relative", "", None]


@pytest.mark.parametrize("url", URLS)
def test_is_remote_url_is_jax_s(url):
    assert blob.is_remote_url(url) == jax_blob.is_remote_url(url)


def _base(kind: str, tmp_path, name: str):
    """(the port's BlobCheckpointIO, JAX's) over one backend kind; JAX's
    writes synchronously, the port's always on its thread."""
    import fsspec

    if kind == "file":
        return (blob.BlobCheckpointIO(f"file://{tmp_path}/port/{name}"),
                jax_blob.BlobCheckpointIO(f"file://{tmp_path}/jax/{name}", async_write=False))
    if kind == "memory":  # the port's own store; JAX's is fsspec's, apart
        url = f"memory://test_torch_blob/{tmp_path.name}/{name}"
        return blob.BlobCheckpointIO(url), jax_blob.BlobCheckpointIO(url, async_write=False)
    mem = fsspec.filesystem("memory")
    port_url, jax_url = f"memory://port/{tmp_path.name}/{name}", f"memory://jax/{tmp_path.name}/{name}"
    return (blob.BlobCheckpointIO(port_url, filesystem=mem),
            jax_blob.BlobCheckpointIO(jax_url, async_write=False, filesystem=mem))


@pytest.mark.parametrize("kind", ["file", "memory", "fsspec"])
def test_store_semantics_are_jax_s(tmp_path, kind):
    port, ref = _base(kind, tmp_path, "run")
    for s in (10, 20, 30):
        port.save_checkpoint({"step": s, "params": {"w": torch.full((2, 3), float(s))}}, step=s)
        port.wait()
        ref.save_checkpoint({"step": s, "params": {"w": np.full((2, 3), float(s), np.float32)}}, step=s)
    assert port.list_steps() == ref.list_steps() == [10, 20, 30]
    assert port.latest_step() == ref.latest_step() == 30
    loaded = port.load_checkpoint(20)
    assert loaded["step"] == 20 and torch.equal(loaded["params"]["w"], torch.full((2, 3), 20.0))
    for b in (port, ref):
        b.prune(keep=2)
    assert port.list_steps() == ref.list_steps() == [20, 30]
    for b in (port, ref):
        b.remove_checkpoint(30)
        b.remove_checkpoint(99)  # nothing there: nothing happens
        b.prune(keep=-1)  # keep all (save_top_k -1)
    assert port.list_steps() == ref.list_steps() == [20]
    with pytest.raises(FileNotFoundError, match="step_00000099.pt"):
        port.load_checkpoint(99)
    with pytest.raises(FileNotFoundError):
        ref.load_checkpoint(99, {"step": 0})

    ref.async_write = True
    payload = {"step": 7, "w": torch.randn(64, 64, generator=torch.Generator().manual_seed(0))}
    port.save_checkpoint(payload, step=7, keep=2)
    ref.save_checkpoint({"step": 7}, step=7)
    port.wait()
    ref.wait()
    assert port.list_steps() == [7, 20] and ref.list_steps() == [7, 20]
    assert torch.equal(port.load_checkpoint(7)["w"], payload["w"]) and port.last_bytes > 64 * 64 * 4
    empty, _ = _base(kind, tmp_path, "never_written")
    assert empty.list_steps() == [] and empty.latest_step() is None


def test_jax_msgpack_steps_are_refused(tmp_path):
    url = f"file://{tmp_path}/jax_run"
    jax_blob.BlobCheckpointIO(url, async_write=False).save_checkpoint({"step": 3}, step=3)
    with pytest.raises(ValueError, match=r"JAX package \(step_00000003.msgpack\)"):
        blob.BlobCheckpointIO(url).latest_step()


def test_schemes_without_a_filesystem_are_refused(monkeypatch):
    with pytest.raises(ValueError, match="'nosuchscheme'"):
        _ = blob.BlobCheckpointIO("nosuchscheme://bucket/run").fs
    with pytest.raises(ValueError, match="'nosuchscheme'"):
        fs.filesystem("nosuchscheme")
    monkeypatch.setitem(sys.modules, "fsspec", None)  # the card's machine: no fsspec
    with pytest.raises(ImportError, match="the s3:// scheme needs the fsspec package"):
        fs.url_to_fs("s3://bucket/run")
    assert isinstance(fs.url_to_fs("memory://a/b")[0], fs.MemoryFileSystem)  # the port's own need none


def test_a_failed_async_write_raises_at_wait(tmp_path):
    class Broken(fs.MemoryFileSystem):
        def open(self, path, mode="rb"):
            raise OSError("the store is gone")

    b = blob.BlobCheckpointIO("memory://broken", filesystem=Broken())
    b.save_checkpoint({"step": 1}, step=1)
    with pytest.raises(RuntimeError, match="the store is gone"):
        b.wait()
    b.wait()  # raised once


def test_a_memory_store_is_refused_under_a_mesh():
    from types import SimpleNamespace

    from neurosis_tpu_torch.trainer.callbacks import check_store_reach

    mesh = SimpleNamespace(dist=SimpleNamespace(world_size=2))
    with pytest.raises(ValueError, match="per process, and the mesh has 2 processes"):
        check_store_reach("memory://run", mesh)
    check_store_reach("memory://run", SimpleNamespace(dist=SimpleNamespace(world_size=1)))
    check_store_reach("gs://bucket/run", mesh)
