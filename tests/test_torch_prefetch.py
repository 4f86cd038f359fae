"""Prefetch of the port's input pipeline (neurosis_tpu_torch/data/prefetch.py
and the CLI's batch factory), on the CPU.

Thread and process workers give the batches of ``num_workers: 0``, bit for
bit and in the same order, from an aspect-bucketed image folder whose
samples are cropped and whose tags are shuffled at random; a worker's
exception reaches the caller; a worker process sees no CUDA device; an
unpicklable dataset falls back to threads. Two cases spawn processes
(each spawn imports torch).
"""

import os
import threading

import numpy as np
import pytest

from neurosis_tpu_torch.data.png import write_png

from torch_parity import one_torch_thread  # noqa: E402,F401


def _folder(path):
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    for i in range(8):
        w, h = (72, 64) if i % 2 else (64, 72)
        write_png(path / f"img_{i}.png", (rng.rand(h, w, 3) * 255).astype(np.uint8))
        (path / f"img_{i}.txt").write_text(f"tag{i}, red, green, blue, a test image")
    return path


def _batches(tmp_path, **data_args):
    """The CLI's batches of one epoch, for a config whose data node has ``data_args``."""
    from neurosis_tpu_torch.config.loader import instantiate
    from neurosis_tpu_torch.trainer.cli import _batch_factory

    node = {"class_path": "neurosis.dataset.imagefolder.ImageFolderDataset",
            "init_args": {"folder": str(_folder(tmp_path / "data")), "batch_size": 2, "seed": 7,
                          "buckets": {"class_path": "neurosis.dataset.aspect.AspectBucketList",
                                      "init_args": {"n_buckets": 2, "edge_min": 32, "edge_max": 96,
                                                    "edge_step": 32, "max_aspect": 2.0,
                                                    "tgt_pixels": 64 * 64}}}}
    dataset = instantiate(node)
    cfg = {"data": {"init_args": dict(node["init_args"], **data_args)}}
    return list(_batch_factory(cfg, dataset)())


def _assert_same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_workers_give_the_in_process_batches_in_order(tmp_path, monkeypatch, mode):
    """The thread case names its mode in the data node; the process case in
    NEUROSIS_PREFETCH, which wins over the node's."""
    monkeypatch.delenv("NEUROSIS_PREFETCH", raising=False)
    want = _batches(tmp_path, num_workers=0)
    assert len({tuple(b["crop_coords_top_left"].ravel()) for b in want}) > 1  # the crops are drawn
    if mode == "process":
        monkeypatch.setenv("NEUROSIS_PREFETCH", "process")
    _assert_same(_batches(tmp_path, num_workers=2, prefetch_mode="thread"), want)


class ProbeDataset:
    """get_batch reports its process's CUDA view; the third batch raises."""

    def get_batch_iterator(self):
        return iter([[0], [1], [2], [3]])

    def get_batch(self, indices):
        if indices == [2]:
            raise ValueError(f"bad sample {indices[0]}")
        import torch

        return {"pid": os.getpid(), "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                "devices": torch.cuda.device_count(), "worker": os.environ.get("NEUROSIS_WORKER")}


def test_process_workers_see_no_card_and_raise_to_the_caller():
    from neurosis_tpu_torch.data.prefetch import prefetch_batches_processes

    before = os.environ.get("CUDA_VISIBLE_DEVICES")
    it = prefetch_batches_processes(ProbeDataset(), ProbeDataset().get_batch_iterator(), num_workers=2)
    first, second = next(it), next(it)
    for b in (first, second):
        assert b["pid"] != os.getpid() and b["visible"] == "" and b["devices"] == 0 and b["worker"] == "1"
    with pytest.raises(ValueError, match="bad sample 2"):
        next(it)
    it.close()
    assert os.environ.get("CUDA_VISIBLE_DEVICES") == before  # this process's environment is left as it was


def test_thread_workers_raise_to_the_caller_and_unpicklable_datasets_fall_back(caplog):
    from neurosis_tpu_torch.data.prefetch import make_prefetcher

    class Unpicklable(ProbeDataset):
        lock = threading.Lock()

        def __getstate__(self):
            return {"lock": self.lock}

    it = make_prefetcher("process")(Unpicklable(), Unpicklable().get_batch_iterator(), num_workers=2)
    assert "falling back to thread prefetch" in caplog.text
    assert next(it)["pid"] == os.getpid()
    next(it)
    with pytest.raises(ValueError, match="bad sample 2"):
        next(it)
    with pytest.raises(ValueError, match="'process' or 'thread'"):
        make_prefetcher("fork")
