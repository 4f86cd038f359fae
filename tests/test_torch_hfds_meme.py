"""The port's HF datasets adapter (data/hfds.py) and MemeAspectDataset
(data/imagefolder.py) against the JAX package's, on the CPU, exact: the
same batch schedule, images (float32 from the same uint8 pixels), size
conditionings and captions for the same rows and seed, in the square and
aspect modes, with PIL images, uint8 arrays and float arrays (JAX's dtype
rule), and the meme dataset's tags drawn in JAX's order.
"""

import numpy as np
import pytest

pytest.importorskip("PIL")
pytest.importorskip("pandas")

from neurosis_tpu.data import hfds as jax_hfds  # noqa: E402
from neurosis_tpu.data import imagefolder as jax_folder  # noqa: E402
from neurosis_tpu_torch.data import hfds, imagefolder  # noqa: E402

from test_torch_mongo import _buckets  # noqa: E402
from torch_parity import one_torch_thread  # noqa: E402,F401

SIZES = [(96, 64), (64, 96), (80, 80)]


def _rows(n: int, kind: str) -> list:
    from PIL import Image

    rng = np.random.RandomState(0)
    out = []
    for i in range(n):
        w, h = SIZES[i % len(SIZES)]
        pixels = rng.rand(h, w, 3)
        image = {"pil": lambda: Image.fromarray((pixels * 255).astype("uint8")),
                 "uint8": lambda: (pixels * 255).astype("uint8"),
                 "float": lambda: pixels.astype(np.float32),
                 "grey_float64": lambda: pixels[..., 0]}[kind]()
        row = {"image": image, "caption": f"tag_{i}, common_tag, third tag"}
        if kind == "pil":
            row.update(width=w, height=h)
        out.append(row)
    return out


def _equal_batches(ref, port, batches=2):
    sched = list(ref.get_batch_iterator())
    assert [list(b) for b in port.get_batch_iterator()] == [list(b) for b in sched] and sched
    for indices in sched[:batches]:
        want, got = ref.get_batch(indices), port.get_batch(indices)
        assert sorted(want) == sorted(got)
        for k in want:
            if isinstance(want[k], np.ndarray):
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
            else:
                assert list(got[k]) == list(want[k]), k
    return sched


@pytest.mark.parametrize("kind,aspect", [("pil", False), ("pil", True), ("uint8", True), ("float", False),
                                         ("grey_float64", False)])
def test_hf_adapter_is_jax_s(kind, aspect):
    kwargs = dict(resolution=32, batch_size=2, shuffle_tags=True, seed=5)
    rows = _rows(8, kind)
    ref = jax_hfds.HFDatasetAdapter(rows, buckets=_buckets("jax") if aspect else None, **kwargs)
    port = hfds.HFDatasetAdapter(rows, buckets=_buckets("port") if aspect else None, **kwargs)
    if aspect:
        assert np.array_equal(port._bucket_idx, ref._bucket_idx)
    sched = _equal_batches(ref, port)
    if aspect:
        assert all(len({int(port._bucket_idx[i]) for i in b}) == 1 for b in sched)


def test_hf_adapter_reads_columns():
    """Column access of a datasets.Dataset: the buckets come from the
    width/height columns, with no image decoded."""

    class Columns(list):
        def __getitem__(self, key):
            if isinstance(key, str):
                return [row[key] for row in self]
            return list.__getitem__(self, key)

    rows = Columns({"image": None, "caption": "x", "width": w, "height": h} for w, h in SIZES * 2)
    port = hfds.HFDatasetAdapter(rows, buckets=_buckets("port"))
    ref = jax_hfds.HFDatasetAdapter(rows, buckets=_buckets("jax"))
    assert np.array_equal(port._bucket_idx, ref._bucket_idx)


def _meme_folder(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(1)
    for i, (w, h) in enumerate(SIZES * 2):
        Image.fromarray((rng.rand(h, w, 3) * 255).astype("uint8")).save(tmp_path / f"img_{i}.png")
    (tmp_path / "tag_list.txt").write_text("\n".join(f"tag {i}" for i in range(12)) + "\n\n")
    return tmp_path


@pytest.mark.parametrize("kwargs", [dict(tags_per_img=5), dict(tags_per_img=50, prepend_tag="meme", prepend_rate=0.5)])
def test_meme_captions_are_jax_s(tmp_path, kwargs):
    folder = _meme_folder(tmp_path)
    ref = jax_folder.MemeAspectDataset(folder, buckets=_buckets("jax"), batch_size=2, seed=3, **kwargs)
    port = imagefolder.MemeAspectDataset(folder, buckets=_buckets("port"), batch_size=2, seed=3, **kwargs)
    _equal_batches(ref, port, batches=3)
    caption = port[0]["caption"].split(", ")
    assert len(caption) - (caption[0] == "meme") == min(kwargs["tags_per_img"], 12)
