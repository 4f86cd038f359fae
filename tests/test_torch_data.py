"""The port's image pipeline against Pillow and the JAX package's datasets.

- ``data/png.py`` reads what Pillow writes (L, LA, RGB, RGBA; Pillow's
  adaptive filters) and writes what Pillow reads, under each filter type, bit
  for bit; it refuses palette, 16-bit, interlaced and corrupt files.
- The cover resize equals Pillow's ``ImageOps.cover(..., BICUBIC)`` pixel for
  pixel, down and up, on random images; alpha over white equals Pillow's.
- ``FolderSquareDataset``, ``ImageFolderDataset`` with ``WDXLBucketList`` (an
  undersized portrait bucket merged, tags shuffled) and ``FolderVAEDataset``
  on one folder with one seed give the JAX package's batch order, captions,
  crop offsets, size tuples and pixels, exactly, over two epochs; the float
  path of ``image_to_array`` within 1 ulp (x·(2/255) − 1 against JAX's
  numpy or native core).
"""

import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
Image = pytest.importorskip("PIL.Image")
from PIL import ImageOps  # noqa: E402

MODES = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _pixels(rng, h, w, ch):
    """A smooth ramp with noise on every third row: Pillow's adaptive filter
    then picks several filter types in one file."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 5 + yy * 3 + 40 * c) % 256 for c in range(ch)], -1)
    base[::3] = rng.randint(0, 256, size=base[::3].shape)
    arr = base.astype(np.uint8)
    return arr[..., 0] if ch == 1 else arr


def _filter_types(path) -> set:
    data = path.read_bytes()
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(hdr[1], -1)[:, 0].tolist())


@pytest.mark.parametrize("mode", list(MODES))
def test_png_reads_what_pillow_writes(tmp_path, mode):
    from neurosis_tpu_torch.data import png

    rng = np.random.RandomState(len(mode))
    seen = set()
    for h, w in ((37, 53), (64, 64), (5, 300)):
        arr = _pixels(rng, h, w, MODES[mode])
        path = tmp_path / f"{mode}_{h}.png"
        Image.fromarray(arr, mode).save(path)
        seen |= _filter_types(path)
        got, got_mode, transparency = png.read_png(path)
        assert got_mode == mode and transparency is None
        np.testing.assert_array_equal(got, np.asarray(Image.open(path)))
        assert png.read_size(path) == Image.open(path).size
    assert len(seen) >= 3, seen  # Pillow's adaptive filtering mixed the rows' types


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("mode", list(MODES))
def test_png_writes_what_pillow_reads(tmp_path, mode, filter_type):
    from neurosis_tpu_torch.data import png

    arr = _pixels(np.random.RandomState(filter_type), 29, 41, MODES[mode])
    path = tmp_path / "own.png"
    png.write_png(path, arr, filter_type)
    assert _filter_types(path) == {filter_type}
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), arr)
    np.testing.assert_array_equal(png.read_png(path)[0], arr)


def test_png_refuses_what_it_does_not_read(tmp_path):
    from neurosis_tpu_torch.data import png

    rgb = _pixels(np.random.RandomState(0), 8, 8, 3)
    Image.fromarray(rgb).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(tmp_path / "p.png")
    Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)).save(tmp_path / "i16.png")
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(tmp_path / "i16.png")
    png.write_png(tmp_path / "own.png", rgb)
    data = bytearray((tmp_path / "own.png").read_bytes())
    data[28] = 1  # the IHDR's interlace byte, its CRC left stale
    (tmp_path / "bad_crc.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(tmp_path / "bad_crc.png")
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    (tmp_path / "interlaced.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(tmp_path / "interlaced.png")


@pytest.mark.parametrize("w,h,size", [
    (80, 96, (64, 64)), (96, 80, (64, 64)), (1100, 1040, (1024, 1024)), (37, 211, (64, 64)), (64, 64, (200, 120)),
    (513, 257, (256, 256)), (300, 700, (896, 1152)), (1500, 1000, (256, 256)), (640, 480, (1216, 832)),
    (64, 64, (64, 64)),
])
def test_cover_resize_equals_pillow(w, h, size):
    from neurosis_tpu_torch.data.utils import cover_resize

    arr = np.random.RandomState(w + h).randint(0, 256, size=(h, w, 3)).astype(np.uint8)
    want = np.asarray(ImageOps.cover(Image.fromarray(arr), size, method=Image.Resampling.BICUBIC))
    np.testing.assert_array_equal(cover_resize(arr, size), want)


@pytest.mark.parametrize("mode,transparency", [("RGBA", None), ("LA", None), ("L", None), ("L", 7), ("RGB", None),
                                               ("RGB", (7, 8, 9))])
def test_decode_equals_jax_ensure_rgb(tmp_path, mode, transparency):
    """A PNG through the port's decode and the JAX package's
    pil_ensure_rgb(Image.open(...)) gives the same RGB pixels."""
    from neurosis_tpu.data.utils import pil_ensure_rgb as jax_ensure_rgb

    from neurosis_tpu_torch.data.utils import decode_image

    rng = np.random.RandomState(3)
    arr = _pixels(rng, 23, 31, MODES[mode])
    if mode in ("RGBA", "LA"):
        arr[..., -1] = rng.choice([0, 1, 128, 254, 255], size=arr.shape[:2])
    if transparency is not None:
        arr[:4] = transparency
    path = tmp_path / "t.png"
    Image.fromarray(arr, mode).save(path, **({} if transparency is None else {"transparency": transparency}))
    want = np.asarray(jax_ensure_rgb(Image.open(path)))
    np.testing.assert_array_equal(decode_image(path), want)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """PNGs and a JPEG of several aspects (one portrait bucket holding a
    single image, below the batch size) with tag captions."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.RandomState(0)
    sizes = [(96, 96), (100, 96), (96, 100), (128, 84), (130, 86), (84, 128), (64, 112), (150, 100)]
    for i, (w, h) in enumerate(sizes):
        arr = _pixels(rng, h, w, 3)
        ext = "jpg" if i == 3 else "png"
        Image.fromarray(arr).save(root / f"img_{i}.{ext}")
        (root / f"img_{i}.txt").write_text(", ".join(f"tag_{j} word{j}" for j in rng.permutation(6)[:4]))
    (root / "sub").mkdir()
    Image.fromarray(_pixels(rng, 90, 120, 3)).save(root / "sub" / "deep.png")
    (root / "sub" / "deep.txt").write_text("deep, nested image")
    return root


def _same_batch(got: dict, want: dict, atol: float = 0.0):
    assert list(got) == list(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol, err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("kind,kwargs", [
    ("ImageFolderDataset", dict(batch_size=2, seed=3, image_dtype="uint8", recursive=True)),
    ("ImageFolderDataset", dict(batch_size=1, seed=5, image_dtype="uint8", shuffle_tags=False, clamp_orig=False)),
    ("FolderSquareDataset", dict(resolution=64, batch_size=2, seed=1, image_dtype="uint8", shuffle_tags=True)),
    ("FolderSquareDataset", dict(resolution=48, batch_size=3, seed=2)),
    ("FolderVAEDataset", dict(resolution=64, batch_size=2, seed=4, recursive=True)),
])
def test_datasets_give_jax_batches(folder, kind, kwargs):
    from neurosis_tpu.data import aspect as jax_aspect
    from neurosis_tpu.data import imagefolder as jax_imagefolder

    from neurosis_tpu_torch.data import aspect, imagefolder

    if kind == "ImageFolderDataset":
        want = jax_imagefolder.ImageFolderDataset(folder, buckets=jax_aspect.WDXLBucketList(), **kwargs)
        got = imagefolder.ImageFolderDataset(folder, buckets=aspect.WDXLBucketList(), **kwargs)
        np.testing.assert_array_equal(got.bucket_idx, want.samples.bucket_idx.to_numpy())
    else:
        want = getattr(jax_imagefolder, kind)(folder, **kwargs)
        got = getattr(imagefolder, kind)(folder, **kwargs)
    atol = 0.0 if kwargs.get("image_dtype") == "uint8" else 2.4e-7  # 1 ulp at 1.0
    for _epoch in range(2):
        schedule = list(want.get_batch_iterator())
        assert list(got.get_batch_iterator()) == schedule
        assert schedule
        for indices in schedule:
            _same_batch(got.get_batch(indices), want.get_batch(indices), atol)


def test_bucket_lists_equal_jax():
    from neurosis_tpu.data import aspect as jax_aspect

    from neurosis_tpu_torch.data import aspect

    for name in ("SDXLBucketList", "WDXLBucketList", "WDXLBucketList2"):
        got, want = getattr(aspect, name)(), getattr(jax_aspect, name)()
        assert [b.size for b in got] == [b.size for b in want]
        ratios = np.linspace(0.2, 5.0, 97).tolist() + [1.0]
        assert [got.bucket_idx(r) for r in ratios] == [want.bucket_idx(r) for r in ratios]
    for n in (5, 9, 15):
        got, want = aspect.AspectBucketList(n_buckets=n), jax_aspect.AspectBucketList(n_buckets=n)
        assert [b.size for b in got] == [b.size for b in want]
    with pytest.raises(ValueError, match="25 buckets requested"):  # as JAX's default raises
        aspect.AspectBucketList()
