"""The port's image utilities (neurosis_tpu_torch/utils/{image,sgm,font}.py)
against the JAX package's Pillow ones, on seeded numpy images.

The port draws text from a glyph atlas of the JAX package's font
(NotoSansMono at 12 px for captions and labels). Grids must have JAX's
geometry, their image tiles must be equal pixel for pixel, and their caption
bands must differ from Pillow's by at most 1 in 1000 pixels and 8 levels;
the atlas itself reproduces Pillow exactly on the lines the tool checks (a
test below reruns that check). ``log_txt_as_img`` uses another font in the
JAX package (DejaVuSans where the system has it), so only its geometry, its
line breaks and its ink share are held there.
"""

import numpy as np
import pytest

pytest.importorskip("jax")
Image = pytest.importorskip("PIL.Image")
torch = pytest.importorskip("torch")

from torch_parity import one_torch_thread  # noqa: E402,F401

CAPTIONS = ["a photograph of an astronaut riding a horse on the moon, highly detailed, 8k",
            "tag0, a test image, simple", "one", "wwwwww wwwwwwwww wwwwwwwwwwww tw Wi"]


def _images(n=4, h=48, w=64, seed=0):
    return [np.random.RandomState(seed + i).uniform(-1, 1, (h, w, 3)).astype(np.float32) for i in range(n)]


def _band_diff(got: np.ndarray, want: np.ndarray) -> tuple:
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    return (int(d.max()), float((d > 0).mean())) if d.size else (0, 0.0)


def _text_lines(image: np.ndarray) -> int:
    """Runs of rows with ink: the lines of text drawn."""
    ink = (image < 1).any(axis=(1, 2)).astype(int)
    return int((np.diff(np.concatenate([[0], ink])) == 1).sum())


def test_rendered_atlas_equals_pillow():
    """The committed atlas draws the tool's sample lines as Pillow does, pixel
    for pixel, and their boxes equal Pillow's getbbox."""
    from neurosis_tpu_torch.tools import render_glyph_atlas

    render_glyph_atlas.check()


@pytest.mark.parametrize("cols,pad,with_captions", [(2, 4, True), (3, 2, True), (2, 4, False), (4, 0, True)])
def test_caption_grid_equals_pillow(cols, pad, with_captions):
    from neurosis_tpu.utils.image import caption_grid as jgrid

    from neurosis_tpu_torch.utils.image import caption_grid

    images = _images()
    captions = CAPTIONS if with_captions else None
    want = np.asarray(jgrid(images, captions, cols=cols, pad=pad))
    got = caption_grid(images, captions, cols=cols, pad=pad)
    assert got.dtype == np.uint8 and got.shape == want.shape
    h, w = 48, 64
    cap_h = (want.shape[0] - pad) // ((4 + cols - 1) // cols) - h - pad
    band = np.zeros(want.shape[:2], bool)
    for i in range(4):
        r, c = divmod(i, cols)
        x0, y0 = pad + c * (w + pad), pad + r * (h + cap_h + pad)
        np.testing.assert_array_equal(got[y0:y0 + h, x0:x0 + w], want[y0:y0 + h, x0:x0 + w])
        band[y0 + h:y0 + h + cap_h, x0:x0 + w] = True
    np.testing.assert_array_equal(got[~band], want[~band])
    worst, share = _band_diff(got[band], want[band])
    assert worst <= 8 and share <= 1e-3, (worst, share)


def test_save_image_grid_with_label_equals_pillow(tmp_path):
    """save_image_grid with a step label: the PNG read back equals Pillow's
    grid, label box included."""
    from neurosis_tpu.utils.image import save_image_grid as jsave

    from neurosis_tpu_torch.data.png import read_png
    from neurosis_tpu_torch.utils.image import save_image_grid

    images = _images(3)
    jsave(images, tmp_path / "want.png", captions=CAPTIONS[:3], label="step 1200")
    save_image_grid(images, tmp_path / "got.png", captions=CAPTIONS[:3], label="step 1200")
    want = np.asarray(Image.open(tmp_path / "want.png").convert("RGB"))
    got, mode, _ = read_png(tmp_path / "got.png")
    assert mode == "RGB" and got.shape == want.shape
    np.testing.assert_array_equal(got[:30, :120], want[:30, :120])  # the label and its box
    worst, share = _band_diff(got, want)
    assert worst <= 8 and share <= 1e-3


@pytest.mark.parametrize("text", ["step 7", "step 1200, -0.53", "g_j|~", "Wi tw"])
def test_stamp_label_equals_pillow(text):
    from neurosis_tpu.utils.image import stamp_label as jstamp

    from neurosis_tpu_torch.utils.image import stamp_label, to_uint8

    image = to_uint8(_images(1, 40, 140)[0])
    want = np.asarray(jstamp(Image.fromarray(image.copy()), text))
    np.testing.assert_array_equal(stamp_label(image.copy(), text), want)


def test_small_utilities_equal_jax():
    """denormalize, make_grid_nhwc, the diverging colour map, array_to_pil's
    conversion (both ranges, one channel) and the caption wrap."""
    from neurosis_tpu.utils import image as J
    from PIL import ImageDraw

    from neurosis_tpu_torch.utils import image as T

    rng = np.random.RandomState(1)
    x = rng.uniform(-1.2, 1.2, (5, 6, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(T.denormalize(x), J.denormalize(x))
    for ncols, pad in ((2, 0), (4, 3), (9, 1)):
        np.testing.assert_array_equal(T.make_grid_nhwc(x, ncols, pad), J.make_grid_nhwc(x, ncols, pad))
    v = rng.rand(4, 5).astype(np.float32)
    np.testing.assert_array_equal(T.diverging_colormap(v), J.diverging_colormap(v))
    for arr in (x[0], (x[0] + 1.2) / 2.4, x[0, ..., :1]):
        np.testing.assert_array_equal(T.to_uint8(arr), np.asarray(J.array_to_pil(arr)))
    font = J._default_font()
    draw = ImageDraw.Draw(Image.new("RGB", (8, 8)))
    for text in CAPTIONS + ["a " * 80]:
        assert T.wrap_caption(text, 60) == J.wrap_caption(text, font, 60, draw)
        assert T.wrap_caption(text, 300) == J.wrap_caption(text, font, 300, draw)


def test_log_txt_as_img_geometry_equals_jax():
    """Shape, range, white ground and line breaks of log_txt_as_img as JAX's
    (on images tall enough for every line: the fonts' line spacings differ,
    15 px here, 14 with DejaVuSans); the ink (pixels below white) within a
    factor of 2 of JAX's other font."""
    from neurosis_tpu.utils.sgm import log_txt_as_img as jlog

    from neurosis_tpu_torch.utils.sgm import log_txt_as_img

    texts = ["short", "a caption long enough to wrap onto a second line of the 64 pixel image " * 2]
    for wh in ((64, 80), (256, 256)):
        got, want = log_txt_as_img(wh, texts), jlog(wh, texts)
        assert got.shape == want.shape == (2, wh[1], wh[0], 3) and got.dtype == np.float32
        assert got.min() >= -1 and got.max() == 1.0
        for g, w in zip(got, want):
            assert _text_lines(g) == _text_lines(w) > 0
            assert 0.5 <= (g < 1).mean() / (w < 1).mean() <= 2.0


def test_colorbar_strip_equals_jax():
    """The loss's colour bar: the ramp exact, the ±high labels within the
    caption bound."""
    from neurosis_tpu.losses.vae_loss import _colorbar_strip

    from neurosis_tpu_torch.losses.vae_loss import colorbar_strip

    for width, high in ((256, 3.14159), (100, 0.05)):
        got, want = colorbar_strip(width, high), _colorbar_strip(width, high)
        assert got.shape == want.shape == (24, width, 3)
        np.testing.assert_array_equal(got[16:], want[16:])
        worst, share = _band_diff((got * 255).round(), (want * 255).round())
        assert worst <= 8 and share <= 1e-3, (worst, share)
