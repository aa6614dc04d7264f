"""The port's image-directory source against the JAX package's, on the CPU.

* ``load_images`` returns the JAX loader's frames, bit for bit, on png, bmp,
  tiff, jpeg and webp files (through cv2 here), and through PIL when cv2 is
  missing; the lossless formats give back the frames written.
* A directory with no image, or none that decodes, raises as in JAX.
* ``ImageDirectory`` yields the loaded frames in name order, looping or not.
"""

import sys
import threading

import numpy as np
import pytest
import torch_cpu_pool  # noqa: F401  (torch's CPU pool at one thread)

from cuauv_vision_pipeline_tpu.capture_sources import image_directory as jdir
from cuauv_vision_pipeline_tpu_torch.capture_sources import image_directory as tdir
from cuauv_vision_pipeline_tpu_torch.capture_sources.synthetic import buoy_frame
from cuauv_vision_pipeline_tpu_torch.core.capture_source import FpsLimiter

cv2 = pytest.importorskip("cv2")

# odd widths pad each row to 4 bytes in a 24-bit BMP (3 * 161 = 483 -> 484)
SHAPES = [(7, 1), (5, 2), (9, 3), (6, 5), (33, 161), (120, 160)]


def _frames():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in SHAPES]


def _without(monkeypatch, *names):
    """Make ``import name`` raise ImportError for each name."""
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


LOSSLESS = (".png", ".bmp", ".tif")
EXTENSIONS = LOSSLESS + (".jpg", ".webp")


@pytest.mark.parametrize("ext", EXTENSIONS)
def test_load_images_equals_jax(tmp_path, ext):
    frames = _frames()
    for i, frame in enumerate(frames):
        assert cv2.imwrite(str(tmp_path / f"f{i:02d}{ext}"), frame)
    (tmp_path / "notes.txt").write_text("not an image")
    got = tdir.load_images(str(tmp_path))
    want = jdir.load_images(str(tmp_path))
    assert len(got) == len(want) == len(frames)
    for g, w, f in zip(got, want, frames):
        np.testing.assert_array_equal(g, w)
        if ext in LOSSLESS:
            np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("ext", EXTENSIONS)
def test_load_images_through_pil_equals_jax(tmp_path, monkeypatch, ext):
    pytest.importorskip("PIL")
    for i, frame in enumerate(_frames()):
        assert cv2.imwrite(str(tmp_path / f"f{i:02d}{ext}"), frame)
    _without(monkeypatch, "cv2")
    got = tdir.load_images(str(tmp_path))
    want = jdir.load_images(str(tmp_path))
    assert len(got) == len(want) == len(SHAPES)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_empty_directory_raises(tmp_path):
    (tmp_path / "readme.txt").write_text("")
    with pytest.raises(FileNotFoundError):
        tdir.load_images(str(tmp_path))


def test_nothing_decodable_raises_as_in_jax(tmp_path):
    (tmp_path / "a.png").write_bytes(b"not a png")
    (tmp_path / "b.bmp").write_bytes(b"BM" + bytes(60))
    for loader in (jdir.load_images, tdir.load_images):
        with pytest.raises(RuntimeError, match="failed to decode"):
            loader(str(tmp_path))


@pytest.mark.parametrize("loop", [False, True])
def test_image_directory_yields_frames_in_name_order(tmp_path, monkeypatch, loop):
    frames = [buoy_frame((24, 32), t) for t in (0.0, 1.0, 2.0)]
    for i, frame in zip((2, 0, 1), frames):
        assert cv2.imwrite(str(tmp_path / f"f{i}.bmp"), frame)
    registered = []
    monkeypatch.setattr(tdir.ImageDirectory, "register_capture_udl",
                        lambda self, name, udl, args=(): registered.append((name, udl)))
    tdir.ImageDirectory(str(tmp_path), "cam", fps=1000, loop=loop)
    [(name, udl)] = registered
    assert name == "image_directory:cam"
    gen = udl(FpsLimiter("test", threading.Event()), ())
    got = [next(gen) for _ in range(3)]
    assert [d for d, _, _ in got] == ["cam"] * 3
    for (_, _, img), want in zip(got, (frames[1], frames[2], frames[0])):
        np.testing.assert_array_equal(img, want)
    if loop:
        np.testing.assert_array_equal(next(gen)[2], frames[1])
    else:
        with pytest.raises(StopIteration):
            next(gen)
