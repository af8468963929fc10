"""Out-of-corpus JPEG decode fuzz.

The corpus IO tests (tests/test_io.py) prove region==full decode and
loader equivalence over the 304 sample images; this file fuzzes the
native decoder on images the corpus never covered. Oracle: Pillow,
which links libjpeg-turbo with the same defaults our decoder pins
(ISLOW DCT + fancy upsampling) — the combination verified
byte-compatible with the reference's 2019 OpenCV wheel (SURVEY.md
§8bis item 3). Coverage: noise / gradient / synthetic-meter content,
quality and chroma-subsampling sweeps, progressive encoding, odd
(non-iMCU-aligned) frame sizes, and random region rects.
"""
import io
import os

import numpy as np
import pytest

from meterelf_jax.io import jpeg as jio
from meterelf_jax.types import Rect

PIL = pytest.importorskip("PIL.Image")


def _images(rng):
    """(name, RGB uint8 array) cases: content the corpus lacks."""
    yield "noise_640x480", rng.integers(0, 256, (480, 640, 3), np.uint8)
    # odd sizes: exercise partial trailing iMCUs in both dimensions
    yield "noise_157x123", rng.integers(0, 256, (123, 157, 3), np.uint8)
    yy, xx = np.mgrid[0:200, 0:300]
    grad = np.stack([(xx * 255 // 299), (yy * 255 // 199),
                     ((xx + yy) % 256)], -1).astype(np.uint8)
    yield "gradient_300x200", grad
    from meterelf_jax import synthetic
    frame_bgr = synthetic.render_frame([1.5, 2.5, 3.5, 4.5])
    yield "synthetic_meter", frame_bgr[..., ::-1]  # to RGB


def _encodings():
    """(tag, PIL save kwargs): quality/subsampling/progressive sweep."""
    for q in (30, 75, 95):
        for ss in (0, 1, 2):  # 4:4:4, 4:2:2, 4:2:0
            yield f"q{q}_ss{ss}", dict(quality=q, subsampling=ss)
    yield "q85_progressive", dict(quality=85, progressive=True)


@pytest.mark.parametrize("enc_tag,enc_kw", list(_encodings()))
def test_full_decode_matches_pil_oracle(tmp_path, enc_tag, enc_kw):
    rng = np.random.default_rng(0xC0FFEE)
    for name, rgb in _images(rng):
        buf = io.BytesIO()
        PIL.fromarray(rgb).save(buf, "JPEG", **enc_kw)
        data = buf.getvalue()
        path = os.path.join(tmp_path, f"{name}_{enc_tag}.jpg")
        with open(path, "wb") as fp:
            fp.write(data)

        oracle_rgb = np.asarray(PIL.open(io.BytesIO(data)).convert("RGB"))
        ours_bgr = jio.decode_file(path)
        assert ours_bgr is not None, (name, enc_tag)
        got_rgb = ours_bgr[..., ::-1]
        n_diff = int((got_rgb != oracle_rgb).sum())
        assert n_diff == 0, (
            f"{name} {enc_tag}: {n_diff} byte diffs vs PIL oracle")

        in_mem = jio._decode_bytes_full(data)
        assert in_mem is not None and (in_mem == ours_bgr).all(), (
            f"{name} {enc_tag}: in-memory decode != file decode")


def test_region_decode_matches_full_on_fuzz(tmp_path):
    rng = np.random.default_rng(0xD1A15)
    for name, rgb in _images(rng):
        path = os.path.join(tmp_path, f"{name}.jpg")
        PIL.fromarray(rgb).save(path, "JPEG", quality=80, subsampling=2)
        full = jio.decode_file(path)
        assert full is not None
        h, w = full.shape[:2]
        for _ in range(8):
            x0 = int(rng.integers(0, w - 8))
            y0 = int(rng.integers(0, h - 8))
            x1 = int(rng.integers(x0 + 4, min(w, x0 + 260) + 1))
            y1 = int(rng.integers(y0 + 4, min(h, y0 + 260) + 1))
            rect = Rect(top_left=(x0, y0), bottom_right=(x1, y1))
            region = jio.decode_region(path, rect)
            assert region is not None, (name, rect)
            want = full[y0:y1, x0:x1]
            assert (region == want).all(), (
                f"{name} rect {rect}: region decode != full-decode crop")
