"""Native JPEG input-pipeline tests: region-decode byte parity vs full
decode (including the corrupt/truncated frames), loader equivalence,
and fallback behavior."""
import os
from glob import glob

import numpy as np
import pytest

from meterelf_jax.io import jpeg as jio
from meterelf_jax.params import Params
from meterelf_jax.types import Rect

S1 = "/root/reference/sample-images1"
S2 = "/root/reference/sample-images2"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(S1), reason="sample corpus not mounted")


def _params(sdir):
    return Params.load(os.path.join(sdir, "params.yml"))


def _some_files(sdir, k=8):
    files = sorted(glob(os.path.join(sdir, "*.jpg")))
    # always include the two corrupt frames (sorted first in S1)
    return files[:k]


@pytest.mark.parametrize("sdir", [S1, S2])
def test_region_decode_matches_full(sdir):
    """decode_region == crop(decode_file) byte-for-byte (the margin
    preserves fancy-upsampling context; the full corpus was validated
    once — this pins a representative subset incl. truncated files)."""
    params = _params(sdir)
    rect = params.meter_rect
    n = len(glob(os.path.join(sdir, "*.jpg"))) if os.environ.get(
        "METERELF_FULL_GOLDEN") else 8
    for fn in _some_files(sdir, n):
        full = jio.decode_file(fn)
        reg = jio.decode_region(fn, rect)
        if full is None:
            assert reg is None or reg.shape == (rect.height, rect.width, 3)
            continue
        assert reg is not None, fn
        assert np.array_equal(jio.crop_rect(full, rect), reg), fn


def test_threaded_loader_matches_serial():
    params = _params(S1)
    files = _some_files(S1, 12)
    c1, ok1 = jio.load_crops(files, params.meter_rect)
    c2, ok2 = jio.load_crops_threaded(files, params.meter_rect,
                                      num_threads=4)
    assert np.array_equal(ok1, ok2)
    assert np.array_equal(c1, c2)


def test_region_fallback_for_undersized_frames(tmp_path):
    """A frame smaller than the meter rect takes the fallback path and
    is flagged load_ok=False (graceful degradation; the reference would
    crash on the slice)."""
    from PIL import Image

    small = tmp_path / "small.jpg"
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(str(small))
    big_rect = Rect((50, 160), (300, 410))
    crops, ok = jio.load_crops([str(small)], big_rect)
    assert not ok[0]
    crops, ok = jio.load_crops_threaded([str(small)], big_rect)
    assert not ok[0]


def test_missing_file_flagged():
    params = _params(S1)
    crops, ok = jio.load_crops(["/does/not/exist.jpg"], params.meter_rect)
    assert not ok[0]
    crops, ok = jio.load_crops_threaded(
        ["/does/not/exist.jpg"], params.meter_rect)
    assert not ok[0]


@pytest.mark.needs_samples
def test_u8_bytes_loader_matches_load_crops(params1):
    """The raw-u8 bytes loader (minimal H2D feed) must equal the
    path-based load_crops over the whole corpus, and the device-side
    pack must equal the host-side pack_crops composition."""
    from glob import glob

    import jax

    from meterelf_jax.pipeline.decode import pack_crops_device

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))
    datas = [open(f, "rb").read() for f in files]

    crops_u8, ok1 = jio.load_crop_bytes_u8(datas, params1.meter_rect)
    crops_ref, ok2 = jio.load_crops(files, params1.meter_rect)
    assert np.array_equal(ok1, ok2)
    assert np.array_equal(crops_u8[ok1], crops_ref[ok2])

    packed_dev = np.asarray(jax.jit(pack_crops_device)(crops_u8))
    packed_host = jio.pack_crops(np.where(ok1[:, None, None, None],
                                          crops_u8, 0))
    assert np.array_equal(packed_dev[ok1], packed_host[ok1])


@pytest.mark.needs_samples
def test_packed_loader_matches_crop_plus_pack(params1):
    """The one-pass C decode+crop+pack staging path must equal the
    two-step load_crops + pack_crops composition over the whole corpus,
    including the corrupt frames' full-decode fallback."""
    from glob import glob

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))
    datas = [open(f, "rb").read() for f in files]
    packed1, ok1 = jio.load_packed_crops_from_bytes(
        datas, params1.meter_rect, num_threads=2)
    crops, ok2 = jio.load_crops(files, params1.meter_rect)
    packed2 = jio.pack_crops(crops)

    assert np.array_equal(ok1, ok2)
    assert np.array_equal(packed1, packed2)


def test_decoder_selfcheck_runs_and_pins_parity(monkeypatch):
    """The embedded-fixture self-check passed at lib load (or _get_lib
    would have raised); a digest drift must raise with diagnostics."""
    from meterelf_jax.io import _selfcheck_data as sd

    lib = jio._get_lib()
    jio._decoder_selfcheck(lib)  # idempotent pass on the live libjpeg
    monkeypatch.setattr(sd, "CHECK_BGR_SHA256", "0" * 64)
    monkeypatch.delenv("METERELF_SKIP_DECODER_CHECK", raising=False)
    with pytest.raises(RuntimeError, match="pinned parity target"):
        jio._decoder_selfcheck(lib)
    monkeypatch.setenv("METERELF_SKIP_DECODER_CHECK", "1")
    jio._decoder_selfcheck(lib)  # explicit opt-out proceeds


def test_selfcheck_failure_is_not_cached(monkeypatch):
    """If the parity self-check fails at library load, EVERY subsequent
    _get_lib() must re-raise instead of handing out the off-parity
    decoder (the handle is published only after the check passes)."""
    calls = []

    def boom(lib):
        calls.append(1)
        raise RuntimeError("decode parity failure (test)")

    monkeypatch.setattr(jio, "_decoder_selfcheck", boom)
    monkeypatch.setattr(jio, "_lib", None)
    with pytest.raises(RuntimeError, match="parity failure"):
        jio._get_lib()
    with pytest.raises(RuntimeError, match="parity failure"):
        jio._get_lib()
    assert len(calls) == 2 and jio._lib is None
