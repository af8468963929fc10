"""Device JPEG back-half (ops/jpegdec.py) parity vs the native pixel
decoder.

The coefficient feed ships entropy-decoded DCT blocks and finishes the
decode in the jitted graph; its output must be byte-identical to the
pixel path (io/native region decode), which is itself the verified
byte-exact match for the reference's 2019 OpenCV wheel (SURVEY.md
§8bis). Oracles here: the pixel path over the committed synthetic corpus
(tests/data/synthetic), and PIL-encoded fuzz frames (odd sizes,
edge-touching rects, quality sweep, layout fallbacks)."""
import glob
import io as _io
import os

import numpy as np
import pytest

import jax

from meterelf_jax.io import jpeg as jio
from meterelf_jax.ops import jpegdec
from meterelf_jax.types import Rect

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "synthetic")
DEFAULT_DIR = os.path.join(FIXTURES, "default")
RECT1 = Rect(top_left=(50, 160), bottom_right=(300, 410))  # default camera
FRAME_WH = (640, 480)


def _fixture_files(camera_dir):
    files = sorted(glob.glob(os.path.join(camera_dir, "*.jpg")))
    assert len(files) == 48
    return files


def _backhalf_batch(datas, rect, frame_wh):
    win = jpegdec.coef_window(rect, frame_wh[0], frame_wh[1])
    cy, cb, cr, qt, ok = jio.read_coefs_batch(datas, win, frame_wh)
    fn = jax.jit(
        lambda a, b, c, q: jpegdec.backhalf_to_packed(a, b, c, q, win))
    return np.asarray(fn(cy, cb, cr, qt)), ok


def test_corpus_coef_feed_matches_pixel_path(fixture_camera):
    """Every committed frame, truncated ones included, decodes through
    the coefficient feed exactly like the pixel path."""
    _name, camera_dir, params = fixture_camera
    rect = params.meter_rect
    files = _fixture_files(camera_dir)
    datas = [open(f, "rb").read() for f in files]
    packed_px, ok_px = jio.load_packed_crops_from_bytes(
        datas, rect)
    packed_cf, ok_cf = _backhalf_batch(datas, rect, FRAME_WH)
    assert ok_cf.all() and ok_px.all()
    for i, f in enumerate(files):
        np.testing.assert_array_equal(
            packed_cf[i], packed_px[i], err_msg=os.path.basename(f))


def _encode(arr_rgb, **kw):
    from PIL import Image
    buf = _io.BytesIO()
    Image.fromarray(arr_rgb, "RGB").save(buf, "JPEG", **kw)
    return buf.getvalue()


def _rng_frame(rng, w, h):
    # smooth-ish content plus hard edges: exercises big AC coefficients
    y, x = np.mgrid[0:h, 0:w]
    base = (128 + 80 * np.sin(x / 9.0) * np.cos(y / 13.0))
    img = np.stack([base + rng.integers(-40, 40, (h, w)),
                    base + rng.integers(-40, 40, (h, w)),
                    base + rng.integers(-40, 40, (h, w))], axis=-1)
    img[h // 3:h // 3 + 7] = 255
    img[:, w // 2:w // 2 + 5] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def test_fuzz_coef_feed_matches_pixel_path():
    rng = np.random.default_rng(20260818)
    cases = [
        # (frame w, h, rect x0 y0 x1 y1)  — interior + every edge/corner
        (480, 640, (50, 160, 300, 410)),
        (480, 640, (0, 0, 64, 48)),          # top-left corner
        (480, 640, (432, 600, 480, 640)),    # bottom-right corner
        (175, 133, (0, 0, 175, 133)),        # whole odd-sized frame
        (161, 97, (140, 70, 161, 97)),       # odd size, right/bottom edge
        (320, 240, (7, 3, 311, 235)),        # near-full, off-grid origin
        (48, 32, (0, 0, 48, 32)),            # tiny frame
    ]
    for q in (25, 80, 95):
        for (w, h, (x0, y0, x1, y1)) in cases:
            rect = Rect(top_left=(x0, y0), bottom_right=(x1, y1))
            data = _encode(_rng_frame(rng, w, h), quality=q,
                           subsampling=2)   # 4:2:0
            packed_px, ok_px = jio.load_packed_crops_from_bytes(
                [data], rect)
            packed_cf, ok_cf = _backhalf_batch([data], rect, (w, h))
            assert ok_px[0] and ok_cf[0], (w, h, q, rect)
            np.testing.assert_array_equal(
                packed_cf[0], packed_px[0],
                err_msg=f"frame {w}x{h} q{q} rect {rect}")


def test_truncated_files_match_pixel_path():
    """Truncated streams exercise the suspending source's fake-EOI path
    (the corrupt-frame behavior contract: decode what's there, zero-fill
    the rest, no stderr). Coef and pixel paths must agree byte-for-byte
    at EVERY truncation point sampled across the file."""
    rng = np.random.default_rng(99)
    w, h = 480, 640
    rect = Rect(top_left=(50, 160), bottom_right=(300, 410))
    data = _encode(_rng_frame(rng, w, h), quality=85, subsampling=2)
    cuts = ([2, 40, 300, 700]                       # header-region cuts
            + [len(data) * k // 7 for k in range(1, 7)]
            + [len(data) - 1])
    for cut in cuts:
        trunc = data[:cut]
        packed_px, ok_px = jio.load_packed_crops_from_bytes(
            [trunc], rect)
        packed_cf, ok_cf = _backhalf_batch([trunc], rect, (w, h))
        assert bool(ok_cf[0]) == bool(ok_px[0]), cut
        if not ok_cf[0]:
            continue  # header lost: both paths reject
        np.testing.assert_array_equal(
            packed_cf[0], packed_px[0], err_msg=f"cut at {cut}")


def test_restart_markers_match_pixel_path():
    """Restart intervals change the entropy-decode structure (DC
    predictor resets, marker resyncs) — the suspension loop must hand
    them through intact."""
    from PIL import Image
    rng = np.random.default_rng(55)
    w, h = 320, 240
    rect = Rect(top_left=(30, 40), bottom_right=(290, 200))
    frame = _rng_frame(rng, w, h)
    buf = _io.BytesIO()
    try:
        Image.fromarray(frame, "RGB").save(
            buf, "JPEG", quality=85, subsampling=2, restart_marker_rows=2)
    except TypeError:
        pytest.skip("this Pillow cannot emit restart markers")
    data = buf.getvalue()
    assert b"\xff\xd0" in data or b"\xff\xd1" in data, \
        "encoder produced no restart markers"
    packed_px, ok_px = jio.load_packed_crops_from_bytes(
        [data], rect)
    packed_cf, ok_cf = _backhalf_batch([data], rect, (w, h))
    assert ok_px[0] and ok_cf[0]
    np.testing.assert_array_equal(packed_cf[0], packed_px[0])


def test_unsupported_layouts_fall_back():
    rng = np.random.default_rng(7)
    frame = _rng_frame(rng, 160, 128)
    rect = Rect(top_left=(16, 16), bottom_right=(80, 80))
    win = jpegdec.coef_window(rect, 160, 128)
    for kw in ({"subsampling": 0},              # 4:4:4
               {"subsampling": 1},              # 4:2:2
               {"progressive": True, "subsampling": 2}):
        data = _encode(frame, quality=85, **kw)
        *_, ok = jio.read_coefs_batch([data], win, (160, 128))
        assert not ok[0], kw
    # wrong frame size against the static geometry
    data = _encode(frame, quality=85, subsampling=2)
    *_, ok = jio.read_coefs_batch([data], win, (161, 128))
    assert not ok[0]
    # and the supported layout sanity check
    *_, ok = jio.read_coefs_batch([data], win, (160, 128))
    assert ok[0]


def _widen_dqt(data: bytes, scale: int = 1) -> bytes:
    """Rewrite every DQT table to 16-bit precision (Pq=1), values
    multiplied by ``scale`` — a legal baseline JPEG that libjpeg decodes
    fine but whose quant values can exceed the 8-bit range the fused
    device back-half assumes."""
    out = bytearray(data[0:2])
    i = 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xDA:                      # SOS: copy the rest verbatim
            out += data[i:]
            break
        ln = (data[i + 2] << 8) | data[i + 3]
        seg = data[i + 4:i + 2 + ln]
        if m == 0xDB:
            new = bytearray()
            j = 0
            while j < len(seg):
                new.append((1 << 4) | (seg[j] & 15))
                for v in seg[j + 1:j + 65]:
                    w = min(v * scale, 65535)
                    new += bytes([w >> 8, w & 255])
                j += 65
            nl = len(new) + 2
            out += bytes([0xFF, 0xDB, nl >> 8, nl & 255]) + new
        else:
            out += data[i:i + 2 + ln]
        i += 2 + ln
    return bytes(out)


def test_16bit_quant_tables_take_pixel_fallback():
    """A baseline 4:2:0 JPEG with 16-bit DQT values > 255 would silently
    wrap in the fused back-half's int8 limb decomposition (|coef*qt| <
    2^23 assumption), so BOTH coefficient readers must reject it — the
    fast reader at the DQT parse, the libjpeg fallback at the quantval
    copy — and load_coef_feed must route it through the pixel-fallback
    slots, which decode it exactly like libjpeg."""
    data = open(_fixture_files(DEFAULT_DIR)[0], "rb").read()
    wide = _widen_dqt(data, scale=64)      # q95 tables: max well > 255
    win = jpegdec.coef_window(RECT1, *FRAME_WH)
    *_, ok = jio.read_coefs_batch([data, wide], win, FRAME_WH)
    assert ok[0] and not ok[1]
    *_, load_ok, fb_packed, fb_idx = jio.load_coef_feed(
        [data, wide], RECT1, FRAME_WH)
    assert load_ok.all() and fb_idx[0] == 1
    full = jio._decode_bytes_full(wide)
    ref = jio.pack_crops(jio.crop_rect(full, RECT1)[None])[0]
    np.testing.assert_array_equal(np.asarray(fb_packed[0]), ref)
    # 16-bit precision with SAFE (<= 255) values is accepted by the
    # fallback reader and remains within the fused kernel's range
    safe = _widen_dqt(data, scale=1)
    cy, cb, cr, qt, ok = jio.read_coefs_batch([data, safe], win, FRAME_WH)
    assert ok.all() and qt.max() <= 255
    np.testing.assert_array_equal(cy[0], cy[1])


def test_plane_layout_matches_block_layout():
    """The C reader's frequency-plane output mode (plane_layout=True)
    must be exactly the block layout rearranged — over corpus frames
    (fast reader) and PIL fuzz frames (both readers), including the
    chroma planes and ok flags."""
    files = _fixture_files(DEFAULT_DIR)[:12]
    datas = [open(f, "rb").read() for f in files]
    rng = np.random.default_rng(3)
    datas.append(_encode(_rng_frame(rng, 480, 640), quality=90,
                         subsampling=2))
    win = jpegdec.coef_window(RECT1, *FRAME_WH)

    def to_plane(blk, bh, bw):
        n = blk.shape[0]
        return (blk.reshape(n, bh, bw, 8, 8).transpose(0, 1, 3, 2, 4)
                .reshape(n, bh * 8, bw * 8))

    b = jio.read_coefs_batch(datas, win, FRAME_WH)
    p = jio.read_coefs_batch(datas, win, FRAME_WH, plane_layout=True)
    np.testing.assert_array_equal(p[4], b[4])
    np.testing.assert_array_equal(p[3], b[3])
    np.testing.assert_array_equal(p[0], to_plane(b[0], win.lbh, win.lbw))
    np.testing.assert_array_equal(
        p[1], to_plane(b[1], win.lbh // 2, win.lbw // 2))
    np.testing.assert_array_equal(
        p[2], to_plane(b[2], win.lbh // 2, win.lbw // 2))


def _segments(data):
    """Split a JPEG byte stream into (marker, absolute start, seg bytes)
    triples up to SOS — enough structure to splice APPn/DRI segments
    into test streams."""
    out = []
    p = 2
    while p + 4 <= len(data):
        assert data[p] == 0xFF
        m = data[p + 1]
        ln = (data[p + 2] << 8) | data[p + 3]
        out.append((m, p, data[p:p + 2 + ln]))
        p += 2 + ln
        if m == 0xDA:
            break
    return out


def _strip_app0(data):
    segs = _segments(data)
    m0, p0, seg0 = segs[0]
    assert m0 == 0xE0, "PIL stream should start with JFIF APP0"
    return data[:p0] + data[p0 + len(seg0):]


def _insert_before_sof(data, segment):
    for m, p, _seg in _segments(data):
        if m in (0xC0, 0xC1):
            return data[:p] + segment + data[p:]
    raise AssertionError("no SOF marker found")


def _adobe_app14(transform):
    body = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
    return bytes([0xFF, 0xEE, 0, len(body) + 2]) + body


def test_fast_reader_matches_libjpeg_fallback():
    """The fast baseline coefficient reader (MEJ_FAST_COEFS=1, the
    default) must be indistinguishable from the libjpeg suspension
    fallback (=0): identical coefficients, quant tables, AND ok flags —
    including streams engineered to probe its header-validation edges:
    Adobe APP14 transform=0 without JFIF (libjpeg resolves
    RGB -> must fall back/reject), malformed DRI segment length
    (libjpeg ERREXITs), stripped-APP0 YCbCr-by-heuristic streams, and
    truncation points. The env flag is latched per-process
    (pthread_once), so each setting runs in a child process."""
    import json
    import subprocess
    import sys
    import tempfile

    rng = np.random.default_rng(20260819)
    frame = _rng_frame(rng, 160, 128)
    base = _encode(frame, quality=85, subsampling=2)       # JFIF 4:2:0
    cases = [base]
    cases.append(_strip_app0(base))            # no markers, IDs 1,2,3
    cases.append(_insert_before_sof(_strip_app0(base), _adobe_app14(0)))
    cases.append(_insert_before_sof(_strip_app0(base), _adobe_app14(1)))
    cases.append(_insert_before_sof(base, _adobe_app14(0)))  # JFIF wins
    # malformed DRI: length 5 (libjpeg requires exactly 4)
    bad_dri = bytes([0xFF, 0xDD, 0, 5, 0, 8, 0])
    cases.append(_insert_before_sof(base, bad_dri))
    cases.append(_encode(frame, quality=85, subsampling=0))  # 4:4:4
    cases.append(base[:len(base) // 2])                      # truncated
    cases.append(base[:len(base) - 1])
    for f in _fixture_files(DEFAULT_DIR)[20:26]:   # incl. a truncated one
        cases.append(open(f, "rb").read())

    d = tempfile.mkdtemp()
    for i, c in enumerate(cases):
        with open(os.path.join(d, f"{i}.bin"), "wb") as fp:
            fp.write(c)
    child = os.path.join(d, "child.py")
    with open(child, "w") as fp:
        fp.write(
            "import json, sys, types\n"
            "import numpy as np\n"
            "from meterelf_jax.io import jpeg as jio\n"
            "cfg = json.loads(sys.argv[1])\n"
            "datas = [open(f, 'rb').read() for f in cfg['files']]\n"
            "win = types.SimpleNamespace(**cfg['win'])\n"
            "out = jio.read_coefs_batch(datas, win, tuple(cfg['wh']))\n"
            "np.savez(cfg['out'], **{str(i): np.asarray(a)\n"
            "                        for i, a in enumerate(out)})\n")

    win = jpegdec.coef_window(Rect(top_left=(16, 16),
                                   bottom_right=(80, 80)), 160, 128)
    win1 = jpegdec.coef_window(RECT1, *FRAME_WH)
    outs = {}
    for fast in ("0", "1"):
        env = dict(os.environ, MEJ_FAST_COEFS=fast,
                   PYTHONPATH=os.pathsep.join(
                       [os.path.dirname(os.path.dirname(
                           os.path.abspath(__file__)))]
                       + os.environ.get("PYTHONPATH", "").split(
                           os.pathsep)))
        per_group = []
        for gi, (n_from, n_to, w, wh) in enumerate([
                (0, len(cases) - 6, win, (160, 128)),
                (len(cases) - 6, len(cases), win1, FRAME_WH)]):
            cfg = {
                "files": [os.path.join(d, f"{i}.bin")
                          for i in range(n_from, n_to)],
                "win": {k: int(getattr(w, k))
                        for k in ("lbx0", "lby0", "lbw", "lbh")},
                "wh": list(wh),
                "out": os.path.join(d, f"out{fast}_{gi}.npz"),
            }
            r = subprocess.run(
                [sys.executable, child, json.dumps(cfg)],
                capture_output=True, text=True, env=env, timeout=600)
            assert r.returncode == 0, r.stderr[-3000:]
            per_group.append(np.load(cfg["out"]))
        outs[fast] = per_group

    for gi in range(2):
        a, b = outs["0"][gi], outs["1"][gi]
        for key in a.files:
            np.testing.assert_array_equal(
                a[key], b[key],
                err_msg=f"group {gi} output {key} differs between "
                        "MEJ_FAST_COEFS=0 and =1")
    # the engineered non-YCbCr / malformed-DRI streams must be REJECTED
    # under both settings (ok is output index 4; case order above)
    ok_small = outs["1"][0]["4"]
    assert not ok_small[2], "Adobe transform=0 without JFIF accepted"
    assert not ok_small[5], "malformed DRI accepted"
    assert ok_small[0] and ok_small[1] and ok_small[3] and ok_small[4]


def test_coef_feed_readings_match_pixel_path(fixture_camera):
    """One jitted dispatch from DCT coefficients to readings must agree
    with the pixel-crop path on values AND error codes — including the
    fallback scatter for a frame the coefficient reader rejects (a 4:4:4
    re-encode of the first frame)."""
    from PIL import Image

    from meterelf_jax.pipeline.decode import (MeterDecoder,
                                              make_coef_decode_fn)

    _name, camera_dir, params = fixture_camera
    files = _fixture_files(camera_dir)[:16]
    datas = [open(f, "rb").read() for f in files]
    buf = _io.BytesIO()
    Image.open(files[0]).save(buf, "JPEG", quality=95, subsampling=0)
    datas.append(buf.getvalue())
    dec = MeterDecoder(params)
    step, win = make_coef_decode_fn(dec, FRAME_WH)

    cy, cb, cr, qt, load_ok, fbp, fbi = jio.load_coef_feed(
        datas, params.meter_rect, FRAME_WH)
    assert list(fbi[fbi < len(datas)]) == [len(datas) - 1]
    res_cf = jax.tree.map(
        np.asarray, step(dec.param_arrays, cy, cb, cr, qt,
                         load_ok, fbp, fbi))

    rect = params.meter_rect
    crops_px, ok_px = jio.load_packed_crops_from_bytes(
        datas, rect)
    res_px = dec.decode_numpy(crops_px, ok_px)

    np.testing.assert_array_equal(load_ok, ok_px)
    np.testing.assert_array_equal(res_cf.err, res_px.err)
    np.testing.assert_array_equal(res_cf.value, res_px.value)
    np.testing.assert_array_equal(res_cf.dial_pos, res_px.dial_pos)


def test_compact_wire_roundtrip_and_range():
    """The compact 12-bit coefficient wire (lo8 + row-pair hi nibbles)
    must reconstruct every corpus plane bit-exactly, cover the full
    legal range at the format level, and the host packer must route
    out-of-range values to the fallback (ok=False)."""
    import jax.numpy as jnp
    from meterelf_jax.ops import jpegdec

    files = _fixture_files(DEFAULT_DIR)[:12]
    datas = [open(f, "rb").read() for f in files]
    win = jpegdec.coef_window(RECT1, *FRAME_WH)
    dy, db, dr, qt1, ok1 = jio.read_coefs_batch(
        datas, win, FRAME_WH, num_threads=2, plane_layout=True)
    dy, db, dr = dy.copy(), db.copy(), dr.copy()
    cy, cb, cr, qt2, ok2 = jio.read_coefs_batch(
        datas, win, FRAME_WH, num_threads=2, plane_layout=True,
        compact=True)
    assert cy.dtype == np.int8
    np.testing.assert_array_equal(ok1, ok2)
    for dense, cmp_ in ((dy, cy), (db, cb), (dr, cr)):
        got = np.asarray(jpegdec.uncompact_plane(jnp.asarray(cmp_)))
        np.testing.assert_array_equal(got[ok1], dense[ok1])
    # format-level range check: +-2047 survives the numpy emulation of
    # the C packer exactly (sign-extend-12(hi << 8 | lo))
    v = np.arange(-2047, 2048, dtype=np.int16)
    lo = (v & 255).astype(np.int8).astype(np.int32) & 255
    hi = ((v.astype(np.int32) >> 8) & 15)
    rec = (((hi << 8) | lo) << 20) >> 20
    np.testing.assert_array_equal(rec, v.astype(np.int32))


def test_coef_window_geometry():
    win = jpegdec.coef_window(RECT1, 480, 640)  # a portrait 480x640 frame
    # margin >= 2 px (1 chroma sample) on every interior side
    assert 16 * (win.lbx0 // 2) <= 50 - 2
    assert 8 * (win.lbx0 + win.lbw) >= 300 + 2
    assert win.ox == 50 - 8 * win.lbx0 and win.rw == 250
    # window stays inside the chroma block grid
    assert win.lbx0 % 2 == 0 and win.lbw % 2 == 0
    assert 8 * (win.lbx0 + win.lbw) <= 16 * ((480 + 15) // 16)

def test_matrix_idct_matches_butterfly():
    """idct_to_plane's dot_general formulation is bit-identical to the
    ISLOW butterfly (idct_blocks) — including i32-wraparound magnitudes
    far beyond any valid JPEG, since both evaluate the same linear map
    in the mod-2^32 ring (jidctint.c's own overflow semantics)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    B, bh, bw = 2, 3, 5
    for hi in (2048, 32768):
        coef = rng.integers(-hi, hi, (B, bh * bw, 64)).astype(np.int16)
        qt = rng.integers(1, 256, (B, 64)).astype(np.int32)
        ref = jpegdec._blocks_to_plane(
            jpegdec.idct_blocks(jnp.asarray(coef), jnp.asarray(qt)),
            bh, bw)
        got = jpegdec.idct_to_plane(
            jnp.asarray(coef), jnp.asarray(qt), bh, bw)
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(got))
