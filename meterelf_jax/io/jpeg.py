"""Host-side JPEG input pipeline over the native decoder.

Replaces cv2.imread (reference meterelf/_image.py:46-52) with a
libjpeg(-turbo) C decoder (io/native/meterelf_jpeg.c) that is
byte-compatible with the 2019 opencv wheel's decode on the whole sample
corpus (SURVEY.md §8bis). The batch path decodes files concurrently with
pthreads and the Python layer assembles fixed-size meter-rect crops for
the device, so the jitted graph always sees static shapes.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

from .native.build import ensure_built
from ..types import Rect

MAX_W = 4096
MAX_H = 4096

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.mej_decode_file_opts.restype = ctypes.c_int
        lib.mej_decode_file_opts.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_decode_batch.restype = None
        lib.mej_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_decode_region_file.restype = ctypes.c_int
        lib.mej_decode_region_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_decode_region_batch.restype = None
        lib.mej_decode_region_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_decode_region_batch_packed.restype = None
        lib.mej_decode_region_batch_packed.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_decode_region_batch_u8.restype = None
        lib.mej_decode_region_batch_u8.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.mej_read_coefs_region_file.restype = ctypes.c_int
        lib.mej_read_coefs_region_file.argtypes = [
            ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.mej_jpeg_lib_version.restype = ctypes.c_int
        lib.mej_jpeg_lib_version.argtypes = []
        lib.mej_read_coefs_region_batch.restype = None
        lib.mej_read_coefs_region_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_ulong),
            ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ]
        lib.mej_read_coefs_region_batch_compact.restype = None
        lib.mej_read_coefs_region_batch_compact.argtypes = (
            lib.mej_read_coefs_region_batch.argtypes + [
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int8),
                ctypes.POINTER(ctypes.c_int8),
            ])
        # selfcheck BEFORE publishing the handle: if it raises, the next
        # _get_lib() re-runs (and re-raises) instead of silently handing
        # out an off-parity decoder
        _decoder_selfcheck(lib)
        _lib = lib
    return _lib


def _decoder_selfcheck(lib) -> None:
    """Assert the system libjpeg still decodes byte-identically to the
    pinned parity target (SURVEY.md §8bis: golden parity rides on the
    ISLOW + fancy-upsampling byte behavior). Runs once at library load
    on an embedded 2 KB fixture; skip with METERELF_SKIP_DECODER_CHECK=1
    (e.g. to run knowingly off-parity on an exotic libjpeg)."""
    import hashlib
    import os

    if os.environ.get("METERELF_SKIP_DECODER_CHECK") == "1":
        return
    from ._selfcheck_data import CHECK_BGR_SHA256, CHECK_JPEG

    bgr = _decode_bytes_full(CHECK_JPEG, lib=lib)
    got = (hashlib.sha256(bgr.tobytes()).hexdigest()
           if bgr is not None else "<decode failed>")
    if got != CHECK_BGR_SHA256:
        ver = lib.mej_jpeg_lib_version()
        raise RuntimeError(
            "system libjpeg decode diverges from the pinned parity "
            f"target (fixture sha256 {got} != {CHECK_BGR_SHA256}; "
            f"JPEG_LIB_VERSION={ver}). Golden reading parity is NOT "
            "guaranteed on this libjpeg build — install libjpeg-turbo "
            "with stock ISLOW/fancy-upsampling behavior, or set "
            "METERELF_SKIP_DECODER_CHECK=1 to proceed off-parity.")


def decode_file(path: str, max_w: int = MAX_W, max_h: int = MAX_H
                ) -> Optional[np.ndarray]:
    """Decode one JPEG to BGR uint8 [h, w, 3]; None on failure.

    Uses libjpeg defaults (ISLOW DCT, fancy upsampling) — the verified
    byte-exact match for the reference goldens."""
    lib = _get_lib()
    buf = np.empty(max_h * max_w * 3, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mej_decode_file_opts(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        max_w, max_h, ctypes.byref(w), ctypes.byref(h), 0, 1, 1)
    if rc != 0:
        return None
    n = h.value * w.value * 3
    return buf[:n].reshape(h.value, w.value, 3).copy()


def decode_region(path: str, rect: Rect) -> Optional[np.ndarray]:
    """Decode ONLY the meter-rect region of one JPEG to BGR uint8
    [rh, rw, 3]; None on failure (caller falls back to decode_file).

    Rides libjpeg-turbo's jpeg_crop_scanline + jpeg_skip_scanlines: IDCT
    and chroma upsampling run only for the iMCU band containing the rect
    (~26% of the full-frame work for the reference geometry), with a
    16-px margin preserving fancy upsampling's neighbor context so the
    region is byte-identical to a full decode (tests/test_io.py proves
    this over the whole corpus)."""
    lib = _get_lib()
    (x0, y0) = rect.top_left
    rh, rw = rect.height, rect.width
    buf = np.empty(rh * rw * 3, np.uint8)
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.mej_decode_region_file(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        x0, y0, rw, rh, ctypes.byref(w), ctypes.byref(h), 0, 1, 1)
    if rc != 0:
        return None
    return buf.reshape(rh, rw, 3)


def crop_rect(img: np.ndarray, rect: Rect) -> np.ndarray:
    (x0, y0) = rect.top_left
    (x1, y1) = rect.bottom_right
    return img[y0:y1, x0:x1]


def load_crops(
    filenames: Sequence[str],
    meter_rect: Rect,
    batch_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode files and assemble [B, ch, cw, 3] u8 crops + load-ok flags.

    B = batch_size (padded with zero slots) or len(filenames). A file that
    fails to decode, or whose decoded frame doesn't cover the meter rect,
    gets load_ok=False (the reference would raise ImageLoadingError for
    the former; undersized frames crash the reference — we degrade
    gracefully)."""
    ch = meter_rect.height
    cw = meter_rect.width
    B = batch_size or len(filenames)
    crops = np.zeros((B, ch, cw, 3), np.uint8)
    ok = np.zeros(B, bool)
    for i, fn in enumerate(filenames):
        c = decode_region(fn, meter_rect)   # 2.4x the full-frame decode
        if c is None:
            # fallback: undersized frames (region outside image) or
            # region-path failures take the full-decode path
            img = decode_file(fn)
            if img is None:
                continue
            c = crop_rect(img, meter_rect)
            if c.shape != (ch, cw, 3):
                continue
        crops[i] = c
        ok[i] = True
    return crops, ok


def load_crops_threaded(
    filenames: Sequence[str],
    meter_rect: Rect,
    batch_size: Optional[int] = None,
    num_threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """Threaded batch decode via the native worker pool (GIL-free),
    decoding only the meter-rect region of each frame (per-file
    full-decode fallback for undersized/odd frames)."""
    lib = _get_lib()
    n = len(filenames)
    B = batch_size or n
    ch, cw = meter_rect.height, meter_rect.width
    (x0, y0) = meter_rect.top_left
    crops = np.zeros((B, ch, cw, 3), np.uint8)
    ok_out = np.zeros(B, bool)

    datas = []
    for fn in filenames:
        try:
            with open(fn, "rb") as fp:
                datas.append(fp.read())
        except OSError:
            datas.append(b"")

    out = np.zeros(n * ch * cw * 3, np.uint8)
    ok = np.zeros(n, np.int32)
    arr_ptrs = (ctypes.c_char_p * n)(*datas)
    arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    lib.mej_decode_region_batch(
        arr_ptrs, arr_sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        x0, y0, cw, ch,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        0, 1, 1, num_threads)
    stride = ch * cw * 3
    for i in range(n):
        if not datas[i]:
            continue
        if ok[i] == 0:
            crops[i] = out[i * stride:(i + 1) * stride].reshape(ch, cw, 3)
            ok_out[i] = True
            continue
        img = decode_file(filenames[i])   # fallback
        if img is None:
            continue
        c = crop_rect(img, meter_rect)
        if c.shape == (ch, cw, 3):
            crops[i] = c
            ok_out[i] = True
    return crops, ok_out


def load_packed_crops_from_bytes(
    datas: Sequence[bytes],
    meter_rect: Rect,
    num_threads: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode in-memory JPEGs straight to the graph's staging layout:
    [B, rh, rw] i32 packed BGR (b | g<<8 | r<<16) of the meter rect —
    decode, crop, AND pack happen in one C pass (pthreads, GIL-free),
    the whole end-to-end host stage.

    Returns (packed, load_ok). Failures (corrupt/undersized frames) take
    the per-file full-decode fallback; files that still fail get
    load_ok=False."""
    lib = _get_lib()
    n = len(datas)
    ch, cw = meter_rect.height, meter_rect.width
    (x0, y0) = meter_rect.top_left
    out = np.zeros((n, ch, cw), np.int32)
    ok = np.zeros(n, np.int32)
    arr_ptrs = (ctypes.c_char_p * n)(*datas)
    arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    lib.mej_decode_region_batch_packed(
        arr_ptrs, arr_sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cw, ch,
        x0, y0, cw, ch,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        0, 1, num_threads)
    ok_out = ok == 0
    for i in np.nonzero(~ok_out)[0]:
        if not datas[i]:
            continue
        img = _decode_bytes_full(bytes(datas[i]))
        if img is None:
            continue
        c = crop_rect(img, meter_rect)
        if c.shape == (ch, cw, 3):
            out[i] = pack_crops(c[None])[0]
            ok_out[i] = True
    return out, ok_out


def load_crop_bytes_u8(
    datas: Sequence[bytes],
    meter_rect: Rect,
    num_threads: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode in-memory JPEGs to raw u8 BGR crops: [N, rh, rw, 3].

    The minimal-byte representation of the meter region — the right
    feed when crops are shipped over a bandwidth-limited host->device
    link: 3 bytes/px vs the staging layout's 4, with packing done on
    the accelerator
    (pipeline.decode.pack_crops_device). Region decode runs straight
    into each output slot in C (pthreads, GIL-free).

    Returns (crops, load_ok). Failures (corrupt/undersized frames) take
    the per-file full-decode fallback; files that still fail get
    load_ok=False and an all-zero slot."""
    lib = _get_lib()
    n = len(datas)
    ch, cw = meter_rect.height, meter_rect.width
    (x0, y0) = meter_rect.top_left
    out = np.zeros((n, ch, cw, 3), np.uint8)
    ok = np.zeros(n, np.int32)
    arr_ptrs = (ctypes.c_char_p * n)(*datas)
    arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    lib.mej_decode_region_batch_u8(
        arr_ptrs, arr_sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        x0, y0, cw, ch,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        0, 1, num_threads)
    ok_out = ok == 0
    for i in np.nonzero(~ok_out)[0]:
        out[i] = 0  # a failed region decode may have written partial rows
        if not datas[i]:
            continue
        img = _decode_bytes_full(bytes(datas[i]))
        if img is None:
            continue
        c = crop_rect(img, meter_rect)
        if c.shape == (ch, cw, 3):
            out[i] = c
            ok_out[i] = True
    return out, ok_out


import threading as _threading

_ARENA = _threading.local()
_ARENA_ON = os.environ.get("METERELF_FEED_ARENA", "1") != "0"


def _arena(key: Tuple[str, tuple], dtype) -> np.ndarray:
    """Reused output buffer for the coefficient feed (double-buffered).

    Fresh np.zeros per batch costs ~45 us/frame in first-touch page
    faults at the feed's array sizes (~400 KB/frame) — measured +10%
    on the host entropy rate when the buffers persist. Two slots
    rotate per (name, shape) PER THREAD (threading.local — concurrent
    callers never share a buffer), honoring the feed CONTRACT that a
    caller holds at most ONE prior batch's arrays (the async
    device_put of the previous chunk) when it requests the next: a
    result held across two subsequent same-thread calls is silently
    overwritten — .copy() it or set METERELF_FEED_ARENA=0 for fresh
    allocations. Contents are NOT zeroed — the decoder writes every
    window block of every ok frame, and read_coefs_batch explicitly
    zeroes failed frames' slots."""
    name, shape = key
    if not _ARENA_ON:
        return np.zeros(shape, dtype)
    store = getattr(_ARENA, "slots", None)
    if store is None:
        store = _ARENA.slots = {}
    slot = store.get(name)
    if slot is None or slot[0][0].shape != tuple(shape):
        slot = ([np.zeros(shape, dtype), np.zeros(shape, dtype)], [0])
        store[name] = slot
    bufs, idx = slot
    idx[0] ^= 1
    return bufs[idx[0]]


def read_coefs_batch(
    datas: Sequence[bytes],
    win: "CoefWindow",         # ops.jpegdec.CoefWindow (host pytree)
    frame_wh: Tuple[int, int],
    num_threads: int = 2,
    plane_layout: bool = False,
    compact: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Entropy-decode only (pthreads, GIL-free): ship the block-aligned
    DCT-coefficient window for the device back-half
    (ops/jpegdec.backhalf_to_packed) to finish.

    Returns (coef_y [N, lbh*lbw, 64] i16, coef_cb, coef_cr
    [N, (lbh//2)*(lbw//2), 64] i16, qt [N, 3, 64] u16, ok [N] bool).
    With plane_layout=True the coefficient arrays come back in the
    FREQUENCY-PLANE layout instead — coef_y [N, lbh*8, lbw*8] with
    coefficient (rf, cf) of block (by, bx) at [8*by+rf, 8*bx+cf] (and
    chroma [N, lbh*4, lbw*4]) — ops/jpegdec.backhalf_planes_to_packed
    takes it.
    ok=False rows (corrupt header, non-4:2:0/progressive layout,
    unexpected frame size) keep zeroed slots — the caller decodes those
    few on the host pixel path instead.

    compact=True (plane layout only): the planes additionally ship in
    the COMPACT WIRE FORMAT — per plane one int8 array of the lo bytes
    (v & 0xFF) followed by row-pair-packed hi nibbles, 12 bits/coef
    total (~25% fewer H2D bytes than dense i16; exact for the whole
    legal baseline coefficient range, ops/jpegdec.uncompact_plane).
    The i16 arrays then serve as decode scratch only and the returned
    coef arrays are the int8 compact ones. Reference analog: the
    imread byte source this feed replaces, meterelf/_image.py:49."""
    lib = _get_lib()
    n = len(datas)
    nby = win.lbh * win.lbw
    if plane_layout:
        yshape = (n, win.lbh * 8, win.lbw * 8)
        cshape = (n, win.lbh * 4, win.lbw * 4)
    else:
        yshape = (n, nby, 64)
        cshape = (n, nby // 4, 64)
    assert not compact or plane_layout, "compact wire is plane-only"
    coef_y = _arena(("cy", yshape), np.int16)
    coef_cb = _arena(("cb", cshape), np.int16)
    coef_cr = _arena(("cr", cshape), np.int16)
    qt = _arena(("qt", (n, 3, 64)), np.uint16)
    ok = np.zeros(n, np.int32)
    arr_ptrs = (ctypes.c_char_p * n)(*datas)
    arr_sizes = (ctypes.c_ulong * n)(*[len(d) for d in datas])
    if compact:
        cmp_y = _arena(
            ("cmy", (n, yshape[1] * 3 // 2, yshape[2])), np.int8)
        cmp_cb = _arena(
            ("cmb", (n, cshape[1] * 3 // 2, cshape[2])), np.int8)
        cmp_cr = _arena(
            ("cmr", (n, cshape[1] * 3 // 2, cshape[2])), np.int8)
        lib.mej_read_coefs_region_batch_compact(
            arr_ptrs, arr_sizes, n,
            win.lbx0, win.lby0, win.lbw, win.lbh,
            frame_wh[0], frame_wh[1], 1,
            coef_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            coef_cb.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            coef_cr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads,
            cmp_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cmp_cb.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            cmp_cr.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
        coef_y, coef_cb, coef_cr = cmp_y, cmp_cb, cmp_cr
    else:
        lib.mej_read_coefs_region_batch(
            arr_ptrs, arr_sizes, n,
            win.lbx0, win.lby0, win.lbw, win.lbh,
            frame_wh[0], frame_wh[1], int(plane_layout),
            coef_y.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            coef_cb.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            coef_cr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            qt.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), num_threads)
    for i in np.nonzero(ok != 0)[0]:
        # failed frames keep DETERMINISTIC zeroed slots (the reused
        # arena buffers would otherwise leak the previous batch's
        # coefficients into rows the fallback path later overrides)
        coef_y[i] = 0
        coef_cb[i] = 0
        coef_cr[i] = 0
        qt[i] = 0
    return coef_y, coef_cb, coef_cr, qt, ok == 0


def load_coef_feed(
    datas: Sequence[bytes],
    meter_rect: Rect,
    frame_wh: Tuple[int, int],
    fb_slots: int = 8,
    num_threads: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray, np.ndarray]:
    """The production host feed: entropy-decode every frame's DCT
    window (read_coefs_batch, block layout) and pixel-decode the
    stragglers into a bounded set of fallback slots, for one jitted
    dispatch of pipeline.decode.make_coef_decode_fn.

    Frames the coefficient reader rejects (corrupt, progressive/4:4:4,
    unexpected size) are decoded on the host pixel path into up to
    ``fb_slots`` packed [rh, rw] i32 crops that the device scatters
    over the back-half output; unused slots carry index len(datas)
    (dropped by the scatter). Rows failing both paths — or overflowing
    the fallback budget (a misconfigured camera, not a decode-path
    case) — get load_ok=False and decode to the load-error code.

    Returns (coef_y, coef_cb, coef_cr, qt, load_ok, fb_packed, fb_idx).
    """
    from ..ops import jpegdec

    win = jpegdec.coef_window(meter_rect, frame_wh[0], frame_wh[1])
    return load_coef_feed_shard(
        datas, tuple(win), meter_rect, frame_wh,
        fb_slots=fb_slots, num_threads=num_threads)


def load_coef_feed_shard(
    datas: Sequence[bytes],
    win_tuple: Tuple[int, ...],
    meter_rect: Rect,
    frame_wh: Tuple[int, int],
    fb_slots: int = 8,
    num_threads: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray, np.ndarray]:
    """load_coef_feed with the window geometry precomputed by the
    caller — a jax-free entry point (no ops import, no backend init)
    for entropy-feed worker subprocesses (stream.py --feed-workers /
    FeedWorkerPool). win_tuple is the CoefWindow as a plain tuple
    (picklable across spawn)."""
    from ..ops.jpegdec import CoefWindow as _CW  # NamedTuple only: no jax

    win = _CW(*win_tuple)
    cy, cb, cr, qt, ok = read_coefs_batch(
        datas, win, frame_wh, num_threads=num_threads)
    load_ok = ok.copy()
    fb_idx = np.full(fb_slots, len(datas), np.int32)
    fb_packed = np.zeros((fb_slots, meter_rect.height, meter_rect.width),
                         np.int32)
    bad = np.nonzero(~ok)[0][:fb_slots]
    if len(bad):
        pk, pok = load_packed_crops_from_bytes(
            [datas[i] for i in bad], meter_rect, num_threads=num_threads)
        for j, i in enumerate(bad):
            if pok[j]:
                fb_idx[j] = i
                fb_packed[j] = pk[j]
                load_ok[i] = True
    return cy, cb, cr, qt, load_ok, fb_packed, fb_idx


def _decode_bytes_full(data: bytes, lib=None) -> Optional[np.ndarray]:
    """Full-frame decode of in-memory JPEG bytes (fallback path)."""
    lib = lib if lib is not None else _get_lib()
    out = np.zeros(MAX_H * MAX_W * 3, np.uint8)
    ok = np.zeros(1, np.int32)
    widths = np.zeros(1, np.int32)
    heights = np.zeros(1, np.int32)
    arr_ptrs = (ctypes.c_char_p * 1)(data)
    arr_sizes = (ctypes.c_ulong * 1)(len(data))
    lib.mej_decode_batch(
        arr_ptrs, arr_sizes, 1,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), MAX_W, MAX_H,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        widths.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        heights.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        0, 1, 1, 1)
    if ok[0] != 0:
        return None
    w, h = int(widths[0]), int(heights[0])
    return out[:h * w * 3].reshape(h, w, 3)


def pack_crops(crops_u8: np.ndarray) -> np.ndarray:
    """[B, H, W, 3] u8 BGR -> [B, H, W] i32 packed (b | g<<8 | r<<16).

    The decode graph's canonical pixel format: one 32-bit word per pixel
    keeps the minor dimension an image axis. Packing on the host is
    ~free next to JPEG decode."""
    c = crops_u8.astype(np.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)
