"""Headless debug visualization: annotated overlay PNGs.

The reference's DEBUG mode pops cv2.imshow windows with contour/momentum
overlays (meterelf/_reading.py:43-78) and per-dial mask windows
(meterelf/_dial_data.py:50-54); in a batch/server context those become
files. `render_overlay` re-derives the per-dial masks for one frame on
the host (numpy twins of the device ops) and writes an upscaled
annotated PNG; `render_masks` writes the precomputed dial masks (the
``masks`` DEBUG mode). Both are wired into the CLI via the ``DEBUG``
env var (see cli.py).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .api import _host_hls
from .io import jpeg as jio
from .params import DIAL_WIN, Params


def _pool3(a: np.ndarray, fn, pad_value) -> np.ndarray:
    from numpy.lib.stride_tricks import sliding_window_view

    p = np.pad(a, 1, constant_values=pad_value)
    return fn(sliding_window_view(p, (3, 3)), axis=(2, 3))


def _np_match(L: np.ndarray, template_u8: np.ndarray):
    from numpy.lib.stride_tricks import sliding_window_view

    t = template_u8.astype(np.float64)
    tz = t - t.mean()
    win = sliding_window_view(L.astype(np.float64), t.shape)
    scores = np.tensordot(win, tz, axes=([2, 3], [0, 1]))
    i = int(np.argmax(scores))
    y, x = divmod(i, scores.shape[1])
    return scores[y, x], x, y


def render_overlay(
    filename: str,
    params: Params,
    out_dir: str,
    scale: int = 4,
) -> Optional[str]:
    from PIL import Image

    pa = params.arrays()
    img = jio.decode_file(filename)
    if img is None:
        return None
    crop = jio.crop_rect(img, params.meter_rect)
    if crop.shape[:2] != (params.meter_rect.height, params.meter_rect.width):
        return None
    hls = _host_hls(crop, params.hue_shift).astype(np.int32)
    _mv, mx, my = _np_match(hls[:, :, 1].astype(np.uint8), pa.template_u8)
    th, tw = pa.template_u8.shape
    dials = hls[my:my + th, mx:mx + tw]

    # true-color backdrop: invert HLS back to BGR (ops/color.py inverse,
    # reference meterelf/_utils.py:105-110), then flip to RGB for PNG
    from .ops.color import hls_full_to_bgr

    bgr = np.asarray(hls_full_to_bgr(dials, params.hue_shift))
    canvas = np.ascontiguousarray(bgr[:, :, ::-1])
    W = DIAL_WIN
    for d in range(pa.mask_full.shape[0]):
        ox, oy = (int(v) for v in pa.win_origin[d])
        win = dials[oy:oy + W, ox:ox + W]
        cx, cy = (int(v) for v in pa.centers_int[d])
        core = win[cy - 2:cy + 3, cx - 2:cx + 3].reshape(-1, 3)
        color = (2 * core.sum(axis=0) + 25) // 50
        lo = np.clip(color - pa.color_range[d], 0, 255)
        hi = np.clip(color + pa.color_range[d], 0, 255)
        raw = ((win >= lo) & (win <= hi)).all(axis=-1)
        closed = _pool3(_pool3(raw, np.max, False), np.min, True)
        masked = closed & pa.mask_full[d]
        tips = closed & pa.mask_circle[d]

        view = canvas[oy:oy + W, ox:ox + W]
        view[raw] = (255, 160, 40)
        view[masked] = (220, 40, 40)
        view[tips] = (255, 40, 255)
        view[cy, cx] = (40, 255, 255)

    big = np.kron(canvas, np.ones((scale, scale, 1), np.uint8))
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(
        out_dir, os.path.basename(filename).rsplit(".", 1)[0] + "_debug.png")
    Image.fromarray(big).save(out_path)
    return out_path


def serve_overlays(params: Params, latest_fn: "Callable[[], object]",
                   port: int, scale: int = 4,
                   host: str = "127.0.0.1") -> "object":
    """Live debug viewer: a daemon-thread HTTP server rendering the
    overlay of the CURRENT frame on demand.

    The reference's DEBUG affordance is interactive cv2.imshow windows
    behind an X11 docker wrapper (meterelf/_reading.py:43-78,
    docker-run-with-x11:20-28) — unusable on a headless meter server.
    This is the server-shaped equivalent: `--debug-http PORT` on the
    stream daemon serves an auto-refreshing page at
    http://host:PORT/ whose image is render_overlay() of the most
    recently processed frame. Overlays render lazily per request, so
    an unwatched stream pays nothing.

    latest_fn: zero-arg callable returning the newest INGESTED
    filename (or None) — with a batched stream this can run up to one
    batch ahead of the printed readings (frames are tracked as the
    batcher pulls them, not at dispatch). Returns the
    ThreadingHTTPServer (bound port = server_address[1]; shut down
    with .shutdown()). Binds 127.0.0.1 by default — the overlays show
    live camera content."""
    import html
    import http.server
    import os as _os
    import tempfile
    import threading
    import time as _time

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, *a) -> None:  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path.startswith("/frame.png"):
                fn = latest_fn()
                data = b""
                if fn and _os.path.exists(str(fn)):
                    with tempfile.TemporaryDirectory() as td:
                        p = render_overlay(str(fn), params, td,
                                           scale=scale)
                        if p:
                            with open(p, "rb") as fp:
                                data = fp.read()
                if not data:
                    self._send(404, "text/plain", b"no frame yet")
                    return
                self._send(200, "image/png", data)
                return
            fn = latest_fn()
            name = (html.escape(_os.path.basename(str(fn)))
                    if fn else "(no frame yet)")
            body = (
                "<html><head><meta http-equiv='refresh' content='2'>"
                "<title>meterelf live debug</title></head>"
                "<body style='background:#111;color:#dfe3e8;"
                "font-family:monospace'>"
                f"<div style='margin:8px'>{name}</div>"
                f"<img src='/frame.png?t={_time.time()}' "
                "style='image-rendering:pixelated'>"
                "</body></html>").encode()
            self._send(200, "text/html", body)

    # localhost-only by default: the overlays expose live camera
    # frames; the stream CLI advertises the URL as localhost, so bind
    # exactly that (pass host explicitly to expose deliberately)
    srv = http.server.ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def render_masks(params: Params, out_dir: str, scale: int = 4) -> list:
    """The ``masks`` DEBUG mode: one PNG per dial showing the full needle
    mask (gray) with the tip annulus highlighted (white) — the headless
    analog of the reference's per-dial imshow windows
    (meterelf/_dial_data.py:50-54)."""
    from PIL import Image

    pa = params.arrays()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for d, name in enumerate(params.dial_names):
        full = np.asarray(pa.mask_full[d], bool)
        circle = np.asarray(pa.mask_circle[d], bool)
        img = np.zeros(full.shape, np.uint8)
        img[full] = 128
        img[circle] = 255
        big = np.kron(img, np.ones((scale, scale), np.uint8))
        out_path = os.path.join(out_dir, f"mask_{name}.png")
        Image.fromarray(big).save(out_path)
        paths.append(out_path)
    return paths
