"""Write the committed synthetic JPEG corpus under tests/data/synthetic/.

For each shipped synthetic camera geometry (synthetic.DEFAULT_CAMERA and
ALT_CAMERA) this renders 48 full 640x480 frames with known dial
positions, encodes them as baseline 4:2:0 JPEG (quality 95) and writes:

- ``params.yml`` and the dial template PNG;
- ``<timestamp>-<index>.jpg`` frames: mostly clean readings, plus a
  needle stub (an unreadable dial), a frame without the meter (dials not
  found), speckle noise, and two truncated files (the share of corrupt
  frames in the reference corpus);
- ``truth.json``: each frame's rendered dial positions and kind;
- ``expected_stdout.txt``: the CLI's output for all frames, run here on
  the CPU with the frame basenames as arguments (cwd = the camera dir).

Pillow and PyYAML encode the files; the system reads them back with its
own readers. Run once after changing the renderer:
``python tools/make_fixtures.py`` (writes into the checkout).
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data", "synthetic")
N_FRAMES = 48
TRUNCATED = {23: 0.55, 41: 0.8}     # frame index -> kept share of bytes
STUB, BLANK, SPECKLE = 5, 11, (17, 35)


def _frames(camera, seed):
    rng = np.random.default_rng(seed)
    (x0, y0), (x1, y1) = camera.meter_rect
    max_ox = (x1 - x0) - camera.template_w - 1
    max_oy = (y1 - y0) - camera.template_h - 1
    for i in range(N_FRAMES):
        pos = [round(float(p), 3) for p in rng.uniform(0, 10, 4)]
        off = (int(rng.integers(2, max_ox)), int(rng.integers(2, max_oy)))
        kind = "reading"
        if i == STUB:
            kind = "stub"
            frame = camera.render_frame(pos, offset=off, stub_dials=(2,))
        elif i == BLANK:
            kind = "blank"
            frame = np.full((camera.frame_h, camera.frame_w, 3), 180,
                            np.uint8)
        else:
            frame = camera.render_frame(pos, offset=off)
            if i in SPECKLE:
                kind = "speckle"
                m = rng.random(frame.shape[:2]) < 0.002
                frame[m] = (40, 40, 200)
        if i in TRUNCATED:
            kind = "truncated"
        yield i, pos, off, kind, frame


def _encode(frame_bgr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame_bgr[..., ::-1]), "RGB").save(
        buf, "JPEG", quality=95, subsampling=2)
    return buf.getvalue()


def write_camera(name, camera, seed) -> None:
    import yaml
    from PIL import Image

    from meterelf_jax import cli

    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(d):
        os.remove(os.path.join(d, f))
    tpath = os.path.join(d, "synthetic_template.png")
    Image.fromarray(camera.make_template(), mode="L").save(tpath)
    with open(os.path.join(d, "params.yml"), "w") as fp:
        fp.write("# synthetic camera '%s' (tools/make_fixtures.py)\n" % name)
        yaml.safe_dump(camera.params_dict(tpath), fp, sort_keys=False,
                       default_flow_style=None)
    truth = {}
    for i, pos, off, kind, frame in _frames(camera, seed):
        fn = f"20260101{(i * 2) // 3600:02d}{(i * 2) // 60 % 60:02d}" \
             f"{(i * 2) % 60:02d}-{i:02d}.jpg"
        data = _encode(frame)
        if i in TRUNCATED:
            data = data[:int(len(data) * TRUNCATED[i])]
        with open(os.path.join(d, fn), "wb") as fp:
            fp.write(data)
        truth[fn] = {"positions": pos, "offset": list(off), "kind": kind}
    with open(os.path.join(d, "truth.json"), "w") as fp:
        json.dump(truth, fp, indent=1, sort_keys=True)
    cwd = os.getcwd()
    out = io.StringIO()
    try:
        os.chdir(d)
        with contextlib.redirect_stdout(out):
            cli.main(["meterelf", "params.yml"] + sorted(truth))
    finally:
        os.chdir(cwd)
    with open(os.path.join(d, "expected_stdout.txt"), "w") as fp:
        fp.write(out.getvalue())


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    from meterelf_jax import synthetic

    write_camera("default", synthetic.DEFAULT_CAMERA, seed=101)
    write_camera("alt", synthetic.ALT_CAMERA, seed=202)


if __name__ == "__main__":
    main()
