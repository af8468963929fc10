"""CLI-level out-of-corpus fuzz: synthetic frames are encoded to REAL
JPEG files and run through both CLIs — the reference's `_main.main`
(executed from /root/reference under the validated compat shims) and
ours — comparing stdout byte-for-byte.

Beyond tests/test_oracle_fuzz.py (which injects BGR arrays into both
decode pipelines), this exercises the full user surface on novel
inputs: JPEG file IO (our native libjpeg decoder vs the reference's
cv2.imread on the same fresh files), batching across the file list,
error-string rendering — including DialsNotFound frames whose printed
`match val = ...` must come from our cv2-DFT replica (ops/cvdft.py)
and match modern cv2's matchTemplate float exactly.
"""
import contextlib
import io
import os

import numpy as np
import pytest

REF = "/root/reference"

cv2 = pytest.importorskip("cv2")
PIL = pytest.importorskip("PIL.Image")
pytestmark = pytest.mark.skipif(
    not os.path.isdir(os.path.join(REF, "meterelf")),
    reason="reference package not mounted")


def _frames(camera, n, seed):
    rng = np.random.default_rng(seed)
    (x0, y0), (x1, y1) = camera.meter_rect
    max_ox = (x1 - x0) - camera.template_w - 1
    max_oy = (y1 - y0) - camera.template_h - 1
    frames = []
    for i in range(n):
        pos = [float(p) for p in rng.uniform(0, 10, 4)]
        off = (int(rng.integers(5, max_ox)), int(rng.integers(5, max_oy)))
        stub = (1,) if i % 6 == 3 else ()
        f = camera.render_frame(pos, offset=off, stub_dials=stub)
        if i % 4 == 2:
            m = rng.random(f.shape[:2]) < 0.002
            f[m] = (40, 40, 200)
        frames.append(f)
    # template-less frames: the DialsNotFound error path, whose printed
    # match val must reproduce cv2's f32-DFT float on OUR side
    frames.append(rng.integers(0, 256, frames[0].shape, np.uint8))
    frames.append(np.zeros_like(frames[0]))  # the "match val = 0.0" case
    return frames


def _capture(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_cli_fuzz_against_reference_cli(tmp_path):
    import yaml

    from meterelf_jax import synthetic
    from meterelf_jax.cli import main as our_main
    from ref_shims import shimmed_reference

    camera = synthetic.DEFAULT_CAMERA
    d = str(tmp_path)
    camera.make_params(d)  # writes the template PNG
    yml = os.path.join(d, "params.yml")
    with open(yml, "w") as fp:
        yaml.safe_dump(
            camera.params_dict(os.path.join(d, "synthetic_template.png")),
            fp)

    files = []
    for i, frame in enumerate(_frames(camera, 18, seed=424242)):
        p = os.path.join(d, f"fuzz{i:03d}.jpg")
        # webcam-like encode: 4:2:0 chroma, mid quality
        PIL.fromarray(frame[..., ::-1]).save(
            p, "JPEG", quality=85, subsampling=2)
        files.append(p)

    ours = _capture(our_main, ["meterelf", yml] + files)

    with shimmed_reference() as ref:
        theirs = _capture(ref["_main"].main, ["meterelf", yml] + files)

    assert ours == theirs, (
        "CLI output diverged from the reference on fuzz JPEGs:\n"
        + "\n".join(f"ours:   {a}\ntheirs: {b}\n"
                    for a, b in zip(ours.splitlines(), theirs.splitlines())
                    if a != b))
