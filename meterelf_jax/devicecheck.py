"""Checks that the decode graph computes on an accelerator what it
computes on the CPU.

chip_smoke.py runs these on the GPU; tests/test_gpu.py wraps the same
functions under the ``gpu`` marker. Each takes the device under test and
the reference device explicitly, runs in the calling process and raises
AssertionError on a mismatch.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np

# dial positions and values of two backends may differ by f64 summation
# order in the angle statistics (docs/parity.md)
POSITION_TOL = 5e-6
# TM_CCOEFF scores of two backends differ by the order of the f32
# accumulation only (the u8 products are exact, even in TF32)
SCORE_REL_TOL = 1e-5


def on_device(device: Any, fn: Callable, *args: Any) -> Any:
    """Run jax.jit(fn) on ``device`` with numpy args; numpy results."""
    import jax

    args = jax.device_put(args, device)
    return jax.tree.map(np.asarray, jax.jit(fn)(*args))


def check_hls_exhaustive(device: Any) -> int:
    """ops.color BGR -> HLS_FULL over all 2^24 BGR inputs on ``device``
    must equal the host twin api._host_hls exactly. Returns the number
    of inputs checked."""
    from .api import _host_hls
    from .ops import color as color_ops

    v = np.arange(1 << 24, dtype=np.uint32)
    bgr = np.stack([v & 255, (v >> 8) & 255, (v >> 16) & 255],
                   -1).astype(np.uint8).reshape(4096, 4096, 3)
    got = on_device(device, lambda x: color_ops.bgr_to_hls_full(x, 128), bgr)
    want = _host_hls(bgr, 128)
    bad = (got != want).reshape(-1, 3).sum(0)
    assert not bad.any(), f"HLS mismatches per channel (h, l, s): {bad}"
    return int(v.size)


def check_template_match(device: Any, ref_device: Any,
                         batch: int = 64) -> dict:
    """template.match_template_scores_matmul at ``batch`` on both
    synthetic camera geometries: argmax x/y equal to ``ref_device``'s,
    scores within SCORE_REL_TOL of the peak. Returns the largest
    relative difference per camera."""
    from . import synthetic
    from .ops import color as color_ops
    from .ops import template as template_ops

    out = {}
    for name, camera in (("default", synthetic.DEFAULT_CAMERA),
                         ("alt", synthetic.ALT_CAMERA)):
        rng = np.random.default_rng(0)
        crops = camera.render_crops(rng.uniform(0, 10, (batch, 4)).tolist())
        T = camera.make_template()
        tmean = np.float32(np.float32(T.astype(np.int64).sum())
                           / np.float32(T.size))

        def scores(c, t):
            L = color_ops.lightness_channel(c).astype(np.float32)
            s = template_ops.match_template_scores_matmul(L, t, tmean)
            return s, template_ops.locate(s)

        got, (_, gx, gy) = on_device(device, scores, crops, T)
        want, (_, wx, wy) = on_device(ref_device, scores, crops, T)
        np.testing.assert_array_equal(gx, wx, err_msg=f"{name}: argmax x")
        np.testing.assert_array_equal(gy, wy, err_msg=f"{name}: argmax y")
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel <= SCORE_REL_TOL, f"{name}: scores differ by {rel}"
        out[name] = rel
    return out


def compare_results(got: Any, want: Any, label: str) -> None:
    """Two BatchResults of the same frames: error codes, match location,
    readability and the error details equal; dial positions (where
    readable) and values (where OK) within POSITION_TOL."""
    from .errors import ErrCode

    for field in ("err", "match_x", "match_y", "readable"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field),
                                      err_msg=f"{label}: {field}")
    da = want.err == int(ErrCode.DIAL_ANGLE)
    np.testing.assert_array_equal(got.unreadable_bits[da],
                                  want.unreadable_bits[da],
                                  err_msg=f"{label}: unreadable_bits")
    nc = want.err == int(ErrCode.NEEDLE_CONTOURS)
    np.testing.assert_array_equal(got.first_bad_dial[nc],
                                  want.first_bad_dial[nc],
                                  err_msg=f"{label}: first_bad_dial")
    rd = want.readable
    np.testing.assert_allclose(got.dial_pos[rd], want.dial_pos[rd],
                               rtol=0, atol=POSITION_TOL,
                               err_msg=f"{label}: dial_pos")
    ok = want.err == int(ErrCode.OK)
    np.testing.assert_allclose(got.value[ok], want.value[ok], rtol=0,
                               atol=POSITION_TOL,
                               err_msg=f"{label}: value")


def decode_on(device: Any, decoder: Any, crops: np.ndarray,
              load_ok: Optional[np.ndarray] = None,
              caps: Optional[tuple] = None) -> Any:
    """decoder's graph on ``device`` (with the rescue caps when given),
    without the host-side rescue re-run; numpy BatchResult."""
    import functools

    from .pipeline.decode import _decode_batch

    if load_ok is None:
        load_ok = np.ones(crops.shape[0], bool)
    fn = functools.partial(_decode_batch, ccl_caps=caps,
                           **decoder._static_kwargs)
    return on_device(device, fn, decoder.param_arrays, crops, load_ok)
