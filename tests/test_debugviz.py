"""Debug/observability surface: overlay + mask PNG rendering, the CLI
DEBUG wiring, the HLS->BGR inverse conversion, and the stage timers."""
import colorsys
import os
from glob import glob

import numpy as np
import pytest

SAMPLE1 = "/root/reference/sample-images1"


@pytest.mark.needs_samples
def test_render_masks(params1, tmp_path):
    from meterelf_jax.debugviz import render_masks

    paths = render_masks(params1, str(tmp_path))
    assert len(paths) == 4
    from PIL import Image

    for p in paths:
        assert os.path.exists(p)
        a = np.asarray(Image.open(p))
        # full mask (128) and tip annulus (255) both present
        assert (a == 128).any() and (a == 255).any()


@pytest.mark.needs_samples
def test_render_overlay(params1, tmp_path):
    from meterelf_jax.debugviz import render_overlay

    fn = sorted(glob(f"{SAMPLE1}/2018*.jpg"))[2]
    out = render_overlay(fn, params1, str(tmp_path), scale=2)
    assert out is not None and os.path.exists(out)
    from PIL import Image

    a = np.asarray(Image.open(out))
    th, tw = params1.arrays().template_u8.shape
    assert a.shape == (th * 2, tw * 2, 3)
    # overlays painted: needle-mask red and tip magenta pixels exist
    assert (a == (220, 40, 40)).all(axis=-1).any()
    assert (a == (255, 40, 255)).all(axis=-1).any()


@pytest.mark.needs_samples
def test_cli_debug_mode_writes_overlays(monkeypatch, tmp_path, capsys):
    """DEBUG mode: dict suffix on stdout + overlay/mask PNGs on disk
    (headless analog of reference _reading.py:43-78, _dial_data.py:50-54)."""
    from meterelf_jax import cli, debugging

    monkeypatch.setattr(debugging, "DEBUG", {"masks"})
    monkeypatch.setenv("METERELF_DEBUG_DIR", str(tmp_path))
    fn = sorted(glob(f"{SAMPLE1}/2018*.jpg"))[2]
    cli.main(["meterelf", f"{SAMPLE1}/params.yml", fn])
    out = capsys.readouterr().out
    assert "'value':" in out  # debug dict suffix
    pngs = sorted(os.listdir(tmp_path))
    assert any(p.startswith("mask_") for p in pngs)
    assert any(p.endswith("_debug.png") for p in pngs)


def test_hls_full_to_bgr_matches_standard_formula():
    """The inverse conversion agrees with the standard HLS->RGB formula
    (colorsys) within 1 LSB, and is exact on gray (s == 0)."""
    from meterelf_jax.ops.color import hls_full_to_bgr

    rng = np.random.default_rng(7)
    hls = rng.integers(0, 256, size=(257, 3), dtype=np.int32)
    hls[-1] = (123, 200, 0)  # gray case
    out = np.asarray(hls_full_to_bgr(hls, 0))
    for (h, l, s), (b, g, r) in zip(hls, out):
        er, eg, eb = colorsys.hls_to_rgb(h / 256.0, l / 255.0, s / 255.0)
        assert abs(int(b) - round(eb * 255)) <= 1
        assert abs(int(g) - round(eg * 255)) <= 1
        assert abs(int(r) - round(er * 255)) <= 1
    assert tuple(out[-1]) == (200, 200, 200)


def test_hls_full_to_bgr_undoes_hue_shift():
    """The hue_shift wrap applied by bgr_to_hls_full is undone exactly."""
    from meterelf_jax.ops.color import bgr_to_hls_full, hls_full_to_bgr

    rng = np.random.default_rng(11)
    bgr = rng.integers(0, 256, size=(64, 3), dtype=np.uint8)
    hls = np.asarray(bgr_to_hls_full(bgr, 128)).astype(np.int32)
    back = np.asarray(hls_full_to_bgr(hls, 128))
    # HLS quantization loses information; round-tripping stays close
    assert np.abs(back.astype(int) - bgr.astype(int)).max() <= 8


def test_stage_timers_report():
    from meterelf_jax.profiling import StageTimers

    tm = StageTimers()
    with tm.stage("alpha"):
        pass
    with tm.stage("alpha"):
        pass
    with tm.stage("beta"):
        pass
    assert tm.counts["alpha"] == 2 and tm.counts["beta"] == 1
    rep = tm.report()
    assert "alpha" in rep and "ms/call" in rep


def test_device_trace_noop():
    from meterelf_jax.profiling import device_trace

    with device_trace(None):
        pass


@pytest.mark.needs_samples
def test_serve_overlays_live_viewer(params1):
    """The live debug HTTP viewer (--debug-http): the index page
    auto-refreshes and /frame.png serves the current frame's overlay;
    with no frame yet, /frame.png 404s gracefully."""
    import urllib.request

    from meterelf_jax.debugviz import serve_overlays

    holder = {"fn": None}
    srv = serve_overlays(params1, lambda: holder["fn"], 0, scale=1)
    port = srv.server_address[1]
    try:
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read()
        assert b"no frame yet" in html
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/frame.png", timeout=10)
        holder["fn"] = sorted(glob(f"{SAMPLE1}/*.jpg"))[2]
        png = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/frame.png", timeout=60).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        html = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/", timeout=10).read()
        assert os.path.basename(holder["fn"]).encode() in html
    finally:
        srv.shutdown()
