"""End-to-end smoke run of the dial decoder on one NVIDIA GPU.

    python chip_smoke.py             # phases 0-5 on one card
    python chip_smoke.py --mesh 4    # only the 4-card mesh path

Runs in this one process, which holds the card for the whole run, on the
committed synthetic corpus (tests/data/synthetic: two camera geometries,
48 full 640x480 4:2:0 frames each):

0. setup: device, card name and power limit, versions, XLA_FLAGS,
   compile cache, libjpeg version and decoder self-check;
1. numeric primitives on the card against the CPU of this process:
   BGR -> HLS over all 2^24 inputs, template match at B=64;
2. the pixel-feed CLI (cli.main) on both cameras against the committed
   expected_stdout.txt;
3. the coefficient feed: stream.main at batch 256, and make_coef_decode_fn
   on the dense block wire and the compact 12-bit plane wire, whose
   readings must equal phase 2's bit for bit;
4. the batched API at B=384, 32 adversarial frames per camera and the
   rescue graph, against the same graph on the CPU;
5. compile and steady-state times of the graphs above (a record).

Exits non-zero without a GPU or when any phase fails. The last stdout
line is {"ok": true, "device": {...}} and is printed only on success.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "data", "synthetic")
CAMERAS = ("default", "alt")
FRAME_WH = (640, 480)
STREAM_REPEAT = 11          # 48 frames x 11 = 528: two full batches of 256
BATCH_API = 384
TIMINGS: list = []


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them (one
    "name, limit" per card, joined with "; " on a multi-card host)."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError as e:
        return f"nvidia-smi unavailable: {e}"
    return ("; ".join(r.stdout.strip().splitlines())
            or f"nvidia-smi failed: {r.stderr.strip()}")


def timed(name, fn, *args):
    """Run fn twice: the first call compiles, the second is one
    steady-state wall time; both end in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    t1 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    t2 = time.perf_counter()
    TIMINGS.append((name, t1 - t0, t2 - t1))
    return out


def camera(name):
    from meterelf_jax.params import Params

    d = os.path.join(FIXTURES, name)
    with open(os.path.join(d, "truth.json")) as fp:
        frames = sorted(json.load(fp))
    return d, Params.load(os.path.join(d, "params.yml")), frames


def read_frames(d, frames):
    out = []
    for f in frames:
        with open(os.path.join(d, f), "rb") as fp:
            out.append(fp.read())
    return out


def run_cli(fn, argv, cwd):
    """Call a CLI main in-process from ``cwd``; its stdout lines."""
    buf = io.StringIO()
    old = os.getcwd()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf):
            fn(argv)
    finally:
        os.chdir(old)
    return buf.getvalue().splitlines()


def differs_in_last_digit(a: str, b: str) -> bool:
    return (len(a) == len(b) and a[:-1] == b[:-1] and a != b
            and a[-1].isdigit() and b[-1].isdigit())


# ------------------------------------------------------------------ phases

def phase0_setup():
    import jax
    import jaxlib

    from meterelf_jax.compile_cache import setup_compile_cache
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.io.native.build import libjpeg_link_args

    cache = setup_compile_cache()
    lib = jio._get_lib()            # runs the libjpeg decode self-check
    devs = jax.devices()
    log(f"setup: device_kind={devs[0].device_kind} count={len(devs)} "
        f"platform={devs[0].platform} jax={jax.__version__} "
        f"jaxlib={jaxlib.__version__} "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r} "
        f"compile_cache={cache}")
    log(f"setup: libjpeg JPEG_LIB_VERSION={lib.mej_jpeg_lib_version()} "
        f"selfcheck=pass link={' '.join(libjpeg_link_args())}")
    log(f"card: {card_line()}")


def phase1_primitives(gpu, cpu):
    from meterelf_jax import devicecheck

    t0 = time.perf_counter()
    n = devicecheck.check_hls_exhaustive(gpu)
    log(f"phase1: HLS equal to the host twin on all {n} BGR inputs "
        f"({time.perf_counter() - t0:.1f}s)")
    rel = devicecheck.check_template_match(gpu, cpu, batch=64)
    log("phase1: template match B=64 argmax equal to the CPU; max "
        "relative score difference " + " ".join(
            f"{k}={v:.3e}" for k, v in rel.items())
        + f" (bound {devicecheck.SCORE_REL_TOL})")


def phase2_cli(cpu):
    """-> {camera: pixel-feed BatchResult on the GPU} for phase 3."""
    from meterelf_jax import cli, devicecheck
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import MeterDecoder

    results = {}
    for name in CAMERAS:
        d, params, frames = camera(name)
        got = run_cli(cli.main, ["meterelf", "params.yml"] + frames, d)
        with open(os.path.join(d, "expected_stdout.txt")) as fp:
            want = fp.read().splitlines()
        assert len(got) == len(want), (name, len(got), len(want))
        rect = params.meter_rect
        packed, ok = jio.load_packed_crops_from_bytes(
            read_frames(d, frames), rect)
        dec = MeterDecoder(params)
        res = timed(f"pixel decode B={len(frames)} {name}", dec._fn,
                    dec.param_arrays, packed, ok)
        res = dec.rescue_numpy(packed, type(res)(*map(np.asarray, res)), ok)
        results[name] = res
        diffs = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        for i in diffs:
            assert differs_in_last_digit(got[i], want[i]), (
                f"{name}: line {i} differs beyond its last digit:\n"
                f"  got  {got[i]}\n  want {want[i]}")
        if diffs:
            ref = devicecheck.decode_on(cpu, dec, packed, ok)
            for i in diffs:
                log(f"phase2: {name} line {i} differs in its last digit; "
                    f"unrounded positions gpu={res.dial_pos[i].tolist()} "
                    f"cpu={ref.dial_pos[i].tolist()} value "
                    f"gpu={float(res.value[i])!r} "
                    f"cpu={float(ref.value[i])!r}; checked within "
                    f"{devicecheck.POSITION_TOL}")
            sub = np.asarray(diffs)
            devicecheck.compare_results(
                type(res)(*[a[sub] for a in res]),
                type(ref)(*[a[sub] for a in ref]), f"phase2 {name}")
        log(f"phase2: {name} CLI {len(got)} lines, "
            f"{len(got) - len(diffs)} byte-identical to "
            f"expected_stdout.txt, {len(diffs)} within the last digit")
    return results


def phase3_coef(pixel):
    """stream.main on the coefficient feed, then both coefficient wires
    through make_coef_decode_fn against the pixel feed at B=256."""
    from meterelf_jax import stream
    from meterelf_jax.errors import ErrCode
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import MeterDecoder, make_coef_decode_fn

    for name in CAMERAS:
        d, params, frames = camera(name)
        argv = (["params.yml"] + frames
                + ["--coef", f"{FRAME_WH[0]}x{FRAME_WH[1]}", "--batch", "256",
                   "--repeat", str(STREAM_REPEAT)])
        if name == "default":
            argv += ["--feed-workers", "2"]
        lines = run_cli(stream.main, argv, d)
        n_ok = int((pixel[name].err == int(ErrCode.OK)).sum())
        total = len(frames) * STREAM_REPEAT
        assert lines[-1].startswith(
            f"frames={total} ok={n_ok * STREAM_REPEAT} "
            f"err={(len(frames) - n_ok) * STREAM_REPEAT} "), lines[-1]
        log(f"phase3: {name} stream --coef --batch 256 x{STREAM_REPEAT}"
            f"{' --feed-workers 2' if name == 'default' else ''}: "
            f"{lines[-1]}")

        dec = MeterDecoder(params)
        step, win = make_coef_decode_fn(dec, FRAME_WH)
        datas = read_frames(d, frames)
        n = len(datas)
        tile = (datas * (256 // n + 1))[:256]     # starts with all n frames
        rect = params.meter_rect
        px, px_ok = jio.load_packed_crops_from_bytes(
            tile, rect)
        res_px = dec.decode_numpy(px, px_ok)
        feed = jio.load_coef_feed(tile, rect, FRAME_WH)
        res_dense = timed(f"coef step dense B=256 {name}", step,
                          dec.param_arrays, *feed)
        cy, cb, cr, qt, ok = jio.read_coefs_batch(
            tile, win, FRAME_WH, plane_layout=True, compact=True)
        assert ok.all()
        fb_packed = np.zeros((8, rect.height, rect.width), np.int32)
        fb_idx = np.full(8, len(tile), np.int32)
        res_compact = timed(f"coef step compact B=256 {name}", step,
                            dec.param_arrays, cy.copy(), cb.copy(),
                            cr.copy(), qt.copy(), ok, fb_packed, fb_idx)
        for wire, res in (("dense", res_dense), ("compact", res_compact)):
            res = type(res)(*map(np.asarray, res))
            for field in ("err", "dial_pos", "value", "readable",
                          "match_x", "match_y"):
                np.testing.assert_array_equal(
                    getattr(res, field), getattr(res_px, field),
                    err_msg=f"phase3 {name} {wire}: {field}")
        np.testing.assert_array_equal(res_px.err[:n], pixel[name].err)
        log(f"phase3: {name} coefficient feed readings equal to the pixel "
            f"feed bit for bit on the dense block wire and the compact "
            f"12-bit plane wire")


def _pool_probe():
    """Runs inside a FeedWorkerPool child: its JAX platform setting and,
    if it has imported JAX, the platform JAX would hand it."""
    platform = None
    if "jax" in sys.modules:
        platform = sys.modules["jax"].devices()[0].platform
    return os.environ.get("JAX_PLATFORMS"), platform


def phase3_pool_is_cpu_only():
    from meterelf_jax.ops import jpegdec
    from meterelf_jax.stream import FeedWorkerPool

    _d, params, _frames = camera("default")
    rect = params.meter_rect
    win = jpegdec.coef_window(rect, *FRAME_WH)
    pool = FeedWorkerPool(2, rect, FRAME_WH, tuple(win))
    try:
        seen = [pool._pool.apply(_pool_probe) for _ in range(4)]
    finally:
        pool.close()
    assert all(s[0] == "cpu" and s[1] in (None, "cpu") for s in seen), seen
    log(f"phase3: feed-worker children are pinned to the CPU "
        f"(JAX_PLATFORMS, platform) = {seen[0]}")


def phase4_batched(gpu, cpu):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fuzz_frames import fuzz_frames

    from meterelf_jax import devicecheck, synthetic
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.ops import components as comp_ops
    from meterelf_jax.pipeline.decode import MeterDecoder

    for name in CAMERAS:
        d, params, frames = camera(name)
        rect = params.meter_rect
        packed, ok = jio.load_packed_crops_from_bytes(
            read_frames(d, frames), rect)
        reps = -(-BATCH_API // len(frames))
        crops = np.tile(packed, (reps, 1, 1))[:BATCH_API]
        oks = np.tile(ok, reps)[:BATCH_API]
        dec = MeterDecoder(params)
        got = timed(f"decode_numpy B={BATCH_API} {name}",
                    dec.decode_numpy, crops, oks)
        want = devicecheck.decode_on(cpu, dec, crops, oks)
        devicecheck.compare_results(got, want, f"phase4 {name} B=384")

        cam = getattr(synthetic, f"{name.upper()}_CAMERA")
        (x0, y0), (x1, y1) = cam.meter_rect
        fuzz = np.stack([f[y0:y1, x0:x1]
                         for f in fuzz_frames(cam, 32, seed=11)])
        devicecheck.compare_results(
            devicecheck.decode_on(gpu, dec, fuzz),
            devicecheck.decode_on(cpu, dec, fuzz), f"phase4 {name} fuzz")
        t0 = time.perf_counter()
        res_gpu = devicecheck.decode_on(gpu, dec, fuzz,
                                        caps=comp_ops.RESCUE_CAPS)
        TIMINGS.append((f"rescue graph B=32 {name}",
                        time.perf_counter() - t0, None))
        res_cpu = devicecheck.decode_on(cpu, dec, fuzz,
                                        caps=comp_ops.RESCUE_CAPS)
        assert res_gpu.converged.all()
        devicecheck.compare_results(res_gpu, res_cpu,
                                    f"phase4 {name} rescue")
        log(f"phase4: {name} B={BATCH_API} fixture replay, 32 fuzz frames "
            f"and the rescue graph equal to the CPU (positions and values "
            f"within {devicecheck.POSITION_TOL})")


def phase5_timings(card):
    for name, compile_s, steady_s in TIMINGS:
        steady = ("not taken" if steady_s is None
                  else f"{steady_s:.4f}s")
        log(f"timing: {name}: first call (compile+run) {compile_s:.3f}s, "
            f"steady {steady} [{card}]")


def mesh_phase(n: int):
    """stream --mesh N's path (MeshDecoder, MeshCoefStep,
    aggregate_metrics) on n cards at batch n x 256, both feeds, against
    the same frames decoded on one card in this process."""
    import jax

    from meterelf_jax.errors import ErrCode
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.parallel.mesh import MeshCoefStep, MeshDecoder, make_mesh
    from meterelf_jax.pipeline.decode import MeterDecoder, make_coef_decode_fn

    devs = jax.devices()
    assert len(devs) >= n, f"--mesh {n} needs {n} devices, have {len(devs)}"
    mesh = make_mesh(devs[:n])
    B = n * 256
    for name in CAMERAS:
        d, params, frames = camera(name)
        datas = read_frames(d, frames)
        tile = (datas * (B // len(datas) + 1))[:B]
        rect = params.meter_rect
        dec = MeterDecoder(params)
        packed, ok = jio.load_packed_crops_from_bytes(
            tile, rect)
        single = dec.decode_numpy(packed, ok)
        md = MeshDecoder(dec, mesh)
        res = timed(f"mesh{n} pixel B={B} {name}", md, packed, ok)
        step, _win = make_coef_decode_fn(dec, FRAME_WH)
        ms = MeshCoefStep(step, mesh)
        feed = jio.load_coef_feed(tile, rect, FRAME_WH)
        res_c = timed(f"mesh{n} coef B={B} {name}", ms,
                      dec.param_arrays, *feed)
        for label, r, agg in (("pixel", res, md.aggregate),
                              ("coef", res_c, ms.aggregate)):
            assert len(r.err.sharding.device_set) == n, label
            r_np = type(r)(*map(np.asarray, r))
            for field in ("err", "dial_pos", "value", "readable"):
                np.testing.assert_array_equal(
                    getattr(r_np, field), getattr(single, field),
                    err_msg=f"mesh {name} {label}: {field}")
            n_ok, n_err, mean_v = (np.asarray(a) for a in agg(r))
            okm = single.err == int(ErrCode.OK)
            assert int(n_ok) == int(okm.sum()), label
            assert int(n_err) == int((~okm).sum()), label
            np.testing.assert_allclose(float(mean_v),
                                       single.value[okm].mean(), rtol=1e-12)
        log(f"mesh: {name} {n} cards B={B}: pixel and coefficient feeds "
            f"equal to one card; psum ok={int(n_ok)} err={int(n_err)} "
            f"mean={float(mean_v):.6f} equal to the host sums")


def main(argv) -> int:
    mesh_n = None
    if argv[:1] == ["--mesh"] and len(argv) == 2:
        mesh_n = int(argv[1])
    elif argv:
        print("usage: python chip_smoke.py [--mesh N]", file=sys.stderr)
        return 2
    from meterelf_jax.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    gpu = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    phase0_setup()
    card = card_line()
    if mesh_n is not None:
        mesh_phase(mesh_n)
        count = mesh_n
    else:
        phase1_primitives(gpu, cpu)
        pixel = phase2_cli(cpu)
        phase3_coef(pixel)
        phase3_pool_is_cpu_only()
        phase4_batched(gpu, cpu)
        count = len(jax.devices())
    phase5_timings(card)
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    sys.exit(main(sys.argv[1:]))
