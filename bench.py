"""Benchmark: batched dial-decode throughput on one NVIDIA GPU.

Prints the card's name and power limit, then ONE JSON line:

- ``value``: device-resident replay rate (img/s) of the decode graph at
  B=384 on the default synthetic camera — frames staged on the device
  once and replayed inside one jitted lax.map dispatch;
- ``camera2_img_s``: the same for the second geometry (ALT_CAMERA);
- ``end_to_end_img_s``: JPEG bytes in host RAM -> C region decode to u8
  crops -> H2D -> device-side pack -> decode graph, with
  ``host_decode_img_s`` the host decode stage alone on all cores;
- ``end_to_end_coef_img_s``: the coefficient feed (host entropy decode
  only, device JPEG back-half), with the host entropy rate per thread
  count (``host_entropy_sweep``) measured in a child that never starts a
  JAX backend;
- ``device_incl_jpeg_backhalf_img_s`` (dense block wire) and ``..._compact``
  (12-bit plane wire): device rate when the graph also finishes the JPEG.

The data is the committed synthetic corpus (tests/data/synthetic, 48
full 640x480 4:2:0 frames per camera). Before anything is timed, every
frame's reading is gated: the CLI's rendered lines must equal
expected_stdout.txt, and clean frames must read their rendered dial
positions (truth.json) within 0.15 of a dial unit. Exits non-zero
without a GPU. The batch sizes are the ones carried over from the
previous accelerator; re-sweeping them on the card is open work.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

FIXTURES = os.path.join(REPO, "tests", "data", "synthetic")
BATCH = int(os.environ.get("METERELF_BENCH_BATCH", "384"))
BATCH_BH = int(os.environ.get("METERELF_BENCH_BATCH_BH", "512"))
REPLAY_FRAMES = 10240
FRAME_WH = (640, 480)
TRUTH_TOL = 0.15


def load_camera(name):
    from meterelf_jax.params import Params

    d = os.path.join(FIXTURES, name)
    with open(os.path.join(d, "truth.json")) as fp:
        truth = json.load(fp)
    files = [os.path.join(d, f) for f in sorted(truth)]
    datas = []
    for f in files:
        with open(f, "rb") as fp:
            datas.append(fp.read())
    return Params.load(os.path.join(d, "params.yml")), files, datas, truth


def gate(dec, params, files, datas, truth) -> np.ndarray:
    """Refuse to time a wrong pipeline: rendered lines equal the
    committed CLI output, clean frames read their rendered positions.
    Returns the packed crops and load flags of the gated frames."""
    from meterelf_jax.api import result_to_data
    from meterelf_jax.cli import format_result
    from meterelf_jax.errors import ErrCode
    from meterelf_jax.io import jpeg as jio

    rect = params.meter_rect
    packed, ok = jio.load_packed_crops_from_bytes(
        datas, rect)
    res = dec.decode_numpy(packed, ok)
    with open(os.path.join(os.path.dirname(files[0]),
                           "expected_stdout.txt")) as fp:
        golden = fp.read().splitlines()
    got = [format_result(result_to_data(f, res, i, params)
                         ._replace(filename=os.path.basename(f)))
           for i, f in enumerate(files)]
    bad = [(g, e) for g, e in zip(got, golden) if g != e]
    assert len(got) == len(golden) and not bad, (
        f"{len(bad)} rendered lines diverge; first: {bad[:1]}")
    for i, f in enumerate(files):
        t = truth[os.path.basename(f)]
        if t["kind"] in ("reading", "speckle"):
            assert res.err[i] == ErrCode.OK, f
            dev = np.abs((res.dial_pos[i] - np.asarray(t["positions"])
                          + 5) % 10 - 5)
            assert dev.max() < TRUTH_TOL, (f, dev)
    return packed, ok


def replay_rate(dec, crops, ok) -> float:
    """Device-resident replay throughput (img/s): the frames tiled to
    REPLAY_FRAMES, staged on the device as [n_batches, BATCH, ...], and
    decoded inside ONE jitted lax.map dispatch; best of 3 timed runs,
    each ending in a scalar readback."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    n_batches = REPLAY_FRAMES // BATCH
    reps = -(-n_batches * BATCH // crops.shape[0])
    crops_all = np.tile(crops, (reps, 1, 1))[:n_batches * BATCH]
    ok_all = np.tile(ok, reps)[:n_batches * BATCH]
    crops_dev = jax.device_put(
        crops_all.reshape(n_batches, BATCH, *crops_all.shape[1:]))
    ok_dev = jax.device_put(ok_all.reshape(n_batches, BATCH))

    @jax.jit
    def replay(cs, oks):
        def step(i):
            r = dec._fn(dec.param_arrays, cs[i], oks[i])
            return r.value.sum() + r.err.sum().astype(r.value.dtype)

        return lax.map(step, jnp.arange(n_batches, dtype=jnp.int32)).sum()

    float(replay(crops_dev, ok_dev))  # compile + warm-up
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        assert np.isfinite(float(replay(crops_dev, ok_dev)))
        dt = min(dt, time.perf_counter() - t0)
    return n_batches * BATCH / dt


def _chunks(datas, frames=2048):
    reps = -(-frames // len(datas))
    tiled = (datas * reps)[:(frames // BATCH) * BATCH]
    return [tiled[i:i + BATCH] for i in range(0, len(tiled), BATCH)]


def end_to_end_rate(dec, params, datas):
    """JPEG bytes -> readings, every stage on the clock; and the host
    region decode alone on all cores."""
    import jax
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import pack_crops_device

    chunks = _chunks(datas)
    pa_dev = jax.device_put(dec.param_arrays)

    @jax.jit
    def step(pa, crops_u8, ok):
        r = dec._fn(pa, pack_crops_device(crops_u8), ok)
        return r.value.sum() + r.err.sum().astype(r.value.dtype)

    threads = os.cpu_count() or 1

    def run_pass():
        sums = []
        for chunk in chunks:
            crops, ok = jio.load_crop_bytes_u8(
                chunk, params.meter_rect, num_threads=threads)
            sums.append(step(pa_dev, crops, ok))
        return sum(float(s) for s in sums)

    run_pass()  # compile + warm-up
    t0 = time.perf_counter()
    assert np.isfinite(run_pass())
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    for chunk in chunks:
        jio.load_crop_bytes_u8(chunk, params.meter_rect, num_threads=threads)
    host_dt = time.perf_counter() - t0
    n = len(chunks) * BATCH
    return n / dt, n / host_dt


def end_to_end_rate_coef(dec, params, datas):
    """Bytes -> readings through the coefficient feed, and the host
    entropy sweep {threads: img/s} from a JAX-free child process."""
    import jax
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import make_coef_decode_fn

    chunks = _chunks(datas)
    step, _win = make_coef_decode_fn(dec, FRAME_WH)
    pa_dev = jax.device_put(dec.param_arrays)
    threads = os.cpu_count() or 1

    def run_pass():
        sums = []
        for chunk in chunks:
            feed = jio.load_coef_feed(chunk, params.meter_rect, FRAME_WH,
                                      num_threads=threads)
            r = step(pa_dev, *feed)
            sums.append(r.value.sum() + r.err.sum().astype(r.value.dtype))
        return sum(float(s) for s in sums)

    run_pass()  # compile + warm-up
    t0 = time.perf_counter()
    assert np.isfinite(run_pass())
    dt = time.perf_counter() - t0
    r = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--entropy-sweep",
         str(len(chunks) * BATCH)],
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    sweep = json.loads(r.stdout.strip().splitlines()[-1])
    return len(chunks) * BATCH / dt, sweep


def entropy_sweep_main(frames: int) -> None:
    """--entropy-sweep child: the host coefficient feed alone, best of 3
    per thread count; one JSON line {threads: img_per_s}."""
    from meterelf_jax.io import jpeg as jio

    params, _files, datas, _truth = load_camera("default")
    datas = (datas * (-(-frames // len(datas))))[:frames]
    ncpu = os.cpu_count() or 1
    out = {}
    for t in sorted({1, 2, 4, 8, ncpu} & set(range(1, ncpu + 1))):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jio.load_coef_feed(datas, params.meter_rect, FRAME_WH,
                               num_threads=t)
            best = min(best, time.perf_counter() - t0)
        out[str(t)] = round(len(datas) / best, 1)
    print(json.dumps(out))


def device_rate_with_backhalf(dec, params, datas, compact: bool) -> float:
    """Device rate when the graph also finishes the JPEG: BATCH_BH
    frames' coefficient windows staged once and replayed 32 times in one
    lax.map dispatch (each step xors one coefficient with the loop index
    so XLA cannot hoist the work); dense block wire or compact wire."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import make_coef_decode_fn

    step, win = make_coef_decode_fn(dec, FRAME_WH)
    tiled = (datas * (-(-BATCH_BH // len(datas))))[:BATCH_BH]
    threads = os.cpu_count() or 1
    if compact:
        cy, cb, cr, qt, ok = (a.copy() for a in jio.read_coefs_batch(
            tiled, win, FRAME_WH, num_threads=threads, plane_layout=True,
            compact=True))
        rect = params.meter_rect
        fbp = np.zeros((8, rect.height, rect.width), np.int32)
        fbi = np.full(8, BATCH_BH, np.int32)
        feed = (cy, cb, cr, qt, ok, fbp, fbi)
    else:
        feed = jio.load_coef_feed(tiled, params.meter_rect, FRAME_WH,
                                  num_threads=threads)
    args = [jax.device_put(a) for a in feed]
    pa_dev = jax.device_put(dec.param_arrays)
    reps = 32

    @jax.jit
    def replay(cy, cb, cr, qt, ok, fbp, fbi):
        def body(i):
            idx = (slice(None),) + (0,) * (cy.ndim - 1)
            cyx = cy.at[idx].set(cy[idx] ^ i.astype(cy.dtype))
            r = step(pa_dev, cyx, cb, cr, qt, ok, fbp, fbi)
            return r.value.sum() + r.err.sum().astype(r.value.dtype)
        return lax.map(body, jnp.arange(reps, dtype=jnp.int32)).sum()

    float(replay(*args))  # compile + warm-up
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        assert np.isfinite(float(replay(*args)))
        best = min(best, time.perf_counter() - t0)
    return BATCH_BH * reps / best


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip()


def main() -> int:
    from meterelf_jax.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print(f"bench: no GPU (JAX backend {jax.default_backend()!r}); "
              "no number reported", file=sys.stderr)
        return 1
    from meterelf_jax.pipeline.decode import MeterDecoder

    dev = jax.devices()[0]
    card = card_line()
    print(f"card: {card}", flush=True)
    record = {"metric": "images_per_sec_per_chip_batched_decode",
              "unit": "img/s/chip", "batch": BATCH,
              "device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())},
              "card": card, "xla_flags": os.environ.get("XLA_FLAGS", "")}
    for name in ("default", "alt"):
        params, files, datas, truth = load_camera(name)
        dec = MeterDecoder(params, exact=True)
        crops, ok = gate(dec, params, files, datas, truth)
        rate = replay_rate(dec, crops, ok)
        if name == "alt":
            record["camera2_img_s"] = round(rate, 1)
            continue
        record["value"] = round(rate, 1)
        e2e, host = end_to_end_rate(dec, params, datas)
        record["end_to_end_img_s"] = round(e2e, 1)
        record["host_decode_img_s"] = round(host, 1)
        record["host_cores"] = os.cpu_count()
        ce2e, sweep = end_to_end_rate_coef(dec, params, datas)
        record["end_to_end_coef_img_s"] = round(ce2e, 1)
        record["host_entropy_sweep"] = sweep
        for compact in (False, True):
            key = "device_incl_jpeg_backhalf_img_s" + (
                "_compact" if compact else "")
            record[key] = round(
                device_rate_with_backhalf(dec, params, datas, compact), 1)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--entropy-sweep":
        entropy_sweep_main(int(sys.argv[2]))
    else:
        sys.exit(main())
