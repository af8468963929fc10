"""Streaming decode: continuous webcam-replay pipeline with rolling
value / flow / leak reporting (BASELINE.json config 5).

The reference has no streaming mode (it is a one-shot CLI); this is the
batched deployment shape: frames arrive in batches, the device graph
is dispatched asynchronously (JAX dispatch returns before execution, so
batch k+1's host work overlaps batch k's device work — double
buffering), and per-window statistics are reduced on the host from the
per-image readings.

Value semantics: readings are liters mod 1000 (4 dials); the stream
unwraps rollovers to a cumulative volume and estimates flow over a
sliding window. The leak flag trips on sustained flow: the window is
split into equal time bins and every bin must show consumption — the
classic water-leak heuristic (no sustained zero-flow period), robust to
a single flat inter-frame step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .errors import ErrCode
from .params import Params
from .pipeline.decode import MeterDecoder
from .profiling import StageTimers


@dataclass
class StreamReport:
    """Rolling statistics emitted once per decoded batch."""

    frames_total: int
    frames_ok: int
    frames_error: int
    last_value: Optional[float]          # liters (mod 1000)
    cumulative_liters: float             # unwrapped volume since start
    flow_lph: Optional[float]            # liters/hour over the window
    leak_suspected: bool
    images_per_sec: float
    # mesh mode only: this batch's (n_ok, n_err, mean value over ok)
    # reduced ON DEVICE across the mesh with psum-class collectives —
    # the multi-chip metric path (parallel/mesh.aggregate_metrics)
    device_agg: Optional[Tuple[int, int, float]] = None


@dataclass
class _StreamState:
    frames_total: int = 0
    frames_ok: int = 0
    frames_error: int = 0
    last_value: Optional[float] = None
    cumulative: float = 0.0
    window: List[Tuple[float, float]] = field(default_factory=list)  # (t, cum)


def save_state(state: _StreamState, path: str) -> None:
    """Persist rolling stream state as JSON, atomically (write to a
    sibling temp file + rename) so a crash mid-write never corrupts the
    checkpoint. The reference has no state at all (one-shot CLI); this
    is the failure-recovery half of the continuous deployment shape —
    cumulative volume and the flow window survive restarts."""
    import json
    import os

    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump({
            "frames_total": state.frames_total,
            "frames_ok": state.frames_ok,
            "frames_error": state.frames_error,
            "last_value": state.last_value,
            "cumulative": state.cumulative,
            "window": state.window,
        }, fp)
    os.replace(tmp, path)


def load_state(path: str) -> _StreamState:
    """Load a save_state checkpoint (missing file -> fresh state)."""
    import json
    import os

    if not os.path.exists(path):
        return _StreamState()
    with open(path) as fp:
        d = json.load(fp)
    return _StreamState(
        frames_total=int(d["frames_total"]),
        frames_ok=int(d["frames_ok"]),
        frames_error=int(d["frames_error"]),
        last_value=(None if d["last_value"] is None
                    else float(d["last_value"])),
        cumulative=float(d["cumulative"]),
        window=[(float(t), float(c)) for t, c in d["window"]],
    )


def _unwrap_delta(prev: float, new: float) -> float:
    """Meter wraps at 1000 liters; consumption is non-negative and small
    between frames, so interpret backward jumps > 900 as rollover (the
    same fixup the reference's tests apply, tests/test_meterelf.py:83-84)."""
    delta = new - prev
    if delta < -900.0:
        delta += 1000.0
    return max(delta, 0.0)


def stream_decode(
    params: Params,
    frames: Iterable[Tuple[str, np.ndarray]],
    *,
    decoder: Optional[MeterDecoder] = None,
    mesh: Optional["Mesh"] = None,
    batch_size: int = 256,
    window_seconds: float = 600.0,
    leak_min_flow_lph: float = 0.5,
    leak_bins: int = 4,
    timestamps: Optional[Iterable[float]] = None,
    timers: Optional[StageTimers] = None,
    state: Optional[_StreamState] = None,
) -> Iterator[StreamReport]:
    """Decode a stream of (name, meter-rect crop u8) pairs in batches.

    A `(name, None)` frame is a FLUSH marker: the current partial batch
    is padded and dispatched immediately (watch-mode sources emit one
    when a poll round finds no new frames, so readings are not held
    back waiting for a full batch). `state` resumes from a prior
    load_state checkpoint; the caller owns it and may save_state it
    after each yielded report.

    Yields a StreamReport per batch. Dispatch is pipelined: batch k+1 is
    enqueued before batch k's results are pulled to the host.

    With `mesh` (a jax.sharding.Mesh), each batch is sharded over the
    mesh's data axis (parallel/mesh.MeshDecoder) and every report
    carries `device_agg`, the batch metrics reduced across chips on
    device — the multi-chip deployment shape. batch_size must be a
    multiple of the mesh size (the final short batch is padded up).
    """
    dec = decoder or MeterDecoder(params, exact=True)
    if mesh is not None:
        from .parallel.mesh import MeshDecoder

        if batch_size % mesh.size != 0:   # survives python -O
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size "
                f"{mesh.size}")
        dec = MeshDecoder(dec, mesh)

    def emit(buf_names, buf_crops):
        pad = batch_size - len(buf_names)
        crops = np.stack(buf_crops)
        if pad:
            crops = np.concatenate(
                [crops, np.zeros((pad,) + crops.shape[1:], crops.dtype)])
        return buf_names, crops

    def batches():
        buf_names: List[str] = []
        buf_crops: List[np.ndarray] = []
        for name, crop in frames:
            if crop is None:  # flush marker
                if buf_names:
                    yield emit(buf_names, buf_crops)
                    buf_names, buf_crops = [], []
                continue
            buf_names.append(name)
            buf_crops.append(crop)
            if len(buf_names) == batch_size:
                yield buf_names, np.stack(buf_crops)
                buf_names, buf_crops = [], []
        if buf_names:
            yield emit(buf_names, buf_crops)

    def dispatch(crops):
        return dec(crops)  # async: device starts while the host loops

    def rescue(crops, res):
        # pathological masks defeated the corpus-tuned CCL caps:
        # replace the non-converged rows via the rescue graph (raises
        # if even rescue caps don't converge). Injected decoders that
        # don't expose a rescue path (e.g. bare mesh callables) must
        # not silently emit potentially-mislabeled readings.
        if not hasattr(dec, "rescue_numpy"):
            raise RuntimeError(
                "stream batch failed CCL convergence and the injected "
                "decoder has no rescue_numpy; refusing to emit "
                "potentially mislabeled readings")
        import jax

        return dec.rescue_numpy(crops, jax.tree.map(np.asarray, res))

    return _stream_core(batches(), dispatch, rescue,
                        window_seconds=window_seconds,
                        leak_min_flow_lph=leak_min_flow_lph,
                        leak_bins=leak_bins, timestamps=timestamps,
                        timers=timers,
                        agg=dec.aggregate if mesh is not None else None,
                        state=state)


def _feed_worker_run(task):
    """Entropy-decode one shard of a batch in a worker subprocess.

    Jax-free on the hot path: the window geometry is precomputed by the
    parent, so the worker calls straight into the C reader
    (io.jpeg.load_coef_feed_shard) and never starts a JAX backend."""
    from .io.jpeg import load_coef_feed_shard

    (datas, win_t, rect, frame_wh, fb_slots) = task
    return load_coef_feed_shard(
        datas, win_t, rect, frame_wh, fb_slots=fb_slots, num_threads=1)


class FeedWorkerPool:
    """N subprocess entropy workers feeding ONE device dispatch.

    The per-core Huffman rate is the host-side ceiling of the
    coefficient feed, so one accelerator's device rate can need many
    host cores. This is that fan-in as plumbing: each batch's JPEG
    bytes are split into N contiguous shards, each shard entropy-decodes
    in its own spawn-context subprocess (jax-free hot path), and the
    parent reassembles one load_coef_feed-shaped tuple for the single
    jitted dispatch. Output is bit-identical to the in-process feed
    (tests/test_stream.py::test_stream_bytes_feed_workers). Its speedup
    is not measured yet."""

    def __init__(self, n_workers: int, meter_rect, frame_wh, win_tuple,
                 fb_slots: int = 8):
        import multiprocessing as mp
        import os

        self._rect = meter_rect
        self._frame_wh = tuple(frame_wh)
        self._win_t = tuple(win_tuple)
        self._fb_slots = fb_slots
        self._n = max(1, int(n_workers))
        ctx = mp.get_context("spawn")  # never fork a live PJRT client
        # children inherit env at spawn: pin them to the CPU backend so
        # no worker ever opens the accelerator (one JAX process per card)
        old = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            self._pool = ctx.Pool(self._n)
        finally:
            if old is None:
                os.environ.pop("JAX_PLATFORMS", None)
            else:
                os.environ["JAX_PLATFORMS"] = old

    def load(self, datas: Sequence[bytes]) -> tuple:
        """load_coef_feed for one batch, sharded across the workers."""
        n = len(datas)
        per = -(-n // self._n)
        bounds = [(i, min(i + per, n)) for i in range(0, n, per)]
        tasks = [
            (list(datas[a:b]), self._win_t, self._rect,
             self._frame_wh, self._fb_slots)
            for a, b in bounds
        ]
        parts = self._pool.map(_feed_worker_run, tasks)
        cy = np.concatenate([p[0] for p in parts])
        cb = np.concatenate([p[1] for p in parts])
        cr = np.concatenate([p[2] for p in parts])
        qt = np.concatenate([p[3] for p in parts])
        load_ok = np.concatenate([p[4] for p in parts])
        # merge per-shard fallback slots into the global budget; an
        # overflow (more stragglers than slots — a misconfigured camera,
        # not a decode-path case) degrades to load_ok=False like the
        # in-process feed
        fb_idx = np.full(self._fb_slots, n, np.int32)
        fb_packed = np.zeros(
            (self._fb_slots, self._rect.height, self._rect.width), np.int32)
        j = 0
        for (a, b), p in zip(bounds, parts):
            sh_idx, sh_packed = p[6], p[5]
            for k in range(len(sh_idx)):
                if sh_idx[k] >= (b - a):
                    continue
                gi = a + int(sh_idx[k])
                if j < self._fb_slots:
                    fb_idx[j] = gi
                    fb_packed[j] = sh_packed[k]
                    j += 1
                else:
                    load_ok[gi] = False
        return cy, cb, cr, qt, load_ok, fb_packed, fb_idx

    def close(self) -> None:
        self._pool.terminate()
        self._pool.join()


def stream_decode_bytes(
    params: Params,
    frames: Iterable[Tuple[str, bytes]],
    frame_wh: Tuple[int, int],
    *,
    decoder: Optional[MeterDecoder] = None,
    mesh: Optional["Mesh"] = None,
    batch_size: int = 256,
    num_threads: int = 2,
    feed_workers: int = 0,
    window_seconds: float = 600.0,
    leak_min_flow_lph: float = 0.5,
    leak_bins: int = 4,
    timestamps: Optional[Iterable[float]] = None,
    timers: Optional[StageTimers] = None,
    state: Optional[_StreamState] = None,
) -> Iterator[StreamReport]:
    """Streaming decode straight from JPEG bytes via the coefficient
    feed: the host entropy-decodes only (io.jpeg.load_coef_feed) and
    the device finishes the JPEG + reads the dials in one dispatch
    (pipeline.decode.make_coef_decode_fn). Same reports and pipelining
    as stream_decode; frames the coefficient reader rejects take the
    bounded pixel-fallback slots. The rare CCL-rescue path re-decodes
    that batch's bytes on the host pixel path.

    With `mesh`, each batch's coefficient windows are sharded over the
    mesh's data axis (parallel/mesh.MeshCoefStep) and reports carry the
    psum-reduced `device_agg` — the full bytes-to-readings production
    shape across chips.

    With `feed_workers` = N > 0 the host entropy stage fans out over N
    subprocess workers (FeedWorkerPool) — the multi-core feed one chip
    needs to saturate its device rate."""
    from .io import jpeg as jio
    from .pipeline.decode import make_coef_decode_fn

    dec = decoder or MeterDecoder(params, exact=True)
    step, win = make_coef_decode_fn(dec, frame_wh)
    pool = None
    if feed_workers and feed_workers > 0:
        pool = FeedWorkerPool(
            feed_workers, params.meter_rect, frame_wh, tuple(win))
    mesh_step = None
    if mesh is not None:
        from .parallel.mesh import MeshCoefStep

        if batch_size % mesh.size != 0:   # survives python -O
            raise ValueError(
                f"batch_size {batch_size} not divisible by mesh size "
                f"{mesh.size}")
        mesh_step = MeshCoefStep(step, mesh)
        step = mesh_step

    def batches():
        buf: List[Tuple[str, bytes]] = []

        def emit():
            names = [n for n, _ in buf]
            datas = [d for _, d in buf] + [b""] * (batch_size - len(buf))
            return names, datas

        for item in frames:
            if item[1] is None:  # flush marker (see stream_decode)
                if buf:
                    yield emit()
                    buf = []
                continue
            buf.append(item)
            if len(buf) == batch_size:
                yield [n for n, _ in buf], [d for _, d in buf]
                buf = []
        if buf:
            yield emit()

    def dispatch(datas):
        if pool is not None:
            feed = pool.load(datas)
        else:
            feed = jio.load_coef_feed(datas, params.meter_rect, frame_wh,
                                      num_threads=num_threads)
        return step(dec.param_arrays, *feed)

    def rescue(datas, res):
        import jax

        res = jax.tree.map(np.asarray, res)
        crops, ok = jio.load_crop_bytes_u8(datas, params.meter_rect,
                                           num_threads=num_threads)
        return dec.decode_numpy(crops, ok)

    def run():
        try:
            yield from _stream_core(
                batches(), dispatch, rescue,
                window_seconds=window_seconds,
                leak_min_flow_lph=leak_min_flow_lph,
                leak_bins=leak_bins, timestamps=timestamps,
                timers=timers,
                agg=(mesh_step.aggregate
                     if mesh_step is not None else None),
                state=state)
        finally:
            if pool is not None:
                pool.close()

    return run()


def _stream_core(
    batch_iter,
    dispatch,
    rescue,
    *,
    window_seconds: float,
    leak_min_flow_lph: float,
    leak_bins: int,
    timestamps: Optional[Iterable[float]],
    timers: Optional[StageTimers],
    agg=None,
    state: Optional[_StreamState] = None,
) -> Iterator[StreamReport]:
    """Shared pipelined drain/report loop: batch k+1 is dispatched
    before batch k's results are pulled to the host."""
    state = state if state is not None else _StreamState()
    tm = timers if timers is not None else StageTimers()
    t_start = time.time()
    start_total = state.frames_total  # resumed frames don't count in rate
    pending = None  # (names, batch payload, device result)
    ts_iter = iter(timestamps) if timestamps is not None else None

    def drain(names, payload, res) -> StreamReport:
        if not bool(np.asarray(res.converged).all()):
            with tm.stage("rescue"):
                res = rescue(payload, res)
        device_agg = None
        if agg is not None and len(names) == np.asarray(res.value).shape[0]:
            # full batches only: a padded final batch would count its
            # zero-filled pad rows as errors in the device-side reduction
            n_ok, n_err, mean_v = agg(res)
            device_agg = (int(n_ok), int(n_err), float(mean_v))
        err = np.asarray(res.err)[: len(names)]
        values = np.asarray(res.value)[: len(names)]
        now = time.time()
        for i in range(len(names)):
            state.frames_total += 1
            t = next(ts_iter) if ts_iter is not None else now
            if err[i] == ErrCode.OK:
                state.frames_ok += 1
                v = float(values[i])
                if state.last_value is not None:
                    state.cumulative += _unwrap_delta(state.last_value, v)
                state.last_value = v
                state.window.append((t, state.cumulative))
            else:
                state.frames_error += 1
        cutoff = (state.window[-1][0] - window_seconds) if state.window else 0
        while len(state.window) > 2 and state.window[0][0] < cutoff:
            state.window.pop(0)

        flow = None
        leak = False
        if len(state.window) >= 2:
            (t0, c0), (t1, c1) = state.window[0], state.window[-1]
            if t1 > t0:
                flow = (c1 - c0) * 3600.0 / (t1 - t0)
                # leak heuristic: split the window span into equal time
                # bins; a leak is sustained flow, so every bin must show
                # consumption. (Per-step minima are too fragile: one
                # flat inter-frame step — reading resolution is 0.1 L —
                # would mask a genuine leak.)
                ts = np.array([t for (t, _c) in state.window])
                cs = np.array([c for (_t, c) in state.window])
                bounds = np.linspace(t0, t1, leak_bins + 1)
                at = cs[np.searchsorted(ts, bounds, side="right") - 1]
                leak = (flow >= leak_min_flow_lph
                        and bool((np.diff(at) > 0.0).all()))
        elapsed = max(now - t_start, 1e-9)
        return StreamReport(
            frames_total=state.frames_total,
            frames_ok=state.frames_ok,
            frames_error=state.frames_error,
            last_value=state.last_value,
            cumulative_liters=state.cumulative,
            flow_lph=flow,
            leak_suspected=leak,
            images_per_sec=(state.frames_total - start_total) / elapsed,
            device_agg=device_agg,
        )

    for names, payload in batch_iter:
        with tm.stage("dispatch"):
            res = dispatch(payload)
        if pending is not None:
            with tm.stage("drain"):
                rep = drain(*pending)
            yield rep
        pending = (names, payload, res)
    if pending is not None:
        with tm.stage("drain"):
            rep = drain(*pending)
        yield rep


def replay_files(
    params: Params,
    filenames: Sequence[str],
    repeat: int = 1,
) -> Iterator[Tuple[str, np.ndarray]]:
    """Frame source that decodes JPEG files (optionally cycling them) —
    the 10k-frame continuous replay workload."""
    from .io import jpeg as jio

    decoded = []
    for fn in filenames:
        img = jio.decode_file(fn)
        if img is None:
            continue
        crop = jio.crop_rect(img, params.meter_rect)
        if crop.shape == (params.meter_rect.height, params.meter_rect.width, 3):
            decoded.append((fn, crop))
    for r in range(repeat):
        for fn, crop in decoded:
            yield fn, crop


def watch_files(
    params: Params,
    directory: str,
    *,
    glob_pattern: str = "*.jpg",
    poll_seconds: float = 2.0,
    idle_exit: Optional[int] = None,
    as_bytes: bool = False,
    max_retries: int = 3,
) -> Iterator[Tuple[str, object]]:
    """Frame source that WATCHES a directory: new files matching
    glob_pattern are decoded (or read raw with as_bytes, for the
    coefficient feed) and yielded in name order as they appear — the
    real webcam deployment, where a camera drops one JPEG per capture
    into a spool directory (the reference is instead re-run over a glob
    per cron tick, meterelf/_main.py:10).

    After any poll round that found no new files, a `(name, None)`
    FLUSH marker is emitted so the stream dispatches its partial batch
    instead of holding readings back. idle_exit=N ends the stream after
    N consecutive empty polls (None = watch forever); files that fail
    to load are skipped (they will decode as load errors only if they
    stop changing — a file still being written simply retries next
    poll). Files already present at startup are processed as backlog;
    dedup across daemon RESTARTS is the spool's job (the standard
    pattern moves or deletes files once processed) — pair with --state
    so the rolling volume survives the restart.

    A file that still fails after max_retries polls is a PERMANENTLY
    bad frame, not a mid-write race: it is emitted once as an error
    frame (empty bytes / zeroed crop, which decodes to an error code
    and counts in frames_error) so the spool never livelocks on it."""
    import os
    from glob import glob as _glob

    from .io import jpeg as jio

    seen: set = set()
    attempts: dict = {}
    rect = params.meter_rect
    idle = 0
    while True:
        names = sorted(_glob(os.path.join(directory, glob_pattern)))
        new = [n for n in names if n not in seen]
        emitted = 0

        def give_up(n):
            # surfaced as a load-error frame instead of retrying forever
            seen.add(n)
            if as_bytes:
                return n, b""
            return n, np.zeros((rect.height, rect.width, 3), np.uint8)

        for n in new:
            if as_bytes:
                try:
                    with open(n, "rb") as fp:
                        data = fp.read()
                except OSError:
                    data = None
                # mid-write protection (the pixel path gets it for free
                # from the failed decode): a JPEG still being written
                # reads fine but is truncated — require the trailing EOI
                # marker (FF D9, possibly followed by a little camera
                # padding) before marking the file seen, else retry
                # next poll like the pixel path
                if data is None or b"\xff\xd9" not in data[-32:]:
                    attempts[n] = attempts.get(n, 0) + 1
                    if attempts[n] >= max_retries:
                        yield give_up(n)
                        emitted += 1
                    continue
                seen.add(n)
                yield n, data
                emitted += 1
                continue
            img = jio.decode_file(n)
            crop = (jio.crop_rect(img, rect) if img is not None else None)
            if (crop is None
                    or crop.shape != (rect.height, rect.width, 3)):
                # unreadable now (possibly mid-write): retry next poll,
                # give up after max_retries
                attempts[n] = attempts.get(n, 0) + 1
                if attempts[n] >= max_retries:
                    yield give_up(n)
                    emitted += 1
                continue
            seen.add(n)
            yield n, crop
            emitted += 1
        if emitted == 0:
            idle += 1
            if idle_exit is not None and idle >= idle_exit:
                return
            yield "<flush>", None
            time.sleep(poll_seconds)
        else:
            idle = 0


def _filename_timestamp(name: str) -> Optional[float]:
    """Capture time embedded in corpus-style filenames
    (YYYYMMDDHHMMSS[-...].jpg), as a POSIX timestamp; None if absent."""
    import calendar
    import os
    import re

    m = re.match(r"(\d{14})", os.path.basename(name))
    if not m:
        return None
    s = m.group(1)
    try:
        tup = (int(s[0:4]), int(s[4:6]), int(s[6:8]),
               int(s[8:10]), int(s[10:12]), int(s[12:14]), 0, 0, 0)
        return float(calendar.timegm(tup))
    except ValueError:
        return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI for the continuous-replay streaming mode (BASELINE.json
    config 5): `python -m meterelf_jax.stream PARAMS_FILE [IMAGE...]
    [--repeat N] [--batch B] [--mesh N|all] [--watch DIR] [--state F]`
    prints one rolling report line per batch.

    `--mesh` shards every batch data-parallel over the first N devices
    (or all of them) and appends the psum-reduced per-batch metrics to
    each report line — the multi-chip deployment shape. It composes
    with `--coef` (sharded coefficient windows + device JPEG back-half:
    the full bytes-to-readings path across chips). Multi-host runs
    additionally set METERELF_DISTRIBUTED=1 (parallel/mesh.py).

    `--watch DIR` runs as a daemon over a camera spool directory: new
    *.jpg files are decoded as they appear (`--poll S` seconds between
    scans, default 2; partial batches flush after an idle poll so
    readings are never held back; `--watch-idle-exit K` ends after K
    consecutive empty polls — for tests/drain jobs). `--state FILE`
    checkpoints the rolling state (cumulative volume, flow window)
    after every report and resumes from it on restart — together they
    make the stream a restartable meter-monitoring daemon.

    When every filename embeds a capture timestamp (YYYYMMDDHHMMSS...),
    flow/leak windows run on recorded time (repeats continue past the
    recorded span); otherwise they fall back to wall-clock.

    METERELF_PROFILE=1 prints per-stage wall-clock timers (dispatch /
    drain / rescue) to stderr when the stream ends; `--trace DIR`
    captures a jax.profiler device trace of the whole stream into DIR
    (view with TensorBoard / xprof).
    """
    import os
    import sys

    args = list(sys.argv[1:] if argv is None else argv)
    repeat, batch = 1, 256
    trace_dir: Optional[str] = None
    coef_wh: Optional[Tuple[int, int]] = None
    mesh_arg: Optional[str] = None
    watch_dir: Optional[str] = None
    state_path: Optional[str] = None
    poll_s = 2.0
    idle_exit: Optional[int] = None
    feed_workers = 0
    debug_http: Optional[int] = None
    for flag in ("--repeat", "--batch", "--trace", "--coef", "--mesh",
                 "--watch", "--state", "--poll", "--watch-idle-exit",
                 "--feed-workers", "--debug-http"):
        if flag in args:
            i = args.index(flag)
            val = args[i + 1]
            del args[i:i + 2]
            if flag == "--repeat":
                repeat = int(val)
            elif flag == "--batch":
                batch = int(val)
            elif flag == "--coef":
                w, h = val.lower().split("x")
                coef_wh = (int(w), int(h))
            elif flag == "--mesh":
                mesh_arg = val
            elif flag == "--watch":
                watch_dir = val
            elif flag == "--state":
                state_path = val
            elif flag == "--poll":
                poll_s = float(val)
            elif flag == "--watch-idle-exit":
                idle_exit = int(val)
            elif flag == "--feed-workers":
                feed_workers = int(val)
            elif flag == "--debug-http":
                debug_http = int(val)
            else:
                trace_dir = val
    if len(args) < (1 if watch_dir else 2):
        print("usage: python -m meterelf_jax.stream PARAMS_FILE "
              "IMAGE_FILE... [--repeat N] [--batch B] [--trace DIR] "
              "[--coef WxH [--feed-workers N]] [--mesh N|all] "
              "[--watch DIR [--poll S] [--watch-idle-exit K]] "
              "[--state FILE] [--debug-http PORT]",
              file=sys.stderr)
        raise SystemExit(1)
    from .compile_cache import setup_compile_cache

    setup_compile_cache()
    mesh = None
    if mesh_arg is not None:
        import jax

        from .parallel.mesh import initialize_distributed, make_mesh

        initialize_distributed()  # no-op unless METERELF_DISTRIBUTED=1
        devs = jax.devices()
        if mesh_arg != "all":
            devs = devs[:int(mesh_arg)]
        mesh = make_mesh(devs)
    params = Params.load(args[0])
    timestamps = None
    if watch_dir is not None:
        # daemon mode: frames arrive from the spool directory;
        # flow/leak windows run on wall-clock
        frames = watch_files(params, watch_dir, poll_seconds=poll_s,
                             idle_exit=idle_exit,
                             as_bytes=coef_wh is not None)
    else:
        if coef_wh is not None:
            # coefficient feed: host entropy-decodes only; frames are
            # raw JPEG bytes and the device finishes the decode
            base_b = []
            for fn in args[1:]:
                with open(fn, "rb") as fp:
                    base_b.append((fn, fp.read()))
            ts0 = [_filename_timestamp(fn) for fn, _ in base_b]
            names_iterable = base_b
        else:
            base = list(replay_files(params, args[1:], repeat=1))
            ts0 = [_filename_timestamp(fn) for fn, _ in base]
            names_iterable = base
        if names_iterable and all(t is not None for t in ts0):
            span = (max(ts0) - min(ts0)) + 60.0
            timestamps = [t + r * span
                          for r in range(repeat) for t in ts0]
        frames = (fr for _r in range(repeat) for fr in names_iterable)
    if debug_http is not None:
        # live debug viewer (the reference's imshow affordance, reshaped
        # for a headless daemon): track the newest INGESTED frame (up
        # to one batch ahead of the printed readings) and serve its
        # overlay at http://127.0.0.1:PORT/ (debugviz.serve_overlays)
        from .debugviz import serve_overlays

        _latest = {"fn": None}

        def _tracked(it, _latest=_latest):
            for fn, payload in it:
                if payload is not None:
                    _latest["fn"] = fn
                yield fn, payload

        frames = _tracked(frames)
        srv = serve_overlays(params, lambda: _latest["fn"], debug_http)
        print(f"debug viewer: http://localhost:"
              f"{srv.server_address[1]}/", file=sys.stderr)
    timers = (StageTimers()
              if os.environ.get("METERELF_PROFILE") == "1" else None)
    st = load_state(state_path) if state_path else None
    from .profiling import device_trace

    def reports():
        if coef_wh is not None:
            return stream_decode_bytes(
                params, frames, coef_wh, batch_size=batch, mesh=mesh,
                feed_workers=feed_workers,
                timestamps=timestamps, timers=timers, state=st)
        return stream_decode(params, frames, batch_size=batch, mesh=mesh,
                             timestamps=timestamps, timers=timers,
                             state=st)

    with device_trace(trace_dir):
        for rep in reports():
            flow = ("?" if rep.flow_lph is None
                    else f"{rep.flow_lph:.3f}")
            last = ("?" if rep.last_value is None
                    else f"{rep.last_value:07.3f}")
            agg_sfx = ""
            if rep.device_agg is not None:
                n_ok, n_err, mean_v = rep.device_agg
                agg_sfx = (f" mesh[ok={n_ok} err={n_err} "
                           f"mean={mean_v:.3f}]")
            print(
                f"frames={rep.frames_total} ok={rep.frames_ok} "
                f"err={rep.frames_error} last={last} "
                f"cum={rep.cumulative_liters:.3f}L flow={flow}L/h "
                f"leak={'YES' if rep.leak_suspected else 'no'} "
                f"rate={rep.images_per_sec:.0f}img/s{agg_sfx}", flush=True)
            if state_path and st is not None:
                save_state(st, state_path)
    if timers is not None:
        print(timers.report(), file=sys.stderr)


if __name__ == "__main__":  # pragma: no cover - exercised via CLI test
    main()
