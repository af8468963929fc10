"""Streaming pipeline tests (rolling stats, rollover unwrap, leak flag)."""
import numpy as np
import pytest

from meterelf_jax.stream import _unwrap_delta, stream_decode, StreamReport

pytestmark = pytest.mark.needs_samples


def test_unwrap_delta():
    assert _unwrap_delta(100.0, 101.5) == 1.5
    assert _unwrap_delta(999.9, 0.1) == pytest.approx(0.2)   # rollover
    assert _unwrap_delta(100.0, 99.9) == 0.0                 # noise clamp


def test_stream_over_sample_frames(params1, decoder1):
    from glob import glob
    from meterelf_jax.stream import replay_files

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:8]
    frames = replay_files(params1, files, repeat=2)
    ts = iter(np.arange(1000.0, 2000.0, 10.0))
    reports = list(stream_decode(
        params1, frames, decoder=decoder1, batch_size=8, timestamps=ts))
    assert reports, "no reports emitted"
    last = reports[-1]
    assert isinstance(last, StreamReport)
    assert last.frames_total == 12
    assert last.frames_ok > 0
    assert last.cumulative_liters >= 0.0
    assert last.last_value is not None


def test_stream_bytes_matches_crops(params1, decoder1):
    """The coefficient-feed stream (host entropy decode -> device JPEG
    back-half + dial decode) must produce the same rolling statistics as
    the pixel-crop stream on the same frames."""
    from glob import glob
    from meterelf_jax.stream import replay_files, stream_decode_bytes

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:10]
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * len(files), 10.0))
    ref = list(stream_decode(
        params1, replay_files(params1, files), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    byte_frames = [(f, open(f, "rb").read()) for f in files]
    got = list(stream_decode_bytes(
        params1, byte_frames, (480, 640), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters
        assert a.flow_lph == b.flow_lph


def test_stream_cli_coef_flag(capsys):
    """`--coef WxH` streams raw JPEG bytes through the coefficient
    feed."""
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:6]
    if not files:
        pytest.skip("sample corpus not mounted")
    stream_mod.main(
        ["/root/reference/sample-images1/params.yml", *files,
         "--repeat", "2", "--batch", "8", "--coef", "480x640"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("frames=8 ")


def test_stream_leak_detection(params1, decoder1):
    """Synthetic monotone consumption across the window trips the flag."""
    from glob import glob
    from meterelf_jax.io import jpeg as jio

    # one good frame replayed; fake timestamps; monkeypatch values by
    # streaming the same frame and checking flow==0 gives no leak
    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:3]
    from meterelf_jax.stream import replay_files
    frames = list(replay_files(params1, files, repeat=6))
    ts = iter(np.arange(0.0, 600.0, 10.0))
    reports = list(stream_decode(
        params1, frames, decoder=decoder1, batch_size=8, timestamps=ts))
    assert not reports[-1].leak_suspected  # same frame => zero flow


class _ScriptedDecoder:
    """Fake decoder emitting a prescribed per-frame value sequence —
    exercises the rolling-stats/leak logic without any device work."""

    def __init__(self, values, converged=True):
        self.values = list(values)
        self.converged = converged
        self.i = 0

    def __call__(self, crops):
        from types import SimpleNamespace

        b = crops.shape[0]
        vals = np.zeros(b)
        for j in range(b):
            if self.i < len(self.values):
                vals[j] = self.values[self.i]
                self.i += 1
        return SimpleNamespace(
            converged=np.full(b, self.converged),
            err=np.zeros(b, np.int32),  # ErrCode.OK
            value=vals,
        )


def _dummy_frames(n):
    return [(f"f{i:03d}", np.zeros((2, 2, 3), np.uint8)) for i in range(n)]


def _scripted_reports(values, ts_step=60.0, **kw):
    n = len(values)
    dec = _ScriptedDecoder(values)
    ts = iter(np.arange(0.0, ts_step * (n + 1), ts_step))
    # params is only consulted when no decoder is injected
    return list(stream_decode(
        None, _dummy_frames(n), decoder=dec, batch_size=4,
        timestamps=ts, window_seconds=7200.0, **kw))


def test_stream_leak_positive():
    """Sustained consumption across the whole window trips the flag."""
    values = [100.0 + 0.1 * i for i in range(12)]  # 6 L/h at 60 s cadence
    reports = _scripted_reports(values)
    assert reports[-1].leak_suspected


def test_stream_leak_survives_single_flat_step():
    """Reading resolution is 0.1 L: one flat inter-frame step must not
    mask a genuine leak (the per-step-minimum heuristic would)."""
    values = [100.0 + 0.1 * i for i in range(12)]
    values[6] = values[5]  # one flat step mid-window
    reports = _scripted_reports(values)
    assert reports[-1].leak_suspected


def test_stream_no_leak_on_intermittent_use():
    """A burst of consumption followed by a long idle period shows
    positive average flow but is NOT a leak (a zero-flow bin exists)."""
    values = [100.0 + 0.5 * min(i, 4) for i in range(12)]
    reports = _scripted_reports(values)
    last = reports[-1]
    assert last.flow_lph is not None and last.flow_lph > 0.5
    assert not last.leak_suspected


def test_stream_rejects_unrescuable_decoder():
    """A non-converged batch from an injected decoder without a rescue
    path must raise, never silently emit mislabeled readings."""
    dec = _ScriptedDecoder([1.0] * 8, converged=False)
    with pytest.raises(RuntimeError, match="rescue"):
        list(stream_decode(
            None, _dummy_frames(8), decoder=dec, batch_size=4))


def test_stream_stage_timers():
    from meterelf_jax.profiling import StageTimers

    tm = StageTimers()
    _scripted_reports([100.0 + 0.1 * i for i in range(8)], timers=tm)
    assert tm.counts["dispatch"] >= 2 and tm.counts["drain"] >= 2
    assert "dispatch" in tm.report()


def test_stream_cli_usage_error():
    from meterelf_jax import stream as stream_mod

    with pytest.raises(SystemExit) as exc:
        stream_mod.main([])
    assert exc.value.code == 1


def test_stream_cli_on_sample_files(capsys):
    """The `python -m meterelf_jax.stream` report lines (config 5)."""
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:6]
    if not files:
        pytest.skip("sample corpus not mounted")
    stream_mod.main(
        ["/root/reference/sample-images1/params.yml", *files,
         "--repeat", "3", "--batch", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out, "no report lines printed"
    assert out[-1].startswith("frames=12 ")
    assert "rate=" in out[-1] and "leak=" in out[-1]


def test_stream_cli_trace_flag(capsys, tmp_path):
    """`--trace DIR` captures a jax.profiler device trace of the run."""
    import os
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:4]
    if not files:
        pytest.skip("sample corpus not mounted")
    trace_dir = str(tmp_path / "trace")
    stream_mod.main(
        ["/root/reference/sample-images1/params.yml", *files,
         "--batch", "8", "--trace", trace_dir])
    assert capsys.readouterr().out.startswith("frames=2 ")
    captured = [os.path.join(r, f)
                for r, _d, fs in os.walk(trace_dir) for f in fs]
    assert any(f.endswith((".xplane.pb", ".trace.json.gz"))
               for f in captured), captured


def test_stream_mesh_matches_single(params1, decoder1):
    """The mesh-sharded stream (parallel/mesh.MeshDecoder over the
    8-device CPU mesh) must report the same rolling statistics as the
    single-chip stream, and each full batch's device_agg (psum-reduced
    on device) must equal the host-side counts."""
    import jax
    from glob import glob
    from meterelf_jax.parallel.mesh import make_mesh
    from meterelf_jax.stream import replay_files

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:10]
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * 2 * len(files), 10.0))
    ref = list(stream_decode(
        params1, replay_files(params1, files, repeat=2), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    mesh = make_mesh(jax.devices("cpu"))
    got = list(stream_decode(
        params1, replay_files(params1, files, repeat=2), decoder=decoder1,
        mesh=mesh, batch_size=8, timestamps=iter(ts)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters
        assert a.flow_lph == b.flow_lph
    # cumulative host counts vs per-batch device psums
    n_ok = sum(r.device_agg[0] for r in got if r.device_agg)
    n_err = sum(r.device_agg[1] for r in got if r.device_agg)
    assert all(r.device_agg is not None for r in got)  # batches are full
    assert n_ok == got[-1].frames_ok
    assert n_err == got[-1].frames_error


def test_stream_cli_mesh_flag(capsys):
    """`--mesh 8` shards the stream over the virtual CPU mesh and
    appends the psum-reduced metrics to every report line."""
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:6]
    if not files:
        pytest.skip("sample corpus not mounted")
    stream_mod.main(
        ["/root/reference/sample-images1/params.yml", *files,
         "--repeat", "2", "--batch", "8", "--mesh", "8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("frames=8 ")
    assert "mesh[ok=" in out[-1]


def test_stream_bytes_mesh_matches_single(params1, decoder1):
    """The mesh-sharded coefficient-feed stream (MeshCoefStep over the
    8-device CPU mesh) must match the single-chip bytes stream report
    for report, and carry the psum-reduced device_agg."""
    import jax
    from glob import glob
    from meterelf_jax.parallel.mesh import make_mesh
    from meterelf_jax.stream import stream_decode_bytes

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:10]
    byte_frames = [(f, open(f, "rb").read()) for f in files]
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * len(files), 10.0))
    ref = list(stream_decode_bytes(
        params1, list(byte_frames), (480, 640), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    mesh = make_mesh(jax.devices("cpu"))
    got = list(stream_decode_bytes(
        params1, list(byte_frames), (480, 640), decoder=decoder1,
        mesh=mesh, batch_size=8, timestamps=iter(ts)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters
    assert all(r.device_agg is not None for r in got)
    assert sum(r.device_agg[0] for r in got) == got[-1].frames_ok


def test_stream_state_checkpoint_resume(params1, decoder1, tmp_path):
    """save_state/load_state round-trip: a stream resumed from a
    checkpoint continues the cumulative volume and frame totals exactly
    as if it had run unbroken."""
    from glob import glob
    from meterelf_jax.stream import (
        _StreamState, load_state, replay_files, save_state)

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:10]
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * 2 * len(files), 10.0))

    # unbroken 2-pass reference run
    st_ref = _StreamState()
    ref = list(stream_decode(
        params1, replay_files(params1, files, repeat=2), decoder=decoder1,
        batch_size=8, timestamps=iter(ts), state=st_ref))

    # pass 1 -> checkpoint -> restart -> pass 2
    path = str(tmp_path / "meter_state.json")
    st1 = load_state(path)           # missing file -> fresh state
    assert st1.frames_total == 0
    list(stream_decode(
        params1, replay_files(params1, files), decoder=decoder1,
        batch_size=8, timestamps=iter(ts[:len(files)]), state=st1))
    save_state(st1, path)
    st2 = load_state(path)
    assert st2 == st1
    r2 = list(stream_decode(
        params1, replay_files(params1, files), decoder=decoder1,
        batch_size=8, timestamps=iter(ts[len(files):]), state=st2))

    assert r2[-1].frames_total == ref[-1].frames_total
    assert r2[-1].frames_ok == ref[-1].frames_ok
    assert r2[-1].cumulative_liters == ref[-1].cumulative_liters
    assert r2[-1].last_value == ref[-1].last_value
    assert r2[-1].flow_lph == ref[-1].flow_lph


def test_stream_watch_mode_cli(tmp_path, capsys):
    """--watch daemon mode: backlog files are processed, the partial
    batch flushes on an idle poll, --state checkpoints, and a restart
    resumes the totals."""
    import shutil
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:4]
    if not files:
        pytest.skip("sample corpus not mounted")
    spool = tmp_path / "spool"
    spool.mkdir()
    for f in files:
        shutil.copy(f, spool)
    state = str(tmp_path / "state.json")
    argv = ["/root/reference/sample-images1/params.yml",
            "--watch", str(spool), "--batch", "8",
            "--poll", "0.05", "--watch-idle-exit", "2",
            "--state", state]
    stream_mod.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("frames=2 ")
    st = stream_mod.load_state(state)
    assert st.frames_total == 2

    # daemon restart over the same spool: the backlog is reprocessed
    # (dedup across restarts is the spool's job), totals resume from
    # the checkpoint
    stream_mod.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("frames=4 ")
    assert stream_mod.load_state(state).frames_total == 4


def test_stream_bytes_matches_crops_camera2(params2):
    """The coefficient-feed stream must equal the pixel stream on the
    SECOND shipped camera too (different meter rect -> different
    coefficient window geometry through io/native + ops/jpegdec)."""
    from glob import glob
    from meterelf_jax.pipeline.decode import MeterDecoder
    from meterelf_jax.stream import replay_files, stream_decode_bytes

    files = sorted(glob("/root/reference/sample-images2/*.jpg"))[:8]
    dec = MeterDecoder(params2, exact=True)
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * len(files), 10.0))
    ref = list(stream_decode(
        params2, replay_files(params2, files), decoder=dec,
        batch_size=8, timestamps=iter(ts)))
    byte_frames = [(f, open(f, "rb").read()) for f in files]
    got = list(stream_decode_bytes(
        params2, byte_frames, (480, 640), decoder=dec,
        batch_size=8, timestamps=iter(ts)))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters


def test_stream_bytes_feed_workers(params1, decoder1):
    """--feed-workers N: the sharded subprocess entropy feed must be
    BIT-IDENTICAL to the in-process feed (same reports over a corpus
    slice that includes the two corrupt frames exercising the fallback
    slot merge across shard boundaries). N=2 on this 1-core box proves
    the plumbing; the scaling curve is bench.py's entropy sweep."""
    from glob import glob
    from meterelf_jax.stream import stream_decode_bytes

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[:8]
    if not files:
        pytest.skip("sample corpus not mounted")
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * len(files), 10.0))
    byte_frames = [(f, open(f, "rb").read()) for f in files]
    ref = list(stream_decode_bytes(
        params1, byte_frames, (480, 640), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    got = list(stream_decode_bytes(
        params1, byte_frames, (480, 640), decoder=decoder1,
        batch_size=8, timestamps=iter(ts), feed_workers=2))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters


def test_feed_worker_pool_matches_inprocess(params1):
    """FeedWorkerPool.load == io.jpeg.load_coef_feed array-for-array,
    including the fallback slots (the two corrupt frames land in
    different shards)."""
    from glob import glob
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.ops import jpegdec
    from meterelf_jax.stream import FeedWorkerPool

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[:6]
    if not files:
        pytest.skip("sample corpus not mounted")
    datas = [open(f, "rb").read() for f in files]
    win = jpegdec.coef_window(params1.meter_rect, 480, 640)
    ref = jio.load_coef_feed(datas, params1.meter_rect, (480, 640))
    pool = FeedWorkerPool(2, params1.meter_rect, (480, 640), tuple(win))
    try:
        got = pool.load(datas)
    finally:
        pool.close()
    for i, (a, b) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"field {i}")


def test_stream_bytes_mesh_with_feed_workers(params1, decoder1):
    """The full production shape composes: subprocess entropy workers
    (--feed-workers) feeding a mesh-sharded coefficient stream
    (--mesh) must equal the plain single-device in-process stream, with
    device_agg present on full batches."""
    import jax
    from glob import glob
    from meterelf_jax.parallel.mesh import make_mesh
    from meterelf_jax.stream import stream_decode_bytes

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[2:10]
    if not files:
        pytest.skip("sample corpus not mounted")
    ts = list(np.arange(1000.0, 1000.0 + 10.0 * len(files), 10.0))
    byte_frames = [(f, open(f, "rb").read()) for f in files]
    ref = list(stream_decode_bytes(
        params1, byte_frames, (480, 640), decoder=decoder1,
        batch_size=8, timestamps=iter(ts)))
    mesh = make_mesh(jax.devices("cpu"))
    got = list(stream_decode_bytes(
        params1, byte_frames, (480, 640), decoder=decoder1,
        mesh=mesh, batch_size=8, feed_workers=2, timestamps=iter(ts)))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert a.frames_ok == b.frames_ok
        assert a.frames_error == b.frames_error
        assert a.last_value == b.last_value
        assert a.cumulative_liters == b.cumulative_liters
    assert all(r.device_agg is not None for r in got)


def test_stream_watch_bytes_mid_write(tmp_path, params1):
    """Bytes mode (--watch --coef) must not swallow a JPEG still being
    written: a payload without the trailing EOI marker retries next poll
    (like the pixel path's failed decode) and the COMPLETED file is
    emitted with its full bytes; a permanently truncated file is
    surfaced once as an error frame after max_retries."""
    from glob import glob
    from meterelf_jax.stream import watch_files

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:3]
    if not files:
        pytest.skip("sample corpus not mounted")
    data = open(files[0], "rb").read()
    spool = tmp_path / "spool"
    spool.mkdir()
    part = spool / "a.jpg"
    part.write_bytes(data[:len(data) // 2])     # mid-write: no EOI yet
    gen = watch_files(params1, str(spool), poll_seconds=0.01,
                      as_bytes=True, max_retries=3, idle_exit=20)
    name, payload = next(gen)
    assert payload is None                      # flush, not truncated bytes
    part.write_bytes(data)                      # the writer finishes
    name, payload = next(gen)
    assert name.endswith("a.jpg") and payload == data
    bad = spool / "b.jpg"
    bad.write_bytes(data[:100])                 # never completed
    for name, payload in gen:
        if payload is not None:
            break
    else:
        pytest.fail("truncated file never surfaced")
    assert name.endswith("b.jpg") and payload == b""


def test_stream_watch_gives_up_on_corrupt_file(tmp_path, capsys):
    """A permanently corrupt spool file is retried max_retries polls,
    then surfaced once as an error frame — the daemon never livelocks
    re-decoding it."""
    import shutil
    from glob import glob
    from meterelf_jax import stream as stream_mod

    files = sorted(glob("/root/reference/sample-images1/2018*.jpg"))[2:3]
    if not files:
        pytest.skip("sample corpus not mounted")
    spool = tmp_path / "spool"
    spool.mkdir()
    shutil.copy(files[0], spool)
    (spool / "zz-corrupt.jpg").write_bytes(b"\xff\xd8 not a jpeg")
    stream_mod.main(
        ["/root/reference/sample-images1/params.yml",
         "--watch", str(spool), "--batch", "8",
         "--poll", "0.05", "--watch-idle-exit", "3"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out and out[-1].startswith("frames=2 ok=1 err=1 ")
