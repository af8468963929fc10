"""Genuine multi-process jax.distributed test: a 2-process CPU cluster
(2 local devices each, gloo collectives) runs the repo's real
multi-host path — initialize_distributed() env contract, a global
4-device mesh spanning both processes, per-process sharded input feed,
the decode graph under SPMD jit, and aggregate_metrics() psums that
actually cross a process boundary. Complements tests/test_multichip.py,
which covers the same APIs single-process on the virtual 8-device mesh
(there, initialize_distributed is only mock-tested).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(pid: int, port: int):
    env = dict(os.environ)
    # CPU backend only, deterministic local device count
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_NUM_CPU_DEVICES"] = "2"
    env["JAX_CPU_COLLECTIVES_IMPLEMENTATION"] = "gloo"
    env.pop("XLA_FLAGS", None)
    # the repo's documented multi-host env contract
    env["METERELF_DISTRIBUTED"] = "1"
    env["METERELF_COORDINATOR"] = f"127.0.0.1:{port}"
    env["METERELF_NUM_PROCS"] = "2"
    env["METERELF_PROC_ID"] = str(pid)
    worker = os.path.join(os.path.dirname(__file__), "dist_worker.py")
    return subprocess.Popen(
        [sys.executable, worker], env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_distributed_decode():
    port = _free_port()
    procs = [_spawn(0, port), _spawn(1, port)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=540)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    outs.sort(key=lambda r: r["process"])
    assert [r["process"] for r in outs] == [0, 1]
    assert all(r["n_devices"] == 4 for r in outs)

    # replicated aggregates must agree bit-for-bit across processes
    for key in ("n_ok", "n_err", "mean_value"):
        assert outs[0][key] == outs[1][key], key

    # recompute the same global batch single-process and compare
    from meterelf_jax import synthetic
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import MeterDecoder
    import tempfile

    positions = [
        [(pid * 4 + i + d * 1.7) % 10 for d in range(4)]
        for pid in range(2) for i in range(4)
    ]
    crops_c = jio.pack_crops(synthetic.render_crops(positions))
    dec = MeterDecoder(synthetic.make_params(tempfile.mkdtemp()),
                       exact=True)
    res = dec.decode_numpy(crops_c, np.ones(8, bool))

    got_vals = np.array(outs[0]["local"]["value"]
                        + outs[1]["local"]["value"])
    got_errs = np.array(outs[0]["local"]["err"] + outs[1]["local"]["err"])
    assert np.array_equal(got_errs, np.asarray(res.err))
    assert np.array_equal(got_vals, np.asarray(res.value))

    ok = np.asarray(res.err) == 0
    assert outs[0]["n_ok"] == int(ok.sum())
    assert outs[0]["n_err"] == int((~ok).sum())
    if ok.any():
        assert outs[0]["mean_value"] == pytest.approx(
            float(np.asarray(res.value)[ok].mean()))
