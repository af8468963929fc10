"""Multi-chip data-parallel sharding of the decode graph on the virtual
8-device CPU mesh (the one real parallelism axis for this workload —
SURVEY.md §2c: per-image decode is embarrassingly parallel; DP over
batch + psum-class collectives for aggregate metrics)."""
import numpy as np
import jax
import pytest

from meterelf_jax.parallel.mesh import (
    aggregate_metrics,
    data_parallel_decoder,
    initialize_distributed,
    make_mesh,
    shard_host_batch,
)

pytestmark = pytest.mark.needs_samples


def _cpu_devices():
    return jax.devices("cpu")


def test_eight_virtual_devices():
    assert len(_cpu_devices()) == 8


def test_sharded_decode_matches_single_device(params1, decoder1):
    from meterelf_jax.io import jpeg as jio
    from glob import glob

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[:16]
    crops, ok = jio.load_crops(files, params1.meter_rect, 16)

    res_single = decoder1.decode_numpy(crops, ok)

    mesh = make_mesh(_cpu_devices())
    sharded = data_parallel_decoder(decoder1, mesh)
    res_sharded = jax.tree.map(np.asarray, sharded(crops, ok))

    assert np.array_equal(res_single.err, res_sharded.err)
    assert np.array_equal(res_single.value, res_sharded.value)
    assert np.array_equal(res_single.dial_pos, res_sharded.dial_pos)
    assert np.array_equal(res_single.match_val, res_sharded.match_val)

    # cross-chip metric reduction over the sharded results: the psum
    # path must agree with a plain host-side reduction
    res = sharded(crops, ok)
    n_ok, n_err, mean_v = jax.tree.map(
        np.asarray,
        aggregate_metrics(res.value, res.err, mesh))
    errs = np.asarray(res.err)
    vals = np.asarray(res.value)
    ok_mask = errs == 0
    assert int(n_ok) == int(ok_mask.sum())
    assert int(n_err) == int((~ok_mask).sum())
    assert float(mean_v) == pytest.approx(
        float(vals[ok_mask].mean()) if ok_mask.any() else 0.0)


def test_aggregate_metrics_synthetic_values():
    """aggregate_metrics on hand-built shards (incl. an all-error case)."""
    mesh = make_mesh(_cpu_devices())
    vals = np.arange(16, dtype=np.float64)
    errs = np.zeros(16, np.int32)
    errs[3] = 2
    errs[11] = 4
    n_ok, n_err, mean_v = jax.tree.map(
        np.asarray, aggregate_metrics(vals, errs, mesh))
    ok = errs == 0
    assert (int(n_ok), int(n_err)) == (14, 2)
    assert float(mean_v) == pytest.approx(vals[ok].mean())

    all_err = np.full(16, 3, np.int32)
    n_ok, n_err, mean_v = jax.tree.map(
        np.asarray, aggregate_metrics(vals, all_err, mesh))
    assert (int(n_ok), int(n_err)) == (0, 16)
    assert float(mean_v) == 0.0  # guarded divide, not NaN


def test_host_sharded_input_feed(params1, decoder1):
    """shard_host_batch builds a mesh-spanning jax.Array from process-
    local crops; feeding it to the sharded decoder matches the numpy
    feed bit-for-bit."""
    from meterelf_jax.io import jpeg as jio
    from glob import glob

    files = sorted(glob("/root/reference/sample-images1/*.jpg"))[:8]
    crops, ok = jio.load_crops(files, params1.meter_rect, 8)

    mesh = make_mesh(_cpu_devices())
    arr = shard_host_batch(crops, mesh)
    assert len(arr.sharding.device_set) == 8
    # single process: local slice == global batch
    assert arr.shape == crops.shape

    sharded = data_parallel_decoder(decoder1, mesh)
    res_np = jax.tree.map(np.asarray, sharded(crops, ok))
    res_arr = jax.tree.map(np.asarray, sharded(arr, ok))
    assert np.array_equal(res_np.err, res_arr.err)
    assert np.array_equal(res_np.value, res_arr.value)


def test_initialize_distributed_is_gated(monkeypatch):
    """Without the flag, distributed bring-up is a no-op returning
    False — single-host runs never touch jax.distributed."""
    monkeypatch.delenv("METERELF_DISTRIBUTED", raising=False)
    called = []
    monkeypatch.setattr(
        jax.distributed, "initialize",
        lambda **kw: called.append(kw))
    assert initialize_distributed() is False
    assert called == []

    monkeypatch.setenv("METERELF_DISTRIBUTED", "1")
    monkeypatch.setenv("METERELF_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.setenv("METERELF_NUM_PROCS", "4")
    monkeypatch.setenv("METERELF_PROC_ID", "2")
    assert initialize_distributed() is True
    assert called == [{
        "coordinator_address": "10.0.0.1:8476",
        "num_processes": 4,
        "process_id": 2,
    }]
