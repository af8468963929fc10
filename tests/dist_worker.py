"""Worker for tests/test_distributed.py: one process of a 2-process
jax.distributed CPU cluster (gloo collectives, 2 local devices each).

Exercises the repo's real multi-host path — initialize_distributed()
via the METERELF_* env contract, a global make_mesh() spanning both
processes, shard_host_batch() from process-local synthetic crops,
data_parallel_decoder() over the global mesh, and aggregate_metrics()
psums riding the cross-process collectives. Prints one JSON line with
the replicated aggregates plus this process's local decode results.

Run via the parent test only: it needs the env vars set and a peer.
"""
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main() -> None:
    import numpy as np

    import jax

    from meterelf_jax.parallel.mesh import (
        aggregate_metrics,
        data_parallel_decoder,
        initialize_distributed,
        make_mesh,
        shard_host_batch,
    )
    from meterelf_jax import synthetic
    from meterelf_jax.io import jpeg as jio
    from meterelf_jax.pipeline.decode import MeterDecoder

    assert initialize_distributed() is True
    pid = jax.process_index()
    nproc = jax.process_count()
    assert nproc == 2, nproc

    mesh = make_mesh()
    n_global_devices = len(jax.devices())

    # deterministic global batch (positions AND render offsets depend on
    # the global index); each process keeps only its own local half, so
    # the parent can recompute the identical batch single-process
    positions = [
        [(p * 4 + i + d * 1.7) % 10 for d in range(4)]
        for p in range(nproc) for i in range(4)
    ]
    crops = synthetic.render_crops(positions)[pid * 4:(pid + 1) * 4]
    crops_c = jio.pack_crops(crops)

    params = synthetic.make_params(tempfile.mkdtemp())
    dec = MeterDecoder(params, exact=True)

    arr = shard_host_batch(crops_c, mesh)
    assert arr.shape[0] == crops_c.shape[0] * nproc  # global batch

    run = data_parallel_decoder(dec, mesh)
    ok = np.ones(crops_c.shape[0], bool)  # process-local flags
    res = run(arr, ok)

    n_ok, n_err, mean_v = aggregate_metrics(res.value, res.err, mesh)

    # this process's addressable slice of the sharded results
    local = {}
    for name in ("value", "err"):
        shards = sorted(
            getattr(res, name).addressable_shards,
            key=lambda s: s.index[0].start or 0)
        local[name] = np.concatenate(
            [np.asarray(s.data) for s in shards]).tolist()

    print(json.dumps({
        "process": pid,
        "n_devices": n_global_devices,
        "n_ok": int(n_ok),
        "n_err": int(n_err),
        "mean_value": float(np.asarray(mean_v)),
        "local": local,
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
