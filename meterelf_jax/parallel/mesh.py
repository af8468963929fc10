"""Multi-chip / multi-host scaling: SPMD data parallelism over a device
mesh.

The reference has no parallelism at all (SURVEY.md §2c) — one process,
one image at a time. The scaling model for this workload is pure data
parallelism: per-image decode has zero cross-image communication, so
the batch dim is sharded over a 1-D mesh with `jax.sharding` + jit, and
collectives are only needed for aggregate metrics (psums, which XLA
hands to NCCL on GPUs: over NVLink between the cards of one host, over
the network between hosts). Every card reaches every other at the same
rate, so the mesh follows the algorithm alone. TP/PP/SP/EP are
deliberately NOT implemented: there is no model to shard — documenting
that is part of the design.

Multi-host deployment shape: each host runs the same program,
`initialize_distributed()` joins the jax.distributed cluster (gated by
METERELF_DISTRIBUTED so single-host use never touches it), `make_mesh()`
spans the GLOBAL device set, each host JPEG-decodes only its own slice
of the batch and contributes it via `shard_host_batch()` — input IO
scales linearly with hosts and no crop ever crosses between hosts; only
the psum-class metric reductions do.
"""
from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join a multi-host jax.distributed cluster; returns whether the
    cluster was initialized.

    No-op (returns False) unless METERELF_DISTRIBUTED=1 or an explicit
    coordinator_address is given, so single-host runs never pay for or
    depend on distributed bring-up. The three parameters come from the
    arguments or from METERELF_COORDINATOR / METERELF_NUM_PROCS /
    METERELF_PROC_ID; nothing detects a GPU cluster by itself, so they
    must all be given. After initialization jax.devices() is the global
    device set, so `make_mesh()` transparently becomes process-aware.
    """
    if os.environ.get("METERELF_DISTRIBUTED") != "1" \
            and coordinator_address is None:
        return False
    if coordinator_address is None:
        coordinator_address = os.environ.get("METERELF_COORDINATOR")
    if num_processes is None and os.environ.get("METERELF_NUM_PROCS"):
        num_processes = int(os.environ["METERELF_NUM_PROCS"])
    if process_id is None and os.environ.get("METERELF_PROC_ID"):
        process_id = int(os.environ["METERELF_PROC_ID"])
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_mesh(devices: Optional[Sequence] = None, axis: str = "data") -> Mesh:
    """1-D mesh over all (or given) devices.

    After `initialize_distributed()`, jax.devices() is the global,
    cross-process device set — the mesh spans every chip in the cluster
    and jit partitions automatically (SPMD: each process executes its
    addressable shard)."""
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (axis,))


def shard_host_batch(local_crops: np.ndarray, mesh: Mesh,
                     axis: str = "data") -> jax.Array:
    """Per-host sharded input feed: build a globally-sharded device
    array from this process's local slice of the batch.

    Each host JPEG-decodes only global_batch/num_processes images; the
    resulting jax.Array spans the mesh without any host ever
    materializing (or sending) another host's crops. On a
    single process this is equivalent to device_put with batch
    sharding."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_process_local_data(sharding, local_crops)


def data_parallel_decoder(decoder: "MeterDecoder", mesh: Mesh,
                          axis: str = "data") -> Callable:
    """Wrap a MeterDecoder so batches are sharded over the mesh's data
    axis. Global batch size must be divisible by the mesh size. Results
    come back with the same batch-dim sharding (host gathers lazily).

    Accepts pre-sharded jax.Arrays from `shard_host_batch`, or host
    numpy batches holding this process's LOCAL slice (multi-process jit
    rejects numpy args with non-trivial shardings, so they are lifted
    via `shard_host_batch` here; single-process, local == global and
    the behavior is unchanged)."""
    from ..pipeline.decode import _decode_batch
    import functools

    batch_sharding = NamedSharding(mesh, P(axis))
    replicated = NamedSharding(mesh, P())

    # the decoder's static configuration (stats bounding box, sum dtype):
    # each shard runs the same graph as the single-card decoder
    fn = jax.jit(
        functools.partial(_decode_batch, **decoder._static_kwargs),
        in_shardings=(replicated, batch_sharding, batch_sharding),
        out_shardings=batch_sharding,
    )

    def run(crops_u8, load_ok=None):
        nproc = jax.process_count()
        if isinstance(crops_u8, np.ndarray):
            local_n = crops_u8.shape[0]
            crops_u8 = shard_host_batch(crops_u8, mesh, axis)
        else:  # global jax.Array, equal split across processes
            local_n = crops_u8.shape[0] // nproc
        if load_ok is None:
            load_ok = np.ones(local_n, bool)
        if isinstance(load_ok, np.ndarray):
            assert load_ok.shape[0] == local_n, (
                f"load_ok holds {load_ok.shape[0]} flags, expected the "
                f"process-local batch of {local_n}")
            load_ok = shard_host_batch(load_ok, mesh, axis)
        assert crops_u8.shape[0] % mesh.size == 0, (
            f"batch {crops_u8.shape[0]} not divisible by mesh size {mesh.size}")
        return fn(decoder.param_arrays, crops_u8, load_ok)

    return run


class MeshDecoder:
    """Drop-in stream decoder running batches data-parallel over a mesh.

    Wraps a single-chip MeterDecoder with `data_parallel_decoder` so the
    streaming pipeline (stream.py) can scale across chips with no other
    change: `__call__` shards the batch over the mesh's data axis,
    `aggregate` reduces per-batch metrics with psum-class collectives,
    and `rescue_numpy` delegates
    the rare CCL-rescue re-decode to the wrapped single-chip decoder on
    gathered host arrays (rescue is a host-coordinated slow path; it is
    not worth sharding)."""

    def __init__(self, decoder, mesh: Mesh, axis: str = "data") -> None:
        self.inner = decoder
        self.mesh = mesh
        self.axis = axis
        self._run = data_parallel_decoder(decoder, mesh, axis)

    def __call__(self, crops_u8, load_ok=None):
        return self._run(crops_u8, load_ok)

    def aggregate(self, res: "BatchResult") -> tuple:
        """(n_ok, n_err, mean value over ok) for one batch's sharded
        results, reduced across the mesh on device."""
        return aggregate_metrics(res.value, res.err, self.mesh, self.axis)

    def rescue_numpy(self, crops_u8: np.ndarray,
                     res: "BatchResult") -> "BatchResult":
        import jax as _jax

        return self.inner.rescue_numpy(
            np.asarray(crops_u8), _jax.tree.map(np.asarray, res))


class MeshCoefStep:
    """Mesh-sharded coefficient-feed step: wraps the jitted function of
    pipeline.decode.make_coef_decode_fn so the batch-dim feed arrays
    (coefficient planes, quant tables, load flags) are sharded over the
    mesh's data axis while the params and the (tiny, <= fb_slots)
    pixel-fallback scatter payload stay replicated — the full
    bytes-to-readings production shape across chips. The fallback
    scatter indexes global batch rows; SPMD partitioning handles the
    cross-shard writes (at most fb_slots rows per batch)."""

    def __init__(self, step, mesh: Mesh, axis: str = "data") -> None:
        batch = NamedSharding(mesh, P(axis))
        repl = NamedSharding(mesh, P())
        self.mesh = mesh
        self.axis = axis
        self._fn = jax.jit(
            step,
            in_shardings=(repl, batch, batch, batch, batch, batch,
                          repl, repl),
            out_shardings=batch,
        )

    def __call__(self, pa, cy, cb, cr, qt, ok, fb_packed, fb_idx):
        def lift(a):
            return shard_host_batch(np.asarray(a), self.mesh, self.axis)

        return self._fn(pa, lift(cy), lift(cb), lift(cr), lift(qt),
                        lift(ok), np.asarray(fb_packed),
                        np.asarray(fb_idx))

    def aggregate(self, res: "BatchResult") -> tuple:
        return aggregate_metrics(res.value, res.err, self.mesh, self.axis)


def aggregate_metrics(values: jax.Array, err: jax.Array, mesh: Mesh,
                      axis: str = "data") -> tuple:
    """Cross-chip aggregate statistics via psum-class collectives:
    (n_ok, n_err, mean value over ok) — the metric-reduction path for
    streaming deployments. Inputs are batch-sharded, outputs
    replicated."""
    import jax.numpy as jnp
    from jax import shard_map

    def agg(v, e):
        ok = (e == 0)
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.int32)), axis)
        n_err = jax.lax.psum(jnp.sum((~ok).astype(jnp.int32)), axis)
        s = jax.lax.psum(jnp.sum(jnp.where(ok, v, 0.0)), axis)
        return n_ok, n_err, s / jnp.maximum(n_ok, 1)

    sharded = shard_map(
        agg, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=(P(), P(), P()),
    )
    return sharded(values, err)
