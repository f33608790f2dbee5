"""Multi-device scenario-batch sharding (single-process convenience path).

The reference is entirely serial (SURVEY.md §2.8 — one embedded problem per
binary, no MPI/NCCL). Here scenario-batch parallelism is first-class: the
batch dim shards over a `jax.sharding.Mesh` and fleet *metrics* (converged
counts, iteration histograms) are psum-reduced off the hot path.

NOTE on the hot loop: `sharded_solver` relies on jit auto-partitioning, so
in the default convergence-checked mode the masked loop's "any lane
active" test IS a per-iteration cross-device all-reduce (one bool per
device); only `fixed_iters` mode is collective-free here. The
production scale-out path is `parallel.distributed.shard_map_solver`,
which runs the whole loop per-shard (per-shard termination, zero
per-iteration collectives, identical per-lane results under freeze
semantics) and extends to multi-host (host x chip) meshes.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def batch_mesh(devices=None, axis_name: str = "batch") -> Mesh:
    """1-D mesh over all (or given) devices for scenario-batch sharding."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), (axis_name,))


def shard_batch(mesh: Mesh, *arrays, axis_name: str = "batch"):
    """Place [B, ...] arrays batch-sharded over the mesh."""
    sharding = NamedSharding(mesh, P(axis_name))
    return [jax.device_put(a, sharding) for a in arrays]


def sharded_solver(solver, mesh: Mesh, axis_name: str = "batch"):
    """Wrap a BatchedSolver so its inputs are batch-sharded over `mesh`.

    Because every per-lane update is independent, jit + sharded inputs is
    sufficient: XLA partitions the whole while-loop body across devices with
    no communication except the loop's any-active reduction (an all-reduce
    of one bool per device per iteration).
    """
    def solve(*inputs, **kw):
        inputs = [jnp.asarray(a, solver.dtype) for a in inputs]
        inputs = [a[None] if a.ndim == 1 else a for a in inputs]
        inputs = shard_batch(mesh, *inputs, axis_name=axis_name)
        return solver(*inputs, **kw)
    return solve


def fleet_metrics(result, mesh: Mesh | None = None):
    """Global solve metrics from a (possibly sharded) SolveResult: these are
    the psum-style reductions that replace the reference's per-solve timers
    (docs/timing.md) at fleet scale. Runs as a tiny jitted reduction over the
    sharded result arrays, so cross-device reduction happens via XLA
    collectives."""
    k = result.k
    e = result.e_flag
    return dict(
        n_lanes=int(k.shape[0]),
        n_converged=int(jnp.sum(e == 1)),
        k_mean=float(jnp.mean(k.astype(jnp.float32))),
        k_max=int(jnp.max(k)),
        k_min=int(jnp.min(k)),
    )
