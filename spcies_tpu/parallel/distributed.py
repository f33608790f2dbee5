"""Multi-host runtime: distributed bring-up, host x chip meshes, and
shard_map-wrapped solves with per-shard termination.

The reference is single-process/single-thread (SURVEY.md §2.8 — no
MPI/NCCL anywhere); this module is the new-framework side of the
BASELINE "scaling efficiency at >= 2 hosts" contract. Design:

- `initialize()` wraps `jax.distributed.initialize` (idempotent; uses
  JAX's cluster auto-detection where the environment provides one,
  explicit coordinator address / process count / process id otherwise).
  After it, `jax.devices()` is the GLOBAL device list. XLA hands the
  collectives to NCCL on GPUs: over NVLink between the cards of a host,
  over the network between hosts.
- `host_chip_mesh()` builds a 2-D (host, chip) mesh from the global
  device list, so shardings can keep traffic inside a host and use the
  host axis only for what must cross hosts.
- `shard_map_solver()` wraps a BatchedSolver's jittable solve in
  `shard_map` over the batch axes: every device runs the ENTIRE masked
  while-loop on its local lane shard, so termination is per-shard and
  NO collective sits on the per-iteration critical path. (Plain jit
  auto-partitioning — parallel.mesh.sharded_solver — instead lowers the
  loop's any-active test to a per-iteration cross-device all-reduce.)
  With the default freeze semantics (solvers/loop.py) per-lane iterates,
  k and e_flag are bit-identical to the global loop: converged lanes are
  frozen, so where the loop stops only affects wasted work, not results.
- `global_fleet_metrics()` psum-reduces converged counts / iteration
  statistics over the whole mesh, off the hot path —
  the multi-host analogue of the reference's per-solve timers.

Multi-host bring-up (one process per host):

    import spcies_tpu as sp
    sp.parallel.initialize()                  # or explicit coordinator
    mesh = sp.parallel.host_chip_mesh()
    solver = sp.make_solver(...)
    solve = sp.parallel.shard_map_solver(solver, mesh)
    x0 = sp.parallel.from_process_local(mesh, x0_local)  # [B_global, n]
    res = solve(x0, xr, ur)
    print(sp.parallel.global_fleet_metrics(res))

A 2-process CPU smoke test of exactly this flow runs in CI
(tests/test_multiprocess.py) via Gloo collectives.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> bool:
    """Bring up the JAX distributed runtime (idempotent).

    With no arguments, relies on JAX's cluster auto-detection (Slurm,
    GKE, ...). Where nothing describes the cluster, as on a single
    machine with several cards, pass the coordinator address
    ('host:port'), the total process count and this process's id.
    Returns True if the runtime is (now) initialized for >1 process,
    False for the single-process no-op case.
    """
    from jax._src import distributed as _dist
    if _dist.global_state.client is not None:   # already initialized
        return jax.process_count() > 1
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        try:
            jax.distributed.initialize()
        except Exception:
            # no cluster environment detected -> single-process mode
            return False
        return jax.process_count() > 1
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    return jax.process_count() > 1


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_chip_mesh(axis_names: tuple[str, str] = ("host", "chip"),
                   devices=None) -> Mesh:
    """2-D (host, chip) mesh over the global device list: axis 0 is the
    process/host dimension, axis 1 the per-host devices. Works
    single-process too (host axis of size 1), so code written against
    this mesh runs unchanged from one card to several hosts."""
    if devices is None:
        devices = jax.devices()
    n_hosts = max(d.process_index for d in devices) + 1
    by_host: list[list] = [[] for _ in range(n_hosts)]
    for d in devices:
        by_host[d.process_index].append(d)
    n_local = len(by_host[0])
    if any(len(h) != n_local for h in by_host):
        raise ValueError("host_chip_mesh requires the same device count "
                         "on every host")
    grid = np.array([sorted(h, key=lambda d: d.id) for h in by_host])
    return Mesh(grid, axis_names)


def batch_spec(mesh: Mesh) -> P:
    """PartitionSpec sharding the leading batch dim over ALL mesh axes."""
    return P(tuple(mesh.axis_names))


def from_process_local(mesh: Mesh, local_array, global_batch: int | None = None):
    """Assemble a globally-sharded [B_global, ...] array from this
    process's local shard [B_local, ...] (multi-host input distribution:
    each host feeds its own scenarios; jax.make_array_from_process_local_data
    stitches the global view)."""
    local_array = np.asarray(local_array)
    if global_batch is None:
        global_batch = local_array.shape[0] * jax.process_count()
    sharding = NamedSharding(mesh, batch_spec(mesh))
    return jax.make_array_from_process_local_data(
        sharding, local_array, (global_batch,) + local_array.shape[1:])


def shard_map_solver(solver, mesh: Mesh, *, donate: bool = False):
    """Wrap a BatchedSolver in shard_map over `mesh`: per-device masked
    loops, per-shard termination, zero per-iteration collectives.

    Returns solve(*inputs, init=None, fixed_iters=None). Inputs must be
    [B_global, ...] arrays (already globally sharded, e.g. via
    from_process_local, or single-host numpy arrays which are placed
    batch-sharded automatically). B_global must divide evenly by the mesh
    size. Per-lane results match parallel.mesh.sharded_solver exactly
    under the default freeze semantics.
    """
    spec = batch_spec(mesh)
    n_in = solver.n_inputs
    sharding = NamedSharding(mesh, spec)

    @functools.lru_cache(maxsize=None)
    def _jitted(fixed_iters, with_init, n_init):
        def local(*args):
            if with_init:
                inputs, init = args[:n_in], args[n_in:]
            else:
                inputs, init = args, None
            return solver.raw_fn(*inputs, init, fixed_iters)
        n_args = n_in + (n_init if with_init else 0)
        # check_vma=False: the masked loop's zero-init carries are
        # axis-invariant constants joined against varying body outputs,
        # which the varying-manual-axes type check rejects; the program is
        # correct (fully batch-parallel, no cross-shard dataflow)
        fn = shard_map(local, mesh=mesh, in_specs=(spec,) * n_args,
                       out_specs=spec, check_vma=False)
        return jax.jit(fn)

    def solve(*inputs, init=None, fixed_iters=None):
        if len(inputs) < n_in and solver.default_inputs:
            missing = n_in - len(inputs)
            inputs = inputs + solver.default_inputs[-missing:]
        arrs = []
        for a, cnd in zip(inputs, solver.input_core_ndims):
            a = jnp.asarray(a, solver.dtype)
            if a.ndim == cnd:
                a = a[None]
            arrs.append(a)
        B = max(a.shape[0] for a in arrs)
        arrs = [jnp.broadcast_to(a, (B,) + a.shape[1:]) if a.shape[0] == 1
                and B > 1 else a for a in arrs]
        if B % mesh.size != 0:
            raise ValueError(
                f"global batch {B} must be divisible by mesh size "
                f"{mesh.size} for shard_map solves")
        arrs = [a if hasattr(a, "sharding") and a.sharding == sharding
                else jax.device_put(a, sharding) for a in arrs]
        args = tuple(arrs)
        with_init = init is not None
        n_init = len(init) if with_init else 0
        if with_init:
            init = tuple(jax.device_put(jnp.asarray(i, solver.dtype),
                                        sharding) for i in init)
            args = args + init
        fn = _jitted(fixed_iters, with_init, n_init)
        with jax.default_matmul_precision("highest"):
            return fn(*args)

    return solve


def global_fleet_metrics(result, mesh: Mesh | None = None):
    """Fleet metrics reduced over every device (and host) holding the
    result: converged count, iteration stats. Computed with a jitted
    global reduction, so on a multi-host mesh the reduction runs as XLA
    collectives and every process returns the same global values."""
    @jax.jit
    def _reduce(k, e):
        kf = k.astype(jnp.float32)
        return (jnp.sum((e == 1).astype(jnp.int32)), jnp.mean(kf),
                jnp.max(k), jnp.min(k))
    n_conv, k_mean, k_max, k_min = _reduce(result.k, result.e_flag)
    return dict(
        n_lanes=int(np.prod(result.k.shape)),
        n_converged=int(n_conv),
        k_mean=float(k_mean),
        k_max=int(k_max),
        k_min=int(k_min),
        n_hosts=jax.process_count(),
        n_devices=len(jax.devices()),
    )
