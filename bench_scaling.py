"""Scaling-efficiency harness (SURVEY.md §7 step 7 / BASELINE.json
">=80% scaling efficiency" contract): solves/s at 1 device vs an N-device
mesh, batch sharded through the production shard_map path
(parallel/distributed.py — per-shard termination, zero per-iteration
collectives).

The measured engine is the dense XLA loop in bench.py's headline
configuration (laxMPC-ADMM N=30, fp32), so the per-device number through
shard_map is comparable to the bench headline.

On a machine with several GPUs run as-is; without them, set
XLA_FLAGS=--xla_force_host_platform_device_count=N JAX_PLATFORMS=cpu to
validate the sharding path. CAUTION: virtual CPU "devices" share the
host's physical cores, so on a virtual mesh even the efficiency ratio is
bounded by core count, not by the sharding design — use it only to check
that the sharded program compiles, executes and partitions correctly;
efficiency claims require real devices. (The shard_map program inserts no
cross-device communication at all — see the no-collective HLO assertions
of tests/test_shard_map_solver.py — so the only scaling losses are
per-device dispatch overheads.)

Usage:
    python bench_scaling.py [--out SCALING.json] [--mode convergence|fixed]
Prints one JSON line per mesh size and optionally writes the full record.
"""

from __future__ import annotations

import json
import time

import numpy as np


def make_solver(N: int = 30):
    import spcies_tpu as sp
    from spcies_tpu.systems import families

    case = next(c for c in families.cases(N) if c.name == "laxMPC-ADMM")
    _, _, st = sp.systems.tester_fixture()
    return case.make("dense"), st


def run(solver, st, mesh_devices, batch_per_device=2048, iters=150,
        convergence=True):
    import jax
    import spcies_tpu as sp

    from jax.sharding import NamedSharding

    mesh = sp.parallel.batch_mesh(mesh_devices)
    solve = sp.parallel.shard_map_solver(solver, mesh)

    B = batch_per_device * len(mesh_devices)
    rng = np.random.default_rng(0)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    xr = np.tile(st["xr"], (B, 1))
    ur = np.tile(st["ur"], (B, 1))
    # device-resident, batch-sharded inputs placed once: the metric is
    # on-device solve throughput, not host-to-device transfer
    sharding = NamedSharding(mesh, sp.parallel.batch_spec(mesh))
    x0, xr, ur = (jax.device_put(
        jax.numpy.asarray(a, solver.dtype), sharding) for a in (x0, xr, ur))

    fixed = None if convergence else iters
    res = solve(x0, xr, ur, fixed_iters=fixed)
    jax.block_until_ready(res.u)
    n_conv = int(np.sum(np.asarray(res.e_flag) == 1)) if convergence else B
    reps = 3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = solve(x0, xr, ur, fixed_iters=fixed)
        jax.block_until_ready(res.u)
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    return B / dt, n_conv / B


def main(argv=None):
    import argparse
    import jax
    from spcies_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="write the scaling record to this JSON file")
    ap.add_argument("--mode", default="convergence",
                    choices=("fixed", "convergence"),
                    help="run-to-convergence (default, headline-comparable)"
                         " or fixed-iteration")
    ap.add_argument("--batch-per-device", type=int, default=32768,
                    help="lanes per device (default = bench.py headline "
                         "batch on one device)")
    args = ap.parse_args(argv)

    devs = jax.devices()
    conv = args.mode == "convergence"
    solver, st = make_solver()
    base, conv_frac = run(solver, st, devs[:1],
                          batch_per_device=args.batch_per_device,
                          convergence=conv)
    out = [dict(devices=1, solves_per_s=round(base, 1), efficiency=1.0,
                converged_frac=round(conv_frac, 4))]
    n = 2
    while n <= len(devs):
        r, cf = run(solver, st, devs[:n],
                    batch_per_device=args.batch_per_device,
                    convergence=conv)
        out.append(dict(devices=n, solves_per_s=round(r, 1),
                        efficiency=round(r / (n * base), 3),
                        converged_frac=round(cf, 4)))
        n *= 2
    for row in out:
        print(json.dumps(row))
    if args.out:
        record = dict(
            platform=devs[0].platform,
            device_kind=devs[0].device_kind,
            n_devices_available=len(devs),
            mode=args.mode,
            batch_per_device=args.batch_per_device,
            solver="laxMPC-ADMM osc-masses N=30 fp32, dense XLA loop",
            path="parallel.distributed.shard_map_solver",
            note=("virtual CPU devices share physical cores; efficiency "
                  "on a virtual mesh is core-bound, not a property of the "
                  "sharding (the compiled loop has no collectives)"
                  if devs[0].platform == "cpu" else
                  "device run"),
            results=out,
        )
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
