"""Benchmark: batched MPC solves/s of the dense XLA engine on one GPU.

Headline: laxMPC-ADMM on the oscillating-masses plant at N=30 (nz=240),
B=32,768 lanes, tol 1e-4, k_max 1000, rho 10, relax_alpha 1.9, fp32,
plain and with bf16_delta. Family matrix: the 13 solver triples
(spcies_tpu/systems/families.py) at the N=10 tester horizon and the N=30
metric horizon, B=8,192. Closed loop: closed_loop_rollout of the headline
configuration with cold, carried and shifted warm starts, B=4,096, 50
steps.

Each row times to-convergence solves (median of reps, each ending in
block_until_ready, compile excluded). Prints ONE JSON line naming the
device; exits non-zero without a GPU.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def _bench_solver(solver, args, reps=5):
    import jax
    res = jax.block_until_ready(solver(*args))
    n = args[0].shape[0]
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(solver(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return dict(solves_per_s=round(n / times[len(times) // 2], 1),
                solves_per_s_min=round(n / times[-1], 1),
                solves_per_s_max=round(n / times[0], 1),
                k_mean=round(float(np.mean(np.asarray(res.k))), 1),
                converged_frac=round(
                    float(np.mean(np.asarray(res.e_flag) == 1)), 4),
                batch=n)


def main():
    import jax
    import jax.numpy as jnp
    from spcies_tpu.utils.compile_cache import enable_compile_cache
    from spcies_tpu.runtime import closed_loop_rollout
    from spcies_tpu.systems import families

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"no GPU found (JAX's platform is {dev.platform!r})")

    def dev_put(arrays):
        return tuple(jax.device_put(jnp.asarray(a, jnp.float32))
                     for a in arrays)

    rows = {}
    head = next(c for c in families.cases(30) if c.name == "laxMPC-ADMM")
    args = dev_put(head.inputs(32768))
    for bf16 in (False, True):
        rows["headline" + ("-bf16" if bf16 else "")] = _bench_solver(
            head.make("dense", bf16_delta=bf16), args, reps=7)

    for N in (10, 30):
        for case in families.cases(N):
            rows[f"{case.name}@N{N}"] = _bench_solver(
                case.make("dense"), dev_put(case.inputs(8192)), reps=3)

    CLB, STEPS = 4096, 50
    x0, xr, ur = dev_put(head.inputs(CLB))
    solver = head.make("dense")
    A, B = np.asarray(head.sys["A"]), np.asarray(head.sys["B"])
    for label, ws in (("cold", False), ("carry", True), ("shift", "shift")):
        def roll():
            return jax.block_until_ready(closed_loop_rollout(
                solver, A, B, x0, xr, ur, n_steps=STEPS, warm_start=ws))
        out = roll()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = roll()
            times.append(time.perf_counter() - t0)
        ks = np.asarray(out["ks"])
        rows[f"closed-loop-{label}"] = dict(
            solves_per_s=round(CLB * STEPS / float(np.median(times)), 1),
            steps_per_s=round(STEPS / float(np.median(times)), 2),
            k_mean=round(float(np.mean(ks)), 1),
            k_mean_after_step0=round(float(np.mean(ks[1:])), 1),
            converged_frac=round(float(np.mean(
                np.asarray(out["e_flags"]) == 1)), 4),
            batch=CLB, n_steps=STEPS)

    headline = rows["headline"]
    print(json.dumps({
        "metric": ("laxMPC-ADMM solves/s (dense, osc-masses N=30, "
                   "B=32768, tol=1e-4)"),
        "value": headline["solves_per_s"],
        "unit": "solves/s",
        "device": dict(platform=dev.platform, kind=dev.device_kind,
                       count=len(jax.devices())),
        "rows": rows,
        "all_converged": all(r["converged_frac"] == 1.0
                             for r in rows.values()),
    }))


if __name__ == "__main__":
    main()
