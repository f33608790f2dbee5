"""Smoke run of the batched MPC engine on an NVIDIA GPU.

    python chip_smoke.py           # P0-P4 on one card
    python chip_smoke.py --four    # the four-card path against one card

Drives the card only through spcies_tpu's public API and checks every
result against the fp64 oracle (spcies_tpu/oracle/dense.py), the golden
optima in tests/golden/, the same solve on the CPU, or the same solve on
one card. Each phase prints one line; a failed check raises, so the
script exits non-zero. The last line of standard output is the JSON
contract line {"ok": true, "device": {"platform": "gpu", "kind": ...,
"count": ...}}.

The CPU side (the fp64 oracle per lane, and the same fp32 solve of the
same lanes on the CPU that the card is held to) runs in worker processes
that never open the card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

HEADLINE = "laxMPC-ADMM"          # bench.py's headline triple
TOL = 1e-4
K_ORACLE = 10000                  # the families' oracle budget
KMEAN_SLACK = 0.05                # card k_mean vs the CPU fp32 k_mean
N_FIRST = 1024                    # lanes of that k_mean
Z_FLOOR = 1e-5                    # f32 rounding of two summation orders


def z_limit(cpu_gap: float) -> float:
    """The card's z gap to the fp64 oracle may be twice the CPU fp32
    solve's gap on the same lanes; where the solver runs the oracle's own
    iteration that gap is f32 rounding alone, and another summation order
    on the card may add a few times as much, hence the floor."""
    return max(2.0 * cpu_gap, Z_FLOOR)


class SmokeFailure(RuntimeError):
    """A phase's check failed."""


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def say(phase: str, **fields):
    """Print one phase line: its scalar fields, floats to 6 digits."""
    print(f"{phase} " + " ".join(
        f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in fields.items()
        if not isinstance(v, (dict, list, np.ndarray))), flush=True)


# ---------------------------------------------------------------------------
# CPU side: the fp64 oracle and the CPU fp32 solve, in CPU-only workers
# ---------------------------------------------------------------------------

def primal(sol):
    """The primal iterate of a solve's (or the oracle's) sol dict, every
    stage: z, or z1 for EADMM's three-block split."""
    return np.asarray(sol["z"] if "z" in sol else sol["z1"])


def _cpu_task(task):
    """("oracle", N, name, one lane's inputs, {}) -> the case's fp64
    oracle (u, k, e_flag, sol); ("fp32", N, name, lanes' inputs,
    overrides) -> k and z of the same dense fp32 solve on the CPU."""
    kind, N, name, inputs, overrides = task
    from spcies_tpu.systems import families
    case = next(c for c in families.cases(N) if c.name == name)
    if kind == "oracle":
        return case.oracle(*inputs)
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        res = case.make("dense", **overrides)(
            *(np.asarray(a, np.float32) for a in inputs))
        return dict(k=np.asarray(res.k), z=primal(res.sol))


def cpu_runs(tasks, workers: int = 0):
    """_cpu_task over tasks, in `workers` spawned processes (0 or 1: in
    this process)."""
    if workers <= 1:
        return [_cpu_task(t) for t in tasks]
    # the workers inherit JAX_PLATFORMS=cpu from the start, so not even a
    # re-import of the main module can reach for the card; they keep no
    # compile cache (a shared one may hold CPU code built for another host)
    env = {"JAX_PLATFORMS": "cpu", "JAX_ENABLE_COMPILATION_CACHE": "false"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            return pool.map(_cpu_task, tasks, chunksize=1)
    finally:
        for k, v in saved.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def oracle_tasks(N, name, inputs, lanes):
    return [("oracle", N, name, tuple(np.asarray(a[i], float)
                                      for a in inputs), {}) for i in lanes]


def references(N, name, inputs, lanes, workers=0, oracle=None,
               **overrides):
    """The fp64 oracle of `lanes` (unless given) and the CPU fp32 solve
    of the first N_FIRST lanes and of `lanes`: the CPU's k_mean there, and
    the largest z gap (every stage) of the CPU's lanes to the oracle."""
    n_first = min(N_FIRST, len(inputs[0]))
    sel = np.r_[np.arange(n_first), lanes]
    tasks = [("fp32", N, name, tuple(np.asarray(a)[sel] for a in inputs),
              overrides)]
    if oracle is None:
        tasks += oracle_tasks(N, name, inputs, lanes)
    out = cpu_runs(tasks, workers)
    oracle = out[1:] if oracle is None else oracle
    z_oracle = np.stack([primal(r[3]).astype(float) for r in oracle])
    cpu = out[0]
    return dict(oracle=oracle, z_oracle=z_oracle,
                cpu_k_mean=float(np.mean(cpu["k"][:n_first])),
                cpu_z_gap=float(np.max(np.abs(cpu["z"][n_first:]
                                              - z_oracle))))


def sample_lanes(B: int, n: int, seed: int = 1):
    return np.sort(np.random.default_rng(seed).choice(B, min(n, B),
                                                      replace=False))


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def timed_solves(solver, args, reps: int):
    """First call (compile + run) and the median of `reps` further solves,
    each ending in block_until_ready. Returns (result, median_s,
    compile_s)."""
    import jax
    t0 = time.perf_counter()
    res = jax.block_until_ready(solver(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = jax.block_until_ready(solver(*args))
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return res, med, max(first - med, 0.0)


def lane_stats(res):
    k = np.asarray(res.k)
    e = np.asarray(res.e_flag)
    return dict(conv=float(np.mean(e == 1)), k_mean=float(np.mean(k)),
                k_mean_first=float(np.mean(k[:N_FIRST])))


def check_kmean(name: str, k_mean_first: float, cpu_k_mean: float):
    """k_mean of the first N_FIRST lanes within KMEAN_SLACK of the same
    lanes' k_mean on the CPU."""
    rel = abs(k_mean_first - cpu_k_mean) / cpu_k_mean
    check(rel <= KMEAN_SLACK, f"{name}: k_mean {k_mean_first:.2f} is "
          f"{rel:.1%} from the CPU fp32 {cpu_k_mean:.2f} (limit "
          f"{KMEAN_SLACK:.0%})")
    return rel


def z_gap(res, lanes, z_ref):
    """Largest gap of the lanes' z (every stage) to z_ref."""
    return float(np.max(np.abs(primal(res.sol)[lanes] - z_ref)))


def to_dev(arrays, dtype):
    import jax
    import jax.numpy as jnp
    return tuple(jax.device_put(jnp.asarray(a, dtype)) for a in arrays)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    """P0: the card as JAX and nvidia-smi see it; exits on no GPU."""
    import jax
    devs = jax.devices()
    d = devs[0]
    say("P0", platform=d.platform, kind=repr(d.device_kind),
        count=len(devs), jax=jax.__version__,
        x64=bool(jax.config.jax_enable_x64))
    if d.platform != "gpu":
        raise SystemExit(f"no GPU found: JAX's default platform is "
                         f"{d.platform!r}; this smoke run does not fall "
                         f"back to it")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print("P0 nvidia-smi --query-gpu=name,power.limit:", flush=True)
    print(smi, flush=True)
    return dict(platform=d.platform, kind=d.device_kind, count=len(devs))


def phase_headline(B=32768, N=30, bf16=False, n_oracle=256, reps=5,
                   workers=0, oracle=None):
    """P1: the bench headline (laxMPC-ADMM, dense, fp32) at B lanes. z
    (every stage: u_0 sits on its bound at the headline) of n_oracle lanes
    is held to z_limit of the gap that the same CPU fp32 solve of those
    lanes shows to the fp64 oracle, and k_mean to the CPU's."""
    import jax.numpy as jnp
    from spcies_tpu.systems import families
    case = next(c for c in families.cases(N) if c.name == HEADLINE)
    inputs = case.inputs(B)
    solver = case.make("dense", bf16_delta=bf16)
    res, med, comp = timed_solves(solver, to_dev(inputs, jnp.float32), reps)
    st = lane_stats(res)
    ma = solver.aot_memory_analysis(*to_dev(inputs, jnp.float32))
    lanes = sample_lanes(B, n_oracle)
    ref = references(N, HEADLINE, inputs, lanes, workers, oracle,
                     bf16_delta=bf16)
    gap = z_gap(res, lanes, ref["z_oracle"])
    limit = z_limit(ref["cpu_z_gap"])
    out = dict(st, solves_per_s=B / med, compile_s=comp,
               peak_bytes=None if ma is None else ma["peak_bytes"],
               z_gap=gap, z_gap_limit=limit, cpu_z_gap=ref["cpu_z_gap"],
               cpu_k_mean_first=ref["cpu_k_mean"], oracle=ref["oracle"])
    tag = f"P1 bf16_delta={bf16}"
    out["k_mean_vs_cpu"] = (abs(st["k_mean_first"] - ref["cpu_k_mean"])
                            / ref["cpu_k_mean"])
    say(tag, **out)
    check(np.all(np.isfinite(primal(res.sol))), f"{tag}: non-finite z")
    check(st["conv"] == 1.0, f"{tag}: converged {st['conv']}")
    check_kmean(tag, st["k_mean_first"], ref["cpu_k_mean"])
    check(gap <= limit, f"{tag}: z gap to the fp64 oracle {gap:.3e} > "
          f"{limit:.3e} (CPU fp32 {ref['cpu_z_gap']:.3e})")
    return out


def phase_fp64(B=4096, Ns=(10, 30), n_oracle=128, workers=0,
               golden=True):
    """P2: precision='double' against the fp64 oracle and the golden
    optima. The card may sum in another order than the CPU, so a lane's
    exit iteration may move by one where a residual sits on the
    tolerance; iterates are compared on lanes whose k agrees."""
    import jax.numpy as jnp
    from spcies_tpu.systems import families
    out = {}
    for N in Ns:
        case = next(c for c in families.cases(N) if c.name == HEADLINE)
        inputs = case.inputs(B)
        solver = case.make("dense", precision="double", relax_alpha=1.0,
                           k_max=K_ORACLE)
        res = solver(*to_dev(inputs, jnp.float64))
        lanes = sample_lanes(B, n_oracle)
        ref = cpu_runs(oracle_tasks(N, HEADLINE, inputs, lanes), workers)
        k = np.asarray(res.k)[lanes]
        k_o = np.array([r[1] for r in ref])
        same = k == k_o
        gap = 0.0
        for j in np.flatnonzero(same):
            for key in ("z", "v", "lam"):
                gap = max(gap, float(np.max(np.abs(
                    np.asarray(res.sol[key][lanes[j]]) - ref[j][3][key]))))
        out[N] = dict(k_same=float(np.mean(same)), iterate_gap=gap,
                      dtype=str(res.u.dtype))
        say(f"P2 N={N}", **out[N])
        check(np.mean(same) >= 0.999 and np.all(np.abs(k - k_o) <= 1),
              f"P2 N={N}: k agrees on {np.mean(same):.4f} of lanes, "
              f"largest difference {np.max(np.abs(k - k_o))}")
        check(gap <= 1e-9, f"P2 N={N}: iterate gap {gap:.3e} > 1e-9")
    if golden:
        out["golden"] = golden_checks()
        say("P2 golden u* gaps", **{k: f"{v:.3e}" for k, v in
                                    out["golden"].items()})
    return out


GOLDEN = (
    # (golden module, vector, formulation, method, submethod, param edit,
    #  solver options at its test's settings, offset of u_0 in the golden
    #  vector's stage layout)
    ("laxmpc_admm_golden", "Z_OPT", "laxMPC", "ADMM", "", "T_diag",
     dict(rho=15.0, tol=1e-7, k_max=5000), 0),
    ("equmpc_golden", "Z_OPT", "equMPC", "ADMM", "", "no_T",
     dict(rho=15.0, tol=1e-7, k_max=5000), 0),
    ("ellipmpc_golden", "Z_OPT", "ellipMPC", "ADMM", "", "ellip",
     dict(rho=15.0, tol=1e-7, k_max=5000), 0),
    ("mpct_admm_cs_golden", "Z_OPT", "MPCT", "ADMM", "cs", "mpct",
     dict(rho=1e-2, tol=1e-7, k_max=5000), 12),
    ("mpct_eadmm_golden", "Z1_OPT", "MPCT", "EADMM", "", "mpct",
     dict(rho_base=2.0, rho_mult=20.0, tol=1e-7, k_max=5000), 6),
    ("hmpc_golden", "Z_OPT", "HMPC", "ADMM", "", "hmpc",
     dict(rho=2.0, sigma=20.0, tol_p=1e-7, tol_d=1e-7, k_max=5000), 0),
)


def _golden_param(edit, param, st):
    p = dict(param)
    if edit in ("T_diag", "ellip"):
        p["T"] = np.diag(np.sum(p["T"], axis=1))
    if edit == "ellip":
        p.update(P=np.eye(len(st["xr"])), c=st["xr"], r=0.0)
    if edit == "no_T":
        p.pop("T", None)
    if edit == "mpct":
        p["T"] = 10.0 * np.asarray(p["Q"])
        p["S"] = np.asarray(p["R"]).copy()
    if edit == "hmpc":
        p.pop("T", None)
        p["w"] = 3 * 1.627 * 0.2
        p["Te"] = 10 * p["N"] * np.asarray(p["Q"])
        p["Th"] = p["Te"]
        p["Se"] = np.asarray(p["R"]).copy()
        p["Sh"] = 0.5 * p["Se"]
    return p


def golden_checks():
    """u* of each golden optimum to 1e-6 (the BASELINE u* contract)."""
    import importlib
    import spcies_tpu as sp
    sys_, param, st = sp.systems.tester_fixture()
    gaps = {}
    for mod, vec, f, m, sm, edit, opts, at in GOLDEN:
        z_opt = getattr(importlib.import_module(f"tests.golden.{mod}"), vec)
        solver = sp.make_solver(sys_, _golden_param(edit, param, st),
                                formulation=f, method=m, submethod=sm,
                                **opts)
        res = solver(st["x"], st["xr"], st["ur"])
        check(int(res.e_flag[0]) == 1, f"golden {mod}: not converged")
        u = np.asarray(res.u[0])
        gap = float(np.max(np.abs(u - z_opt[at:at + len(u)])))
        check(gap <= 1e-6, f"golden {mod}: u* gap {gap:.3e} > 1e-6")
        gaps[mod] = gap
    return gaps


def phase_families(B=8192, N=30, n_oracle=64, reps=3, banded_N=120,
                   banded_B=4096, workers=0, names=None):
    """P3: every triple on the dense engine at N, fp32, held as P1 is to
    the CPU's k_mean and z gap; every triple with a banded backend also
    at banded_N against dense on the same inputs."""
    import jax.numpy as jnp
    from spcies_tpu.systems import families
    picked = [c for c in families.cases(N)
              if names is None or c.name in names]
    lanes = sample_lanes(B, n_oracle)
    runs = {}
    for case in picked:
        inputs = case.inputs(B)
        res, med, _ = timed_solves(case.make("dense"),
                                   to_dev(inputs, jnp.float32), reps)
        runs[case.name] = (inputs, res, med)
    # one pool for every triple's CPU side
    n_first = min(N_FIRST, B)
    sel = np.r_[np.arange(n_first), lanes]
    tasks = []
    for case in picked:
        inputs = runs[case.name][0]
        tasks += [("fp32", N, case.name,
                   tuple(np.asarray(a)[sel] for a in inputs), {})]
        tasks += oracle_tasks(N, case.name, inputs, lanes)
    out = cpu_runs(tasks, workers)
    rows = {}
    for t, case in enumerate(picked):
        _, res, med = runs[case.name]
        cpu, orc = out[t * (1 + len(lanes))], out[
            t * (1 + len(lanes)) + 1:(t + 1) * (1 + len(lanes))]
        z_o = np.stack([primal(r[3]).astype(float) for r in orc])
        cpu_gap = float(np.max(np.abs(cpu["z"][n_first:] - z_o)))
        st = lane_stats(res)
        row = dict(conv=st["conv"], k_mean=st["k_mean"],
                   k_mean_first=st["k_mean_first"], solves_per_s=B / med,
                   z_gap=z_gap(res, lanes, z_o), cpu_z_gap=cpu_gap)
        tag = f"P3 {case.name}"
        cpu_k = float(np.mean(cpu["k"][:n_first]))
        row["k_mean_vs_cpu"] = abs(st["k_mean_first"] - cpu_k) / cpu_k
        say(tag, **row)
        check(st["conv"] == 1.0, f"{tag}: converged {st['conv']}")
        check_kmean(tag, st["k_mean_first"], cpu_k)
        check(row["z_gap"] <= z_limit(cpu_gap), f"{tag}: z gap to the "
              f"fp64 oracle {row['z_gap']:.3e} > {z_limit(cpu_gap):.3e} "
              f"(CPU fp32 {cpu_gap:.3e})")
        rows[case.name] = row
    for case in families.cases(banded_N):
        if not case.banded or case.name not in rows:
            continue
        args = to_dev(case.inputs(banded_B), jnp.float32)
        rd, td, _ = timed_solves(case.make("dense"), args, reps)
        rb, tb, _ = timed_solves(case.make("banded"), args, reps)
        sd, sb = lane_stats(rd), lane_stats(rb)
        # the two z-steps round differently, so an exit may move where a
        # residual sits near the tolerance: mostly by one iteration, by up
        # to ten for FISTA's restarts (about 0.1% of lanes, on the CPU
        # too); lanes whose exits are at most one apart hold the same z to
        # about 10 tol
        dk = np.abs(np.asarray(rd.k) - np.asarray(rb.k))
        near = dk <= 1
        dz = np.max(np.abs(primal(rd.sol) - primal(rb.sol)), axis=1)
        row = dict(N=banded_N, dense_k_mean=sd["k_mean"],
                   banded_k_mean=sb["k_mean"],
                   dense_solves_per_s=banded_B / td,
                   banded_solves_per_s=banded_B / tb,
                   k_same=float(np.mean(dk == 0)),
                   k_within_1=float(np.mean(near)),
                   z_gap_within_1=float(np.max(dz[near], initial=0.0)),
                   z_gap=float(np.max(dz)))
        tag = f"P3 {case.name} banded"
        say(tag, **row)
        rel = abs(sb["k_mean"] - sd["k_mean"]) / sd["k_mean"]
        check(sd["conv"] == 1.0 and sb["conv"] == 1.0 and rel <= KMEAN_SLACK
              and row["k_within_1"] >= 0.99
              and row["z_gap_within_1"] <= 10 * TOL,
              f"{tag}: conv dense {sd['conv']} banded {sb['conv']}, k_mean "
              f"{rel:.1%} apart, exits within one on {row['k_within_1']:.4f}"
              f" of lanes, z gap there {row['z_gap_within_1']:.3e}")
        rows[case.name]["banded"] = row
    return rows


def stepwise_solves(solver, xs, xr, ur):
    """The shifted warm-start chain as one BatchedSolver call per step on
    the given states xs [steps, B, n]: the plain reference of
    closed_loop_rollout's solves. Returns us [steps, B, m], ks [steps,
    B]."""
    import jax.numpy as jnp
    from spcies_tpu.runtime.rollout import shift_stagewise
    _, terminal = solver.stage_layout
    # a cold start is the zero warm start the rollout's first step gets,
    # passed as arrays so that XLA folds no zeros into the first call only
    init = tuple(jnp.zeros((xs.shape[1], solver.nz), xs.dtype)
                 for _ in range(3))
    us, ks = [], []
    for x in xs:
        res = solver(x, xr, ur, init=init)
        us.append(np.asarray(res.u))
        ks.append(np.asarray(res.k))
        init = tuple(shift_stagewise(res.sol[key], solver.n, solver.m,
                                     solver.N, terminal=terminal)
                     for key in ("z", "v", "lam"))
    return np.stack(us), np.stack(ks)


def phase_closed_loop(B=4096, N=30, steps=50, reps=3):
    """P4: closed_loop_rollout with the shifted warm start, fp32. Its
    states follow x+ = A x + B u, and its solves equal one BatchedSolver
    call per step on the same states with the same shifted warm start
    (step 0 a cold solve): k lane by lane (the rule of P2: another GEMM
    may move an exit by one where a residual sits on the tolerance), u
    wherever it is off its bounds (on a bound it cannot tell two solves
    apart; at the headline u_0 always is)."""
    import jax
    import jax.numpy as jnp
    from spcies_tpu.runtime import closed_loop_rollout
    from spcies_tpu.systems import families
    case = next(c for c in families.cases(N) if c.name == HEADLINE)
    x0, xr, ur = to_dev(case.inputs(B), jnp.float32)
    solver = case.make("dense")
    A, Bm = np.asarray(case.sys["A"]), np.asarray(case.sys["B"])

    def roll():
        return jax.block_until_ready(closed_loop_rollout(
            solver, A, Bm, x0, xr, ur, n_steps=steps, warm_start="shift"))
    rolled = roll()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        rolled = roll()
        times.append(time.perf_counter() - t0)
    ks, es = np.asarray(rolled["ks"]), np.asarray(rolled["e_flags"])
    us = np.asarray(rolled["us"])
    conv = float(np.mean(es == 1))
    xs = np.asarray(rolled["xs"])
    dx = float(np.max(np.abs(xs[1:] - (xs[:-1] @ A.T + us @ Bm.T))))
    us_ref, ks_ref = stepwise_solves(solver, jnp.asarray(xs[:-1]), xr, ur)
    dk = np.abs(ks - ks_ref)
    free = np.all((us_ref > np.asarray(case.sys["LBu"]) + 1e-3)
                  & (us_ref < np.asarray(case.sys["UBu"]) - 1e-3), axis=2)
    du = float(np.max(np.abs(us - us_ref).max(axis=2)[free & (dk == 0)],
                      initial=0.0))
    out = dict(conv=conv, k_mean_after_step0=float(np.mean(ks[1:])),
               steps_per_s=None if not times else steps / np.median(times),
               step0_k_mean=float(np.mean(ks[0])),
               k_same=float(np.mean(dk == 0)), x_step_gap=dx,
               u_pairs_off_bounds=int(np.sum(free)), u_gap_off_bounds=du)
    say("P4 closed-loop shift", **out)
    check(conv == 1.0, f"P4: converged {conv}")
    check(dx <= 1e-6 and np.mean(dk == 0) >= 0.999 and np.all(dk <= 1)
          and np.sum(free) >= B and du <= 1e-5,
          f"P4: vs single solves on the rollout's states: x step gap "
          f"{dx:.3e}, k same on {np.mean(dk == 0):.4f} of (step, lane) "
          f"pairs, largest difference {np.max(dk)}, u gap {du:.3e} on "
          f"{np.sum(free)} pairs off the bounds")
    return out


def phase_four(B_card=32768, B64_card=4096, reps=3, n_dev=4):
    """--four: shard_map_solver over a host_chip_mesh and sharded_solver
    over a batch_mesh of n_dev cards against the same global batch solved
    on one card, fp32 and an fp64 repeat: per-lane k and e_flag equal, z
    (every stage) to 1e-6 in fp32 and bit for bit in fp64."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import NamedSharding
    import spcies_tpu as sp
    from spcies_tpu.systems import families
    devs = jax.devices()[:n_dev]
    check(len(devs) == n_dev, f"--four needs {n_dev} devices, "
          f"found {len(jax.devices())}")
    case = next(c for c in families.cases(30) if c.name == HEADLINE)
    hc = sp.parallel.host_chip_mesh(devices=devs)
    bm = sp.parallel.batch_mesh(devs)
    out = {}
    for precision, per_card in (("float", B_card), ("double", B64_card)):
        dtype = jnp.float32 if precision == "float" else jnp.float64
        Bg = n_dev * per_card
        inputs = case.inputs(Bg)
        solver = case.make("dense", precision=precision)
        one = tuple(jax.device_put(jnp.asarray(a, dtype), devs[0])
                    for a in inputs)
        r1, t1, _ = timed_solves(solver, one, reps)
        sm = sp.parallel.shard_map_solver(solver, hc)
        r4, t4, _ = timed_solves(sm, inputs, reps)
        rs, ts, _ = timed_solves(sp.parallel.sharded_solver(solver, bm),
                                 inputs, reps)
        row = dict(lanes=Bg, solves_per_s_1=Bg / t1,
                   solves_per_s_shard_map=Bg / t4,
                   solves_per_s_sharded=Bg / ts)
        for tag, r in (("shard_map", r4), ("sharded", rs)):
            n_devs = len(r.u.sharding.device_set)
            check(n_devs == n_dev, f"--four {tag}: result on {n_devs} "
                  f"devices")
            same_k = np.array_equal(np.asarray(r.k), np.asarray(r1.k))
            same_e = np.array_equal(np.asarray(r.e_flag),
                                    np.asarray(r1.e_flag))
            dz = float(np.max(np.abs(np.asarray(r.sol["z"])
                                     - np.asarray(r1.sol["z"]))))
            tol = 1e-6 if precision == "float" else 0.0
            row[tag] = dict(devices=n_devs, k_equal=same_k,
                            e_equal=same_e, z_gap=dz)
            say(f"FOUR {precision} {tag}", **row[tag])
            check(same_k and same_e and dz <= tol,
                  f"--four {tag} {precision}: k equal {same_k}, e_flag "
                  f"equal {same_e}, z gap {dz:.3e} (limit {tol})")
        spec = sp.parallel.batch_spec(hc)
        fn = shard_map(lambda a, b, c: solver.raw_fn(a, b, c, None, None),
                       mesh=hc, in_specs=(spec,) * 3, out_specs=spec,
                       check_vma=False)
        args = [jax.device_put(jnp.asarray(a, dtype),
                               NamedSharding(hc, spec)) for a in inputs]
        with jax.default_matmul_precision("highest"):
            hlo = jax.jit(fn).lower(*args).compile().as_text()
        loop = hlo[hlo.find("while"):] if "while" in hlo else hlo
        found = [c for c in ("all-reduce", "all-gather",
                             "collective-permute", "reduce-scatter",
                             "all-to-all") if c in loop]
        row["loop_collectives"] = found
        say(f"FOUR {precision}", **row,
            collectives_in_loop=",".join(found) or "none")
        check(not found, f"--four: collectives in the shard_map loop: "
              f"{found}")
        out[precision] = row
    return out


def contract_line(dev: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its one-card "
                         "comparison")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from spcies_tpu.utils.compile_cache import enable_compile_cache

    dev = phase_device()
    print(f"P0 compile cache: {enable_compile_cache()}", flush=True)
    workers = min(16, os.cpu_count() or 1)

    if args.four:
        phase_four()
        print(contract_line(dict(dev, count=4)))
        return 0

    oracle = None
    for bf16 in (False, True):
        oracle = phase_headline(bf16=bf16, workers=workers,
                                oracle=oracle)["oracle"]
    phase_fp64(workers=workers)
    phase_families(workers=workers)
    phase_closed_loop()
    print(contract_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
