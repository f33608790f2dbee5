"""Long-horizon bench: the O(N) structured ('banded') backends and their
O(log N)-depth associative-scan variants ('scan') vs the dense path at
N in {30, 120, 240, 480, 960} — throughput AND measured executable memory
(the dense-vs-structured crossover, with XLA's compiled memory analysis in
place of ingredient-byte counting; the regime the reference's
semiband/CSR-LDL machinery exists for,
compute_MPCT_ADMM_semiband_ingredients.m:163-227).

Also runs a time-varying section where every lane carries its own model:
backend 'banded' = online band-Cholesky factors [B, N, n, n]; backend
'dense' = tv_dense_w (per-lane dense W [B, Nn, Nn] + batched Cholesky).
The dense-TV path runs out of device memory at (B, N) points the banded
backend completes — the memory half of the O(N) claim.

Each (family, backend, N) cell runs in a FRESH SUBPROCESS, one after
another (the parent never touches JAX, so one process holds the card at a
time), so failures (incl. device OOM, recorded as infeasible=true) don't
poison later cells.
Throughput uses fixed_iters so all backends do identical iteration work.

    python tools/bench_longn.py [--out BENCH_LONGN.json]
    python tools/bench_longn.py --single FAMILY BACKEND N   # one cell
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# family: {backend: N list} + fixed solver kwargs. The N lists target the
# dense-vs-structured crossover question within a bounded compile budget:
# laxMPC sweeps the full horizon range; MPCT-cs confirms at two long
# horizons; semiband / HMPC-split at one; the TV family probes the
# per-lane-ingredient memory wall (tv_dense_w vs banded).
FAMILIES = {
    "laxMPC-ADMM": (dict(dense=(30, 120, 480, 960),
                         banded=(30, 480),
                         scan=(480, 960)),
                    dict(rho=15.0, tol=1e-4, k_max=1000)),
    "MPCT-ADMM-cs": (dict(dense=(480,), banded=(480,), scan=(480,)),
                     dict(rho=2.0, tol=1e-4, k_max=1000)),
    "MPCT-ADMM-semiband": (dict(dense=(480,), scan=(480,)),
                           dict(rho=0.5, tol_p=1e-4, tol_d=1e-4,
                                k_max=1000)),
    "HMPC-ADMM-split": (dict(dense=(480,), scan=(480,)),
                        dict(rho=2.0, sigma=20.0, tol_p=1e-4, tol_d=1e-4,
                             k_max=1000)),
    # time-varying, per-lane model matrices: 'dense' = tv_dense_w
    # ([B, Nn, Nn] per-lane W), 'banded' = online band factors
    "laxMPC-ADMM-tv": (dict(dense=(120, 240), banded=(120, 240)),
                       dict(rho=15.0, tol=1e-4, k_max=1000)),
    # r05: per-lane TV MPCT-cs through the O(N) block-tridiagonal banded
    # path - the structured-only regime; no dense
    # foil exists for this formulation (per-lane dense W would OOM at the
    # same cells the laxMPC TV rows measured)
    "MPCT-ADMM-cs-tv": (dict(banded=(120, 240)),
                        dict(rho=2.0, tol=1e-4, k_max=1000)),
}
ITERS = 100


def batch_for(N):
    """Scale the batch down with the horizon so per-cell work stays
    roughly constant and the structured backends are measured at
    realistic occupancy (solves/s is normalized by B anyway)."""
    return {30: 4096, 120: 4096, 240: 2048, 480: 1024, 960: 512}[N]


def run_single(family, backend, N):
    import time
    import numpy as np
    # persistent compile cache: each cell is a fresh process
    import jax
    from spcies_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import spcies_tpu as sp

    B = batch_for(N)
    sys_, param, st = sp.systems.tester_fixture()
    param = dict(param)
    param["N"] = N
    be_map, kw = FAMILIES[family]
    kw = dict(kw)
    be = {"scan": "banded"}.get(backend, backend)
    if backend == "scan":
        kw["band_parallel_scan"] = True
    tv = family.endswith("-tv")
    if tv and backend == "dense":
        kw["tv_dense_w"] = True
        be = "dense"

    def opts(f, m, sm=""):
        o = sp.default_options(f, m, sm, **kw)
        o.precision = "float"
        if tv:
            o.time_varying = True
        return o

    if family == "MPCT-ADMM-cs-tv":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
        make = lambda: sp.make_solver(
            sys_, param, formulation="MPCT", method="ADMM",
            submethod="cs", options=opts("MPCT", "ADMM", "cs"))
    elif family.startswith("laxMPC-ADMM"):
        make = lambda: sp.make_solver(
            sys_, param, formulation="laxMPC", method="ADMM",
            backend="banded" if (tv and be != "dense") else be,
            options=opts("laxMPC", "ADMM"))
    elif family == "MPCT-ADMM-cs":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
        make = lambda: sp.make_solver(
            sys_, param, formulation="MPCT", method="ADMM",
            submethod="cs", backend=be,
            options=opts("MPCT", "ADMM", "cs"))
    elif family == "MPCT-ADMM-semiband":
        param["T"] = 10.0 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
        make = lambda: sp.make_solver(
            sys_, param, formulation="MPCT", method="ADMM",
            submethod="semiband", backend=be,
            options=opts("MPCT", "ADMM", "semiband"))
    elif family == "HMPC-ADMM-split":
        param.pop("T", None)
        param["w"] = 3 * 1.627 * 0.2
        param["Te"] = 10 * N * np.asarray(param["Q"])
        param["Th"] = param["Te"]
        param["Se"] = np.asarray(param["R"]).copy()
        param["Sh"] = 0.5 * param["Se"]
        make = lambda: sp.make_solver(
            sys_, param, formulation="HMPC", method="ADMM",
            submethod="split", backend=be,
            options=opts("HMPC", "ADMM", "split"))

    live0 = sum(a.nbytes for a in jax.live_arrays())
    solver = make()
    ingredient_bytes = sum(a.nbytes for a in jax.live_arrays()) - live0
    rng = np.random.default_rng(0)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-1.5, 1.5, (B, 1))
    xr = np.tile(st["xr"], (B, 1))
    ur = np.tile(st["ur"], (B, 1))
    dev = lambda a: jax.device_put(jax.numpy.asarray(a, jax.numpy.float32))
    if tv:
        n, m = solver.n, solver.m
        A0 = np.asarray(sys_["A"], float)
        B0 = np.asarray(sys_["B"], float)
        # per-lane perturbed models (the per-lane-ingredient regime)
        scale = rng.uniform(0.97, 1.03, (B, 1, 1))
        A_l = np.tile(A0, (B, 1, 1)) * scale
        B_l = np.tile(B0, (B, 1, 1))
        Qd = np.tile(np.diag(np.asarray(param["Q"], float)), (B, 1))
        Rd = np.tile(np.diag(np.asarray(param["R"], float)), (B, 1))
        LB = np.tile(np.concatenate([sys_["LBx"], sys_["LBu"]]), (B, 1))
        UB = np.tile(np.concatenate([sys_["UBx"], sys_["UBu"]]), (B, 1))
        args = tuple(dev(a) for a in
                     (x0, xr, ur, A_l, B_l, Qd, Rd, LB, UB))
    else:
        args = (dev(x0), dev(xr), dev(ur))

    mem = (solver.aot_memory_analysis(*args, fixed_iters=ITERS)
           if (N >= 240 or tv) else None) or {}
    res = solver(*args, fixed_iters=ITERS)
    jax.block_until_ready(res.u)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = solver(*args, fixed_iters=ITERS)
        jax.block_until_ready(res.u)
        times.append(time.perf_counter() - t0)
    times.sort()
    dt = times[len(times) // 2]
    out = dict(
        family=family, backend=backend, N=N, batch=B, iters=ITERS,
        solves_per_s=round(B / dt, 1),
        solves_per_s_min=round(B / times[-1], 1),
        solves_per_s_max=round(B / times[0], 1),
        lane_iters_per_s=round(B * ITERS / dt, 1),
        ingredient_bytes=int(ingredient_bytes),
        mem_argument_bytes=mem.get("argument_bytes", -1),
        mem_output_bytes=mem.get("output_bytes", -1),
        mem_temp_bytes=mem.get("temp_bytes", -1),
        mem_peak_bytes=mem.get("peak_bytes", -1),
        platform=jax.devices()[0].platform,
        device_kind=jax.devices()[0].device_kind,
        device_count=len(jax.devices()),
    )
    print("RESULT " + json.dumps(out))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--single", nargs=3, metavar=("FAMILY", "BACKEND", "N"))
    args = ap.parse_args()
    if args.single:
        run_single(args.single[0], args.single[1], int(args.single[2]))
        return
    rows = []
    # resume: keep completed cells from a previous (interrupted) run and
    # write incrementally after every cell, so a timeout loses one cell
    done = set()
    if args.out and os.path.exists(args.out):
        try:
            with open(args.out) as f:
                rows = [r for r in json.load(f)["rows"] if "error" not in r]
            done = {(r["family"], r["backend"], r["N"]) for r in rows}
        except Exception:
            rows = []

    def flush():
        if args.out:
            with open(args.out, "w") as f:
                json.dump(dict(iters=ITERS, rows=rows), f, indent=1)

    for family, (be_map, _kw) in FAMILIES.items():
        for be, ns_list in be_map.items():
            for N in ns_list:
                if (family, be, N) in done:
                    continue
                try:
                    p = subprocess.run(
                        [sys.executable, os.path.abspath(__file__),
                         "--single", family, be, str(N)],
                        capture_output=True, text=True, timeout=2400)
                except subprocess.TimeoutExpired:
                    rows.append(dict(family=family, backend=be, N=N,
                                     error="timeout", infeasible=False))
                    print(f"{family:22s} {be:7s} N={N:4d}  TIMEOUT",
                          flush=True)
                    flush()
                    continue
                line = [ln for ln in p.stdout.splitlines()
                        if ln.startswith("RESULT ")]
                if p.returncode != 0 or not line:
                    full = (p.stderr or "") + (p.stdout or "")
                    err = full[-600:]
                    oom = any(mark in full for mark in (
                        "RESOURCE_EXHAUSTED", "Out of memory",
                        "ran out of memory", "Allocation type: HLO temp",
                        "exceeds the limit", "hbm"))
                    rows.append(dict(family=family, backend=be, N=N,
                                     batch=batch_for(N),
                                     infeasible=bool(oom), error=err[-400:]))
                    print(f"{family:22s} {be:7s} N={N:4d}  "
                          f"{'INFEASIBLE (OOM)' if oom else 'FAILED'}",
                          flush=True)
                    flush()
                    continue
                r = json.loads(line[0][len("RESULT "):])
                rows.append(r)
                print(f"{family:22s} {be:7s} N={N:4d}  "
                      f"{r['solves_per_s']:>10.1f} solves/s  "
                      f"peak={r['mem_peak_bytes']/1e6:.1f} MB",
                      flush=True)
                flush()
    if args.out:
        flush()
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
