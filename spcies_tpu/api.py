"""Public entry point: make_solver — the analogue of the reference's
spcies_gen_controller.m "generate a solver" flow, except the product is a
jit-compiled batched solve function instead of a C file.

The (formulation, method, submethod) -> builder dispatch mirrors the
reference's name-mangled `cons_*` eval dispatch
(spcies_gen_controller.m:111-130) via an explicit registry
(formulations.base.BUILDERS).
"""

from __future__ import annotations

import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from spcies_tpu.config import Options, default_options


def broadcast_inputs(dtype, *arrays, core_ndims=None):
    """Promote per-call inputs to batched [B, ...] jnp arrays; single
    problems (core-rank arrays) get a singleton batch dim. All inputs must
    agree on B.

    core_ndims: per-input rank of one problem's data (default 1 — vectors;
    matrix inputs like the time-varying solvers' A are rank 2)."""
    if core_ndims is None:
        core_ndims = (1,) * len(arrays)
    out = []
    B = None
    for a, cnd in zip(arrays, core_ndims):
        a = jnp.asarray(a, dtype)
        if a.ndim == cnd:
            a = a[None]
        elif a.ndim != cnd + 1:
            raise ValueError(
                f"input must have rank {cnd} (one problem) or {cnd + 1} "
                f"(batched); got rank {a.ndim}")
        if B is None:
            B = a.shape[0]
        elif a.shape[0] == 1 and B > 1:
            a = jnp.broadcast_to(a, (B,) + a.shape[1:])
        elif a.shape[0] != B:
            if B == 1:
                B = a.shape[0]
                out = [jnp.broadcast_to(o, (B,) + o.shape[1:]) for o in out]
            else:
                raise ValueError("inconsistent batch sizes in solver inputs")
        out.append(a)
    return out


class BatchedSolver:
    """A generated batched solver: callable with (x0, xr, ur[, warm start]).

    Plays the role of the reference's generated MEX/C solver function
    `<formulation>_<method>(x0, xr, ur, ...) -> (u_opt, k, e_flag, sol)`
    (header_laxMPC_ADMM_C.h:24-28), but batched: inputs may be [n] (single
    problem) or [B, n].
    """

    def __init__(self, solve_fn, ingredients: dict, options: Options,
                 *, n: int, m: int, N: int, nz: int, dtype,
                 input_names=("x0", "xr", "ur"), default_inputs=(),
                 input_core_ndims=None, input_kinds=None):
        self.ingredients = ingredients
        self.options = options
        self.n, self.m, self.N, self.nz = n, m, N, nz
        self.dtype = dtype
        self.input_names = input_names
        # trailing optional inputs (e.g. the soc solvers' runtime radius,
        # code_ellipMPC_ADMM_soc_C.c:20 r_ellip) with their default values
        self.default_inputs = tuple(default_inputs)
        self.input_core_ndims = (tuple(input_core_ndims)
                                 if input_core_ndims is not None
                                 else (1,) * len(input_names))
        # per-input unit kind for the in_engineering scaling
        # ('x' | 'u' | 'xu' | 'xa' | 'ua' | None), defaulting to the
        # (x0, xr, ur) signature (code_laxMPC_ADMM_C.c:82-115). 'xa'/'ua'
        # are sinusoid AMPLITUDES (harmonic sine/cosine components): they
        # scale by Nx/Nu but carry no operating-point offset — for
        # x_eng(t) = xre + xrs sin + xrc cos, the incremental signal is
        # Nx(xre - opx) + (Nx xrs) sin + (Nx xrc) cos.
        if input_kinds is None:
            input_kinds = tuple(
                {"x0": "x", "xr": "x", "ur": "u", "LB": "xu",
                 "UB": "xu", "xre": "x", "ure": "u", "xrs": "xa",
                 "xrc": "xa", "urs": "ua", "urc": "ua"}.get(name)
                for name in input_names)
        self.input_kinds = tuple(input_kinds)
        self.n_inputs = len(input_names)
        # solve_fn(*inputs, init, fixed_iters) with static fixed_iters
        self.raw_fn = solve_fn
        self._jitted = jax.jit(solve_fn, static_argnums=(self.n_inputs + 1,))

        # engineering-units scaling; populated by make_solver from sys
        # (reference Nx/Nu/x0/u0 fields, +sp_utils/scale_ss.m)
        self._Nx = np.ones(n)
        self._Nu = np.ones(m)
        self._opx = np.zeros(n)
        self._opu = np.zeros(m)

    def set_engineering(self, sys: dict):
        """Install scaling vectors / operating point for in_engineering mode
        (sys fields Nx, Nu, x0, u0; spcies_gen_controller sys conventions)."""
        n, m = self.n, self.m
        self._Nx = np.asarray(sys.get("Nx", np.ones(n)), float).ravel()
        self._Nu = np.asarray(sys.get("Nu", np.ones(m)), float).ravel()
        self._opx = np.asarray(sys.get("x0", np.zeros(n)), float).ravel()
        self._opu = np.asarray(sys.get("u0", np.zeros(m)), float).ravel()

    def _to_incremental(self, inputs):
        """Engineering -> incremental units: x = Nx*(x_eng - opx) etc.
        (code_laxMPC_ADMM_C.c:82-99; TIME_VARYING bounds :93-97)."""
        out = []
        for a, kind in zip(inputs, self.input_kinds):
            if kind == "x":
                a = self._Nx * (np.asarray(a, float) - self._opx)
            elif kind == "u":
                a = self._Nu * (np.asarray(a, float) - self._opu)
            elif kind == "xa":
                a = self._Nx * np.asarray(a, float)
            elif kind == "ua":
                a = self._Nu * np.asarray(a, float)
            elif kind == "xu":
                a = np.asarray(a, float)
                sc = np.concatenate([self._Nx, self._Nu])
                op = np.concatenate([self._opx, self._opu])
                a = sc * (a - op)
            out.append(a)
        return tuple(out)

    def __call__(self, *inputs, init=None, fixed_iters=None):
        # Phase timing (Options.timing, the reference's MEASURE_TIME
        # contract: update/solve/polish/run ms stamps around the solve —
        # snippets/get_elapsed_time.c:12-15, docs/timing.md). The hot loop
        # is one device dispatch, so 'solve' wraps dispatch +
        # block_until_ready; timing=False keeps dispatch fully async.
        timer = None
        if self.options.timing:
            from spcies_tpu.diagnostics.timing import PhaseTimer
            timer = PhaseTimer()
        if len(inputs) < self.n_inputs:
            missing = self.n_inputs - len(inputs)
            if missing > len(self.default_inputs):
                raise TypeError(
                    f"solver expects inputs {self.input_names}, "
                    f"got {len(inputs)}")
            inputs = inputs + self.default_inputs[-missing:]
        elif len(inputs) > self.n_inputs:
            raise TypeError(
                f"solver expects inputs {self.input_names}, got {len(inputs)}")
        if self.options.in_engineering:
            inputs = self._to_incremental(inputs)
        inputs = broadcast_inputs(self.dtype, *inputs,
                                  core_ndims=self.input_core_ndims)
        if timer is not None:
            timer.mark("update")
        # Full-f32 products at trace time: at the default precision a GPU
        # may run an f32 product in TF32 (about three decimal digits), and
        # any solver matmul with O(1) operands (e.g. HMPC's z @ C') then
        # floors the residual near 1e-3, so the iteration never meets tol.
        # The delta-form products (solvers.common.delta_dot) pin full f32
        # themselves; only bf16_delta asks for bf16 operands.
        with jax.default_matmul_precision("highest"):
            res = self._jitted(*inputs, init, fixed_iters)
        if timer is not None:
            res = jax.block_until_ready(res)
            timer.mark("solve")
        if self.options.in_engineering:
            # de-scale the control move (code_laxMPC_ADMM_C.c:642-651);
            # sol iterates stay in incremental units like the C DEBUG output
            import dataclasses as _dc
            res = _dc.replace(
                res, u=res.u / jnp.asarray(self._Nu, self.dtype)
                + jnp.asarray(self._opu, self.dtype))
        if timer is not None:
            timer.mark("polish")
            res.sol["times_ms"] = timer.finish()
        return res

    def solve(self, *inputs, **kw):
        return self(*inputs, **kw)

    def aot_memory_analysis(self, *inputs, init=None, fixed_iters=None):
        """AOT-compile the solve for the given (shapes of the) inputs and
        return XLA's memory analysis as a dict of byte counts
        (argument/output/temp/generated-code; peak = arg + out + temp -
        aliased) — a compile-time number from the real executable, not a
        count of ingredient array sizes. Returns None when the backend
        does not expose memory_analysis."""
        if len(inputs) < self.n_inputs:
            inputs = inputs + self.default_inputs[
                -(self.n_inputs - len(inputs)):]
        inputs = broadcast_inputs(self.dtype, *inputs,
                                  core_ndims=self.input_core_ndims)
        with jax.default_matmul_precision("highest"):
            lowered = self._jitted.lower(*inputs, init, fixed_iters)
        ma = lowered.compile().memory_analysis()
        if ma is None:
            return None
        try:
            out = dict(
                argument_bytes=int(ma.argument_size_in_bytes),
                output_bytes=int(ma.output_size_in_bytes),
                temp_bytes=int(ma.temp_size_in_bytes),
                alias_bytes=int(ma.alias_size_in_bytes),
                code_bytes=int(ma.generated_code_size_in_bytes),
            )
        except AttributeError:
            return None
        out["peak_bytes"] = (out["argument_bytes"] + out["output_bytes"]
                             + out["temp_bytes"] - out["alias_bytes"])
        return out


def make_solver(sys: dict, param: dict, *, formulation: str = "",
                method: str = "", submethod: str = "",
                options: Options | dict | None = None,
                backend: str = "dense", **solver_overrides) -> BatchedSolver:
    """Build a batched solver for the given system + MPC parameters.

    sys:   dict with A, B, LBx, UBx, LBu, UBu (reference `sys` struct)
    param: dict with the formulation's ingredients (Q, R, N, ...; reference
           `param` struct). If formulation is omitted it is auto-detected
           from the param fields (+sp_utils/determine_formulation.m).
    backend: one of the triple's backends (builder.backends: 'dense';
           'banded' where the triple has an O(N) path), or 'auto' to pick
           by a probe.
    """
    if not formulation and (options is None
                            or isinstance(options, dict)
                            or not options.formulation):
        from spcies_tpu.config import determine_formulation
        formulation = determine_formulation(param)
    if options is None:
        opt = default_options(formulation, method, submethod,
                              **solver_overrides)
    elif isinstance(options, dict):
        opt = Options(formulation=formulation, method=method,
                      submethod=submethod,
                      solver={**options, **solver_overrides})
    else:
        opt = options
        opt.formulation = opt.formulation or formulation
        if method:
            opt.method = method
        if submethod:
            opt.submethod = submethod
        opt.solver.update(solver_overrides)
        opt.resolve()

    if opt.precision == "double" and not jax.config.jax_enable_x64:
        raise ValueError(
            "precision='double' needs 64-bit floats, which JAX has off: "
            "enable them with jax.config.update('jax_enable_x64', True) "
            "(or JAX_ENABLE_X64=1) before building the solver, or pass "
            "precision='float'")
    from spcies_tpu.formulations.base import get_builder
    builder = get_builder(opt.formulation, opt.method, opt.submethod)
    if backend != "auto" and backend not in builder.backends:
        raise ValueError(
            f"{opt.formulation}/{opt.method}"
            f"{'-' + opt.submethod if opt.submethod else ''} has no backend "
            f"{backend!r}; its backends are {builder.backends} (or 'auto')")
    if backend == "auto":
        solver = _auto_backend(builder, sys, param, opt)
    else:
        solver = builder(sys, param, opt, backend=backend)
    if opt.in_engineering:
        solver.set_engineering(sys)
    return solver


def _auto_cache_path():
    import os
    from spcies_tpu.utils.compile_cache import CHECKOUT
    root = os.environ.get(
        "SPCIES_AUTO_CACHE_DIR",
        os.environ.get("JAX_COMPILATION_CACHE_DIR",
                       os.path.join(CHECKOUT, ".jax_cache")))
    return os.path.join(root, "spcies_auto_backend.json")


def _auto_cache_load():
    import json
    import os
    path = _auto_cache_path()
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def _auto_cache_store(key, backend):
    import json
    import os
    path = _auto_cache_path()
    cache = _auto_cache_load()
    cache[key] = backend
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(cache, f, indent=0, sort_keys=True)
    os.replace(tmp, path)


def _probe_inputs(solver, probe_b):
    """Zero inputs of the probe batch for every input with a unit kind;
    trailing unit-less inputs (e.g. the soc runtime radius) take their
    registered defaults."""
    inputs = []
    for kind in solver.input_kinds:
        if kind in ("x", "xa"):
            dim = solver.n
        elif kind in ("u", "ua"):
            dim = solver.m
        elif kind == "xu":
            dim = solver.n + solver.m
        else:
            break
        inputs.append(np.zeros((probe_b, dim), solver.dtype))
    missing = solver.n_inputs - len(inputs)
    return inputs + [
        jnp.broadcast_to(jnp.asarray(d, solver.dtype),
                         (probe_b,) + np.shape(d))
        for d in solver.default_inputs[len(solver.default_inputs)
                                       - missing:]]


def _auto_backend(builder, sys, param, opt) -> BatchedSolver:
    """backend='auto': build each backend the triple has (builder.backends)
    and pick the fastest by a short on-device probe (fixed-iteration
    batched solve, compile excluded). The dense affine map wins at short
    horizons and the O(N) banded paths pay off at long ones; where the
    crossover lies depends on the device. Probe knobs (solver options):
    auto_probe_batch (default 2048), auto_probe_iters (50),
    auto_probe_reps (3). The winning backend name lands in
    solver.backend_choice; per-candidate probe times in
    solver.backend_probe_s.

    The decision is persisted on disk, keyed by (triple, problem dims,
    device kind, probe config): a second make_solver(..., backend='auto')
    for the same shape — even in a fresh process — builds only the winning
    backend and skips the probe (solver.backend_probe_cached = True). Set
    auto_probe_batch to the production batch size to make the probe match
    the serving shape; pass auto_probe_refresh=True to force re-probing.
    Cache file: $SPCIES_AUTO_CACHE_DIR or $JAX_COMPILATION_CACHE_DIR or
    <checkout>/.jax_cache, spcies_auto_backend.json. Errors of a build or
    a probe propagate."""
    import time
    probe_b = int(opt.solver.get("auto_probe_batch", 2048))
    probe_iters = int(opt.solver.get("auto_probe_iters", 50))
    probe_reps = int(opt.solver.get("auto_probe_reps", 3))

    n_ = np.asarray(sys["A"]).shape[0]
    m_ = np.asarray(sys["B"]).shape[1]
    dev = jax.devices()[0]
    key = "|".join(map(str, (
        opt.formulation, opt.method, opt.submethod, n_, m_,
        int(param.get("N", 0)), opt.precision, int(opt.time_varying),
        int(bool(opt.debug)),
        dev.platform, getattr(dev, "device_kind", "?"),
        probe_b, probe_iters, probe_reps)))
    cached = (None if opt.solver.get("auto_probe_refresh", False)
              else _auto_cache_load().get(key))
    if cached in builder.backends:
        solver = builder(sys, param, opt, backend=cached)
        solver.backend_choice = cached
        solver.backend_probe_s = {}
        solver.backend_probe_cached = True
        return solver

    candidates = {be: builder(sys, param, opt, backend=be)
                  for be in builder.backends}
    times: dict[str, float] = {}
    if len(candidates) > 1:
        for be, solver in candidates.items():
            inputs = _probe_inputs(solver, probe_b)
            jax.block_until_ready(
                solver(*inputs, fixed_iters=probe_iters).u)
            reps = []
            for _ in range(probe_reps):
                t0 = time.perf_counter()
                jax.block_until_ready(
                    solver(*inputs, fixed_iters=probe_iters).u)
                reps.append(time.perf_counter() - t0)
            times[be] = sorted(reps)[len(reps) // 2]
        best = min(times, key=times.get)
    else:
        (best,) = candidates
    solver = candidates[best]
    solver.backend_choice = best
    solver.backend_probe_s = times
    solver.backend_probe_cached = False
    _auto_cache_store(key, best)
    return solver
