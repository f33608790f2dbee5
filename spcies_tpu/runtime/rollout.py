"""On-device batched closed-loop rollout.

The reference's closed-loop demos step MATLAB <-> MEX once per control
period (examples/cl_in_C/main_cl_in_C.c:60-115 and
examples/t00_basic_tutorial.m:160-180). Here the entire receding
horizon loop — solve, apply first input, propagate the plant, warm-start
the next solve — runs as ONE jitted lax.scan over control steps, batched
over B independent closed loops, with zero host round trips.

This is the serving pattern for large-scale simulation studies (tuning
sweeps, Monte Carlo robustness runs): thousands of closed loops advance in
lockstep on-device, each warm-started from its own previous solution. The
warm-start slot itself is the reference's dead L_z2/L_z3 apparatus done
right (SURVEY.md §5 checkpoint/warm start): the C solvers always cold-start
at zero (code_laxMPC_ADMM_C.c:58-71); here the previous solution seeds the
next solve for free.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def shift_stagewise(arr, n: int, m: int, N: int, *, terminal: bool,
                    tail_x=None):
    """Receding-horizon shift of a stagewise decision/multiplier vector
    [B, nz] with the laxMPC/equMPC layout
    (u_0 | x_1 u_1 | ... | x_{N-1} u_{N-1} [| x_N]):
    advance every stage by one (the next solve's predicted trajectory is
    the previous one shifted), duplicate the last input, and fill the new
    terminal state with tail_x (default: the previous terminal state for
    terminal=True; the previous last predicted state for terminal=False).

    This is the standard warm-start shift the reference computed matrices
    for but never used (compute_MPCT_EADMM_ingredients.m:157-193); on the
    iterate triple (z, v, lam) it aligns every stage's primal AND active-
    set multiplier with where the receding horizon actually moved them.
    """
    u1 = arr[:, m + n:m + n + m]                     # next step's u_0
    mid = arr[:, m + (n + m):m + (N - 1) * (n + m)]  # stages 2..N-1 -> 1..N-2
    uNm1 = arr[:, m + (N - 2) * (n + m) + n:m + (N - 1) * (n + m)]
    if terminal:
        xN = arr[:, -n:]
        tail = xN if tail_x is None else jnp.broadcast_to(
            jnp.asarray(tail_x, arr.dtype), xN.shape)
        # new stage N-1 = (old x_N, old u_{N-1}); new terminal = tail
        return jnp.concatenate([u1, mid, xN, uNm1, tail], axis=-1)
    # no terminal block: new stage N-1 = (fill state, old u_{N-1})
    xNm1 = arr[:, m + (N - 2) * (n + m):m + (N - 2) * (n + m) + n]
    fill = xNm1 if tail_x is None else jnp.broadcast_to(
        jnp.asarray(tail_x, arr.dtype), xNm1.shape)
    return jnp.concatenate([u1, mid, fill, uNm1], axis=-1)


def shift_dual_stages(lam, n: int, N: int):
    """Shift a stage-blocked dual vector [B, N*n] (equality multipliers,
    the FISTA warm-start carry) by one stage, duplicating the last."""
    return jnp.concatenate([lam[:, n:], lam[:, -n:]], axis=-1)


def closed_loop_rollout(solver, A, B, x0, xr, ur, *, n_steps: int,
                        warm_start=True, process_noise=None):
    """Simulate n_steps of closed-loop MPC for a batch of initial states.

    solver: a BatchedSolver over the plain (x0, xr, ur) signature. ADMM
        family solvers (sol carries z, v, lam) warm-start on the full
        (z, v, lam) triple; FISTA solvers (sol carries z, lam) warm-start
        through the extrapolated dual only — both reproduce the receding-
        horizon pattern of tests/test_time_varying-style studies.
    warm_start: False = cold start every solve (the reference C behavior,
        code_laxMPC_ADMM_C.c:58-71); True = carry the previous solution
        unshifted; "shift" = receding-horizon shift (advance all iterates
        one stage, duplicate the tail) — requires the solver to expose a
        stagewise layout (solver.stage_layout, set by the laxMPC/equMPC
        builders).
    A, B: plant matrices used for propagation (may differ from the model
        the solver was built with — model-mismatch studies).
    x0 [Bz, n] initial states; xr [Bz, n], ur [Bz, m] references.
    process_noise: optional [n_steps, Bz, n] additive disturbance.

    Returns dict with xs [n_steps+1, Bz, n], us [n_steps, Bz, m],
    ks [n_steps, Bz], e_flags [n_steps, Bz].
    """
    A = jnp.asarray(A, solver.dtype)
    B = jnp.asarray(B, solver.dtype)
    x0 = jnp.atleast_2d(jnp.asarray(x0, solver.dtype))
    xr = jnp.broadcast_to(jnp.atleast_2d(jnp.asarray(xr, solver.dtype)),
                          (x0.shape[0], A.shape[0]))
    ur = jnp.broadcast_to(jnp.atleast_2d(jnp.asarray(ur, solver.dtype)),
                          (x0.shape[0], B.shape[1]))
    Bz = x0.shape[0]
    if process_noise is None:
        process_noise = jnp.zeros((n_steps, Bz, A.shape[0]), solver.dtype)
    else:
        process_noise = jnp.asarray(process_noise, solver.dtype)

    # Probe the solver's sol structure abstractly to size the warm-start
    # carry: ADMM lanes carry (z, v, lam) [B, nz] each; dual-FISTA lanes
    # carry the dual [B, N*n], a different width than nz.
    probe = jax.eval_shape(
        lambda x, r, u: solver.raw_fn(x, r, u, None, None), x0, xr, ur)
    sol_sh = probe.sol
    if "v" in sol_sh:
        keys = ("z", "v", "lam")
    else:
        keys = ("lam", "lam", "lam")
    init0 = tuple(jnp.zeros(sol_sh[k].shape, solver.dtype) for k in keys)

    if warm_start == "shift":
        layout = getattr(solver, "stage_layout", None)
        if layout is None:
            raise ValueError(
                "warm_start='shift' needs a solver with a stagewise "
                "decision layout (laxMPC/equMPC families); this solver "
                "does not expose stage_layout — use warm_start=True "
                "(unshifted carry) instead")
        _, terminal = layout
        n_, m_, N_ = solver.n, solver.m, solver.N
        if "v" in sol_sh:
            def carry_fn(res):
                return tuple(
                    shift_stagewise(res.sol[k], n_, m_, N_,
                                    terminal=terminal) for k in keys)
        else:
            def carry_fn(res):
                lam_s = shift_dual_stages(res.sol["lam"], n_, N_)
                return (lam_s, lam_s, lam_s)
    else:
        def carry_fn(res):
            return tuple(res.sol[k] for k in keys)

    # The jitted scan is cached ON THE SOLVER, keyed by the static
    # configuration, so repeated rollouts (tuning sweeps, benchmark reps)
    # reuse the compiled executable instead of re-tracing a fresh closure
    # each call. Dynamic data (x0, refs, plant, noise) are traced inputs.
    cache = solver.__dict__.setdefault("_rollout_jit_cache", {})
    key = (n_steps, warm_start, Bz, tuple(A.shape), tuple(B.shape))
    run = cache.get(key)
    if run is None:
        def step_fn(carry, w_t, xr, ur, A, B):
            x, init = carry
            res = solver.raw_fn(x, xr, ur, init, None)
            u = res.u
            x_next = x @ A.T + u @ B.T + w_t
            if warm_start:
                new_init = carry_fn(res)
            else:
                new_init = init
            return (x_next, new_init), (x_next, u, res.k, res.e_flag)

        @jax.jit
        def run(x0, xr, ur, A, B, noise, init0):
            # full-f32 matmul precision at trace time, as in
            # BatchedSolver.__call__: the scan calls solver.raw_fn
            # directly, and a reduced-precision product (TF32 on a GPU)
            # with O(1) operands stalls warm-started solves near tol and
            # erases the warm-start benefit.
            with jax.default_matmul_precision("highest"):
                (_, _), (xs, us, ks, es) = jax.lax.scan(
                    lambda c, w: step_fn(c, w, xr, ur, A, B), (x0, init0),
                    noise)
            return xs, us, ks, es

        cache[key] = run

    xs, us, ks, es = run(x0, xr, ur, A, B, process_noise, init0)
    return dict(
        xs=jnp.concatenate([x0[None], xs], axis=0),
        us=us, ks=ks, e_flags=es)
