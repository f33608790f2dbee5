"""Single-split ADMM engine.

The shared iteration skeleton of the reference's laxMPC/equMPC/ellipMPC/
MPCT-cs ADMM solvers (canonical version: code_laxMPC_ADMM_C.c:308-633):

    q_hat = q_ref + lambda - rho .* v          (dual-adjusted linear cost)
    z     = argmin_z 0.5 z'Hhat z + q_hat'z  s.t. G z = beq   (z_step)
    v     = proj(z + rho^{-1} .* lambda)                       (projection)
    lambda += rho .* (z - v)
    converged per-lane iff  ||z - v||_inf <= tol  (primal feasibility)
                        and ||v - v_prev||_inf <= tol  (fixed point)

The engine is generic over `z_step` (the equality-QP solve — dense affine
map or banded Alpha/Beta scan) and `proj` (box /
box+ellipsoid / cone projections), which is exactly the axis along which
the reference formulations differ.

Delta-form iteration (the fp32 enabler, on by default): the z-step is
affine in q_hat, so after one full solve the update can be computed
incrementally:

    dq_k  = rho.*(z_{k-1} - v_{k-1}) - rho.*(v_{k-1} - v_{k-2})
    z_k   = z_{k-1} + M_q dq_k

dq -> 0 as the iteration converges, so the linear-solve rounding error
scales DOWN with the residual instead of staying at eps*|q_hat| — without
this, fp32 stalls near ~1e-3 and can never meet the reference's 1e-4
tolerance contract (measured on the N=30 oscillating-masses benchmark).
Algebraically identical to the direct form; fp64 agreement with the
direct-form oracle stays at the 1e-9 differential-test level.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from spcies_tpu.solvers.common import inf_norm
from spcies_tpu.solvers.loop import run_masked_loop


def admm_solve(
    z_step: Callable,          # z_step(q_hat[B, nz]) -> z[B, nz] (affine, incl. beq term)
    proj: Callable,            # proj(y[B, nz]) -> v[B, nz]
    q_ref,                     # [B, nz] or [nz]
    rho,                       # scalar or [nz]
    rho_i,                     # scalar or [nz] (elementwise 1/rho)
    tol_p: float,
    tol_d: float,
    k_max: int,
    batch: int,
    nz: int,
    dtype,
    init=None,                 # optional (z0, v0, lam0) warm start
    fixed_iters: int | None = None,
    z_lin: Callable | None = None,  # linear part only: z_lin(dq) = M_q dq
    history: int = 0,          # genHist level: 1 = residual norms per
                               # iteration, 2 = + full z/v/lam traces
                               # (spcies_laxMPC_ADMM_solver.m genHist)
    relax_alpha: float = 1.0,  # over-relaxation (1 = plain ADMM; 1.5-1.8
                               # typically cuts iterations ~2x; opt-in —
                               # the reference has no relaxation, so
                               # iterate parity requires 1.0)
    freeze_converged: bool = True,  # False = free-running throughput mode:
                               # no per-lane freeze masking and a leaner
                               # carry (z output is the prepared iterate);
                               # per-lane k still records first tol hit
    straggler_polish: int = 0,  # extra compensated-f32x2 iterations for
                               # lanes that exhaust k_max (see below);
                               # 0 = off. k then counts TOTAL iterations
                               # and may exceed k_max for polished lanes.
):
    """Run batched single-split ADMM; returns (z, v, lam, k, e_flag, r_p, r_d).

    If `z_lin` is given the engine uses the delta-form iteration after the
    first (full) z-step; otherwise every iteration does the direct solve.

    relax_alpha != 1 applies standard over-relaxation: the z-iterate used
    in the v/dual updates is alpha*z + (1-alpha)*v_prev. Same fixed point
    (z* = v*), usually fewer iterations.
    """
    alpha = float(relax_alpha)
    if int(history) >= 2 and not freeze_converged:
        raise ValueError(
            "genHist level 2 (full iterate traces) requires "
            "freeze_converged=True — free-running lanes keep iterating "
            "past their recorded exit, so the traces would not match the "
            "returned per-lane solutions")
    if init is None:
        zeros = jnp.zeros((batch, nz), dtype=dtype)
        z0, v0, lam0 = zeros, zeros, zeros
    else:
        z0, v0, lam0 = init

    rinf = jnp.full((batch,), jnp.inf, dtype=dtype)

    if z_lin is not None:
        # Delta form: peel the single full equality-QP solve out of the
        # loop (a lax.cond inside the body would select between both
        # branches every iteration). The body consumes the z prepared by
        # the previous iteration and prepares the next one incrementally.
        z1 = z_step(q_ref + lam0 - rho * v0)
        # carry is deliberately minimal — the masked loop reads, writes
        # and mask-blends every leaf each iteration, so each extra [B, nz]
        # leaf costs 3x its size in device-memory traffic per iteration. In
        # free-running mode the consumed-z leaf is dropped entirely (the
        # returned z is then the prepared iterate, one solve fresher).
        state0 = dict(z_next=z1, v=v0, lam=lam0, r_p=rinf, r_d=rinf)
        if freeze_converged:
            state0["z"] = z1

        def body(state, _it):
            z = state["z_next"]
            v_prev = state["v"]
            zr = z if alpha == 1.0 else alpha * z + (1.0 - alpha) * v_prev
            v = proj(zr + rho_i * state["lam"])
            lam = state["lam"] + rho * (zr - v)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = jnp.logical_and(r_p <= tol_p, r_d <= tol_d)
            # prepare z for the NEXT iteration:
            # dq = (lam_k - lam_{k-1}) - rho (v_k - v_{k-1})
            dq = rho * (zr - v) - rho * (v - v_prev)
            z_next = z + z_lin(dq)
            out = dict(z_next=z_next, v=v, lam=lam, r_p=r_p, r_d=r_d)
            if freeze_converged:
                out["z"] = z
            return (out, conv)
    else:
        state0 = dict(z=z0, v=v0, lam=lam0, r_p=rinf, r_d=rinf)

        def body(state, _it):
            v_prev = state["v"]
            q_hat = q_ref + state["lam"] - rho * v_prev
            z = z_step(q_hat)
            zr = z if alpha == 1.0 else alpha * z + (1.0 - alpha) * v_prev
            v = proj(zr + rho_i * state["lam"])
            lam = state["lam"] + rho * (zr - v)
            r_p = inf_norm(z - v)
            r_d = inf_norm(v - v_prev)
            conv = jnp.logical_and(r_p <= tol_p, r_d <= tol_d)
            return dict(z=z, v=v, lam=lam, r_p=r_p, r_d=r_d), conv

    if history:
        keys = ("r_p", "r_d")
        if int(history) >= 2:
            keys += (("z", "v", "lam") if "z" in state0
                     else ("z_next", "v", "lam"))
        state, k, e_flag, hist = run_masked_loop(
            body, state0, k_max, batch, fixed_iters=fixed_iters,
            history_keys=keys, freeze=freeze_converged)
    else:
        state, k, e_flag = run_masked_loop(body, state0, k_max, batch,
                                           fixed_iters=fixed_iters,
                                           freeze=freeze_converged)
        hist = None
    z_out = state["z"] if "z" in state else state["z_next"]
    z_res, v_res, lam_res = z_out, state["v"], state["lam"]
    r_p_res, r_d_res = state["r_p"], state["r_d"]

    if straggler_polish and z_lin is not None and fixed_iters is None:
        # fp32 convergence-floor fix (VERDICT r4 next-#3): a small
        # fraction of hard states reach an fp32 fixed point where
        # accumulated quantization noise in the (z, lam) accumulators
        # floors max|z - v| just above tol (measured: frozen at
        # 1.0049e-4 for thousands of iterations while fp64 converges).
        # Lanes that exhaust k_max get a compensated continuation: z and
        # lam are carried as double-word f32 pairs (hi + lo), increments
        # accumulate through Knuth TwoSum so sub-ulp contributions are
        # retained, and the lo parts feed the projection argument and
        # the primal residual. Runs only when some lane failed
        # (lax.cond at batch granularity); converged lanes stay frozen.
        # Validated on the stalled state: compensated f32 converges in
        # ~1431 extra-precision iterations where plain f32 never exits
        # (fp64 reference: 1448). An f32 analogue of the reference C's
        # double math exit contract (code_laxMPC_ADMM_C.c:570-631).
        budget = int(straggler_polish)
        # The continuation must consume the PREPARED next iterate
        # (state['z_next']), not the consumed one — the delta-form
        # recursion z_{k+1} = z_k + M_q dq_k has already folded dq_k into
        # z_next, and seeding from the stale consumed z carries a
        # permanent -M_q dq offset: the continuation then converges to a
        # perturbed problem's fixed point while reporting e_flag=1
        # (review finding r05; reproduced at |z - z_ref| = 0.259).
        # Frozen (already-converged) lanes keep their consumed-z output
        # for bit-parity — they never iterate in the polish, so their
        # seed IS their output.
        z_prep = state["z_next"]
        e_mask = (e_flag == 1).reshape((batch,) + (1,) * (z_res.ndim - 1))
        z_seed = jnp.where(e_mask, z_res, z_prep)

        def _two_sum(a, b):
            s = a + b
            bp = s - a
            e = (a - (s - bp)) + (b - bp)
            return s, e

        def _polish(args):
            z0p, v0p, lam0p, k0p, e0p, rp0, rd0 = args
            done0 = e0p == 1
            lo0 = jnp.zeros_like(z0p)
            st0 = dict(z=z0p, z_lo=lo0, v=v0p, lam=lam0p, lam_lo=lo0,
                       r_p=rp0, r_d=rd0)

            def cond(carry):
                it, done = carry[0], carry[1]
                return jnp.logical_and(it < budget,
                                       jnp.logical_not(jnp.all(done)))

            def step(carry):
                it, done, k, st = carry
                z = st["z"]
                z_lo = st["z_lo"]
                v_prev = st["v"]
                lam = st["lam"]
                lam_lo = st["lam_lo"]
                zr = (z if alpha == 1.0
                      else alpha * z + (1.0 - alpha) * v_prev)
                zr_lo = z_lo if alpha == 1.0 else alpha * z_lo
                v = proj(zr + rho_i * lam + (zr_lo + rho_i * lam_lo))
                dlt = rho * (zr - v)
                lam_n, e1 = _two_sum(lam, dlt)
                lam_lo_n = lam_lo + (e1 + rho * zr_lo)
                # same residual convention as the main loop: primal
                # residual on the consumed (un-relaxed) z, here with its
                # low word restored
                r_p = inf_norm(z + z_lo - v)
                r_d = inf_norm(v - v_prev)
                conv = jnp.logical_and(r_p <= tol_p, r_d <= tol_d)
                dq = rho * (zr - v) - rho * (v - v_prev)
                z_n, e2 = _two_sum(z, z_lin(dq + rho * zr_lo))
                z_lo_n = z_lo + e2
                new = dict(z=z_n, z_lo=z_lo_n, v=v, lam=lam_n,
                           lam_lo=lam_lo_n, r_p=r_p, r_d=r_d)
                active = jnp.logical_not(done)
                st = jax.tree_util.tree_map(
                    lambda nw, old: jnp.where(
                        active.reshape((batch,) + (1,) * (nw.ndim - 1)),
                        nw, old), new, st)
                k = jnp.where(active, k + 1, k)
                done = jnp.logical_or(done,
                                      jnp.logical_and(active, conv))
                return (it + 1, done, k, st)

            _it, done, k, st = jax.lax.while_loop(
                cond, step, (jnp.int32(0), done0, k0p, st0))
            e = jnp.where(done, jnp.int32(1), jnp.int32(-1))
            return (st["z"] + st["z_lo"], st["v"],
                    st["lam"] + st["lam_lo"], k, e, st["r_p"], st["r_d"])

        args = (z_seed, v_res, lam_res, k, e_flag, r_p_res, r_d_res)
        noop = (z_res, v_res, lam_res, k, e_flag, r_p_res, r_d_res)
        (z_res, v_res, lam_res, k, e_flag, r_p_res, r_d_res) = jax.lax.cond(
            jnp.any(e_flag != 1), lambda a: _polish(a), lambda a: noop,
            args)

    return (z_res, v_res, lam_res, k, e_flag, r_p_res, r_d_res, hist)
