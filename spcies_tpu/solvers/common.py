"""Shared solver result container and termination helpers."""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SolveResult:
    """Batched solve output, the analogue of the reference's
    (u_opt, k, e_flag, sol) C interface (header_laxMPC_ADMM_C.h:14-28).

    All arrays carry a leading batch dim B.
      u:      [B, m]  first control move (the reference's u_opt = v_0)
      k:      [B]     iterations performed per lane (int32)
      e_flag: [B]     1 = converged, -1 = k_max reached (int32)
      sol:    dict of final iterates / residuals (the DEBUG `sol` struct);
              always populated — it is free under jit.
    """

    u: jnp.ndarray
    k: jnp.ndarray
    e_flag: jnp.ndarray
    sol: dict[str, Any]


def inf_norm(x, axis=-1):
    """Per-lane infinity norm, the reference's residual metric
    (code_laxMPC_ADMM_C.c:570-620 early-break scan is equivalent)."""
    return jnp.max(jnp.abs(x), axis=axis)


def hist_sol_entries(hist):
    """Map recorded history traces to the reference's genHist-style sol
    field names (hRp/hRd at level 1; + hZ/hV/hLam at level 2)."""
    if not hist:
        return {}
    names = {"r_p": "hRp", "r_d": "hRd", "res": "hRes",
             "z": "hZ", "z_next": "hZ", "v": "hV", "lam": "hLam",
             "s": "hS", "mu": "hMu",
             "z1": "hZ1", "z2": "hZ2", "z3": "hZ3"}
    return {names.get(k, "h" + k): v for k, v in hist.items()}


def delta_dot(x, M):
    """x @ M for the delta-form products (z_{k+1} = z_k + M dq_k) in full
    f32. Each product's rounding error enters z and no later iteration
    removes it, so the errors add up over the iterations: with TF32
    operands (a GPU's default for f32 products) the headline's z ends
    about 8x further from the fp64 optimum than with f32 ones, and per-lane
    exits then depend on the GEMM algorithm XLA picks (PERF.md)."""
    import jax
    return jax.lax.dot(x, M, precision=jax.lax.Precision.HIGHEST)


def delta_dot_op(op, x):
    """Apply a linear operator to a delta in full f32 (the
    operator-callback form of delta_dot, for matrix-free ops like the
    stagewise G/G^T applies)."""
    import jax
    with jax.default_matmul_precision("highest"):
        return op(x)
