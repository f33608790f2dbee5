"""spcies_tpu — batched MPC solve engine for accelerators.

A JAX/XLA framework with the capabilities of the GepocUS/Spcies toolbox
(v0.3.11): first-order QP solvers (ADMM, EADMM, SADMM, FISTA) for the
laxMPC, equMPC, MPCT, ellipMPC, HMPC and ellipHMPC model predictive control
formulations.

Where the reference generates specialized embedded C per problem
(spcies_gen_controller.m), this framework computes the same solver
"ingredients" offline in fp64 numpy and traces the iteration into XLA
programs batched over thousands of independent MPC scenarios, sharded
across device meshes.

Public API:
    make_solver(sys, param, formulation=..., method=..., submethod=...,
                options=...) -> BatchedSolver
"""

__version__ = "0.1.0"

from spcies_tpu.config import (Options, Problem, default_options,
                               SOLVER_REGISTRY,
                               determine_formulation)
from spcies_tpu.api import make_solver
from spcies_tpu import systems
from spcies_tpu import formulations
from spcies_tpu import solvers
from spcies_tpu import kernels
from spcies_tpu import parallel
from spcies_tpu import oracle
from spcies_tpu import utils

__all__ = [
    "__version__",
    "Options",
    "Problem",
    "default_options",
    "SOLVER_REGISTRY",
    "determine_formulation",
    "make_solver",
    "systems",
    "formulations",
    "solvers",
    "kernels",
    "parallel",
    "oracle",
    "utils",
]
