"""Tests that need the card. On a GPU:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import numpy as np
import pytest

import jax.numpy as jnp

from spcies_tpu.systems import families


@pytest.mark.gpu
def test_lane_results_do_not_depend_on_the_batch(gpu_device):
    """With full-f32 delta products, a lane's k and iterates are the same
    whether it is solved in a batch of 4,096 or of 1,024: XLA may pick
    another GEMM algorithm per shape, but no TF32 rounding enters the
    loop (in TF32 about 31% of the headline's lanes changed k; PERF.md)."""
    case = next(c for c in families.cases(30) if c.name == "laxMPC-ADMM")
    solver = case.make("dense")
    args = [jnp.asarray(a, jnp.float32) for a in case.inputs(4096)]
    big = solver(*args)
    small = solver(*(a[:1024] for a in args))
    np.testing.assert_array_equal(np.asarray(small.k),
                                  np.asarray(big.k)[:1024])
    assert np.all(np.asarray(big.e_flag) == 1)
    gap = np.max(np.abs(np.asarray(small.sol["z"])
                        - np.asarray(big.sol["z"])[:1024]))
    assert gap <= 1e-5
