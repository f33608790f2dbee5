"""shard_map solve path (parallel/distributed.py): per-shard termination
with zero per-iteration collectives, identical per-lane results to the
plain (auto-partitioned) solve under freeze semantics; host x chip mesh
construction; globally-reduced fleet metrics."""

import numpy as np
import pytest

import jax

import spcies_tpu as sp


@pytest.fixture(scope="module")
def solver_and_data():
    sys_, param, st = sp.systems.tester_fixture()
    solver = sp.make_solver(sys_, param, formulation="laxMPC",
                            method="ADMM", rho=15.0, tol=1e-6, k_max=3000)
    B = 32
    rng = np.random.default_rng(5)
    x0 = np.asarray(st["x"])[None, :] * rng.uniform(-2, 2, (B, 1))
    xr = np.tile(st["xr"], (B, 1))
    ur = np.tile(st["ur"], (B, 1))
    return solver, x0, xr, ur


def test_host_chip_mesh_shape():
    mesh = sp.parallel.host_chip_mesh()
    assert mesh.axis_names == ("host", "chip")
    # single-process run: host axis 1, chip axis = all local devices
    assert mesh.devices.shape == (1, len(jax.devices()))
    assert sp.parallel.batch_spec(mesh) == jax.sharding.PartitionSpec(
        ("host", "chip"))


def test_shard_map_matches_plain_solve(solver_and_data):
    solver, x0, xr, ur = solver_and_data
    mesh = sp.parallel.host_chip_mesh()
    solve = sp.parallel.shard_map_solver(solver, mesh)
    res_s = solve(x0, xr, ur)
    res_p = solver(x0, xr, ur)
    # per-lane iterates/k/e_flag identical: converged lanes freeze, so
    # per-shard vs global termination cannot change any lane's exit state
    np.testing.assert_array_equal(np.asarray(res_s.k), np.asarray(res_p.k))
    np.testing.assert_array_equal(np.asarray(res_s.e_flag),
                                  np.asarray(res_p.e_flag))
    for key in ("z", "v", "lam"):
        np.testing.assert_allclose(np.asarray(res_s.sol[key]),
                                   np.asarray(res_p.sol[key]), atol=0.0)
    # outputs really are batch-sharded over the mesh
    assert res_s.u.sharding.is_equivalent_to(
        jax.sharding.NamedSharding(mesh, sp.parallel.batch_spec(mesh)),
        res_s.u.ndim)


def test_shard_map_no_hotloop_collectives(solver_and_data):
    """The compiled per-shard loop must contain NO cross-device collective:
    termination is shard-local (the whole point vs jit auto-partitioning,
    whose any-active test is a per-iteration all-reduce)."""
    solver, x0, xr, ur = solver_and_data
    mesh = sp.parallel.host_chip_mesh()
    from jax.sharding import NamedSharding
    from jax import shard_map
    spec = sp.parallel.batch_spec(mesh)
    fn = shard_map(lambda a, b, c: solver.raw_fn(a, b, c, None, None),
                   mesh=mesh, in_specs=(spec,) * 3, out_specs=spec,
                   check_vma=False)
    args = [jax.device_put(np.asarray(a, np.float64),
                           NamedSharding(mesh, spec))
            for a in (x0, xr, ur)]
    compiled = jax.jit(fn).lower(*args).compile()
    hlo = compiled.as_text()
    loop_body = hlo[hlo.find("while"):] if "while" in hlo else hlo
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "reduce-scatter", "all-to-all"):
        assert coll not in loop_body, f"{coll} found in compiled solve loop"


def test_shard_map_warm_start(solver_and_data):
    solver, x0, xr, ur = solver_and_data
    mesh = sp.parallel.host_chip_mesh()
    solve = sp.parallel.shard_map_solver(solver, mesh)
    res1 = solve(x0, xr, ur)
    init = (res1.sol["z"], res1.sol["v"], res1.sol["lam"])
    res2 = solve(x0, xr, ur, init=init)
    # warm-started from the converged point: immediate exit
    assert int(np.max(np.asarray(res2.k))) <= 2
    assert np.all(np.asarray(res2.e_flag) == 1)


def test_global_fleet_metrics(solver_and_data):
    solver, x0, xr, ur = solver_and_data
    mesh = sp.parallel.host_chip_mesh()
    solve = sp.parallel.shard_map_solver(solver, mesh)
    res = solve(x0, xr, ur)
    m = sp.parallel.global_fleet_metrics(res, mesh)
    assert m["n_converged"] == m["n_lanes"] == x0.shape[0]
    assert m["k_min"] <= m["k_mean"] <= m["k_max"]
    assert m["n_hosts"] == 1 and m["n_devices"] == len(jax.devices())


def test_shard_map_batch_divisibility_error(solver_and_data):
    solver, x0, xr, ur = solver_and_data
    mesh = sp.parallel.host_chip_mesh()
    solve = sp.parallel.shard_map_solver(solver, mesh)
    with pytest.raises(ValueError, match="divisible"):
        solve(x0[:5], xr[:5], ur[:5])
