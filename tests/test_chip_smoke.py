"""chip_smoke.py's phases at tiny sizes on the CPU: the same code paths the
GPU run takes (make_solver, the fp64 oracle, the CPU fp32 reference,
golden optima, closed loop, the four-device comparison), the checks'
pass/fail logic, the contract line, and the refusal to run without a
GPU."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as cs  # noqa: E402
from spcies_tpu.systems import families  # noqa: E402

TRIPLES = [c.name for c in families.cases(30)]


def test_thirteen_triples():
    assert len(TRIPLES) == 13 and len(set(TRIPLES)) == 13
    assert cs.HEADLINE in TRIPLES


def test_references_solve_the_same_lanes_on_the_cpu():
    """The CPU reference solves exactly the lanes the card solves: its k
    of the first lanes and its z of the sampled lanes equal a direct
    solve of the whole batch here."""
    import jax.numpy as jnp
    case = next(c for c in families.cases(10) if c.name == cs.HEADLINE)
    inputs = case.inputs(12)
    lanes = cs.sample_lanes(12, 3)
    ref = cs.references(10, cs.HEADLINE, inputs, lanes)
    full = case.make("dense")(*cs.to_dev(inputs, jnp.float32))
    assert ref["cpu_k_mean"] == float(full.k.mean())
    assert ref["cpu_z_gap"] == cs.z_gap(full, lanes, ref["z_oracle"])
    assert ref["z_oracle"].shape == (3, full.sol["z"].shape[1])
    assert len(ref["oracle"]) == 3


@pytest.mark.parametrize("name", TRIPLES)
def test_phase_families(name):
    """P3 for one triple: dense at N=30 converges on every lane, its z
    sits as near the fp64 oracle's as the CPU fp32 solve of the same lanes
    (here the same solve at another batch size), and a banded triple
    agrees with dense."""
    rows = cs.phase_families(B=8, n_oracle=2, reps=1, banded_N=30,
                             banded_B=4, names=(name,))
    row = rows[name]
    assert row["conv"] == 1.0 and row["k_mean_vs_cpu"] <= 0.05
    assert 0 < row["z_gap"] <= cs.z_limit(row["cpu_z_gap"])
    case = next(c for c in families.cases(30) if c.name == name)
    assert ("banded" in row) == case.banded


@pytest.mark.parametrize("bf16", [False, True])
def test_phase_headline(bf16):
    r = cs.phase_headline(B=16, n_oracle=4, reps=1, bf16=bf16)
    assert r["conv"] == 1.0 and r["peak_bytes"] > 0
    assert len(r["oracle"]) == 4 and r["k_mean_vs_cpu"] == 0.0
    assert r["z_gap"] == r["cpu_z_gap"] > 0
    assert r["z_gap_limit"] == max(2 * r["cpu_z_gap"], cs.Z_FLOOR)


def test_phase_fp64():
    r = cs.phase_fp64(B=8, Ns=(10,), n_oracle=3)
    assert r[10]["k_same"] == 1.0 and r[10]["iterate_gap"] <= 1e-9
    assert r[10]["dtype"] == "float64"
    assert set(r["golden"]) == {g[0] for g in cs.GOLDEN}
    assert max(r["golden"].values()) <= 1e-6


def test_phase_closed_loop():
    r = cs.phase_closed_loop(B=8, steps=12, reps=1)
    assert r["conv"] == 1.0 and r["k_same"] == 1.0
    assert r["x_step_gap"] <= 1e-6
    assert r["u_pairs_off_bounds"] >= 8 and r["u_gap_off_bounds"] == 0.0
    assert 0 < r["k_mean_after_step0"] < r["step0_k_mean"]


def test_phase_four_on_virtual_devices():
    """--four on four virtual CPU devices: per-lane k and e_flag equal to
    the one-device solve, the result spread over four devices, no
    collective in the shard_map loop."""
    r = cs.phase_four(B_card=64, B64_card=2, reps=1)
    for prec in ("float", "double"):
        for tag in ("shard_map", "sharded"):
            assert r[prec][tag]["devices"] == 4
            assert r[prec][tag]["k_equal"] and r[prec][tag]["e_equal"]
        assert r[prec]["loop_collectives"] == []
    assert r["double"]["shard_map"]["z_gap"] == 0.0


def test_z_limit():
    assert cs.z_limit(4e-3) == 8e-3
    assert cs.z_limit(1e-7) == cs.Z_FLOOR


def test_check_kmean_limits():
    assert cs.check_kmean("t", 104.9, 100.0) == pytest.approx(0.049)
    with pytest.raises(cs.SmokeFailure, match="from the CPU fp32"):
        cs.check_kmean("t", 105.1, 100.0)
    with pytest.raises(cs.SmokeFailure, match="from the CPU fp32"):
        cs.check_kmean("t", 94.9, 100.0)


def test_contract_line():
    line = cs.contract_line(dict(platform="gpu", kind="NVIDIA H100 80GB HBM3",
                                 count=4))
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert "no GPU found" in str(exc.value.code)
    assert '"ok"' not in capsys.readouterr().out
