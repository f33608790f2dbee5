"""Option-surface sweep: every knob advertised in the solver registry
(config.SOLVER_REGISTRY, mirroring the reference's def_options_* files)
must either be consumed by the builder (build + solve succeeds) or raise a
typed error — never crash with an unexpected exception. This is the guard
against silent contract drift that the reference's validated options class
provides (classes/Spcies_options.m:63-86).
"""

import numpy as np
import pytest

import spcies_tpu as sp
from spcies_tpu.config import SOLVER_REGISTRY


def _params_for(formulation, sys, param, st):
    """Per-formulation param/sys variants (same recipes as the per-solver
    test files)."""
    sys = dict(sys)
    param = dict(param)
    n = len(st["x"])
    m = sys["B"].shape[1]
    if formulation == "ellipMPC":
        param["T"] = np.diag(np.sum(param["T"], axis=1))
        param["P"] = np.eye(n)
        param["c"] = st["xr"]
        param["r"] = 0.5
    elif formulation == "MPCT":
        param.pop("T", None)
        param["T"] = 10 * np.asarray(param["Q"])
        param["S"] = np.asarray(param["R"]).copy()
        # output constraints for the semiband constrained_output probe
        sys["C"] = np.eye(3, n)
        sys["D"] = np.zeros((3, m))
        sys["LBy"] = -0.3 * np.ones(3)
        sys["UBy"] = 0.3 * np.ones(3)
    elif formulation in ("HMPC", "ellipHMPC"):
        param.pop("T", None)
        param["w"] = 3 * 1.627 * 0.2
        param["Te"] = 10 * param["N"] * np.asarray(param["Q"])
        param["Th"] = param["Te"]
        param["Se"] = np.asarray(param["R"]).copy()
        param["Sh"] = 0.5 * param["Se"]
        if formulation == "ellipHMPC":
            sys["E"] = np.eye(3, n)
            sys["F"] = np.zeros((3, m))
            sys["LBy"] = -0.3 * np.ones(3)
            sys["UBy"] = 0.3 * np.ones(3)
    return sys, param


def _inputs_for(solver, st):
    """Build the positional inputs a solver expects from the fixture
    scenario (ellipHMPC takes 7 decomposed harmonic references; trailing
    defaulted inputs like r_ellip are omitted)."""
    n, m = len(st["x"]), len(st["ur"])
    pool = {
        "x0": st["x"], "xr": st["xr"], "ur": st["ur"],
        "xre": st["xr"], "xrs": np.zeros(n), "xrc": np.zeros(n),
        "ure": st["ur"], "urs": np.zeros(m), "urc": np.zeros(m),
    }
    names = solver.input_names[:solver.n_inputs - len(solver.default_inputs)]
    return tuple(pool[name] for name in names)


# knob -> probe value (chosen != registry default so a consumed knob takes
# a different code path / value than the default build)
PROBES = {
    "rho": 12.0,
    "sigma": 8.0,
    "tol": 1e-5,
    "tol_p": 1e-5,
    "tol_d": 1e-5,
    "k_max": 60,
    "force_vector_rho": True,
    "epsilon_x": 1e-5,
    "epsilon_u": 1e-5,
    "epsilon_y": 1e-5,
    "rho_base": 2.0,
    "rho_mult": 10.0,
    "alpha": 0.9,
    "use_soc": True,
    "box_constraints": True,
    "sparse": True,
    "soft_constraints": True,
    "constrained_output": True,
    "beta": 2.0,
}

# knobs whose probe value is documented to raise (not silently ignore)
EXPECT_RAISE = {"sparse": True}


@pytest.fixture(scope="module")
def base():
    return sp.systems.tester_fixture()


@pytest.mark.parametrize("triple", sorted(SOLVER_REGISTRY))
def test_every_advertised_knob_works_or_raises(triple, base):
    formulation, method, submethod = triple
    sys0, param0, st = base
    sys, param = _params_for(formulation, sys0, param0, st)
    defaults = SOLVER_REGISTRY[triple]
    for knob in defaults:
        probe = PROBES[knob]
        overrides = {knob: probe, "k_max": 60}
        try:
            s = sp.make_solver(sys, param, formulation=formulation,
                               method=method, submethod=submethod,
                               **overrides)
            res = s(*_inputs_for(s, st))
        except (ValueError, NotImplementedError) as e:
            assert str(e), f"{triple} knob {knob}: empty error message"
            continue
        assert knob not in EXPECT_RAISE, (
            f"{triple} knob {knob}={probe} must raise, but built")
        u = np.asarray(res.u)
        assert np.all(np.isfinite(u)), f"{triple} knob {knob}: non-finite u"


def test_sparse_true_raises(base):
    """HMPC sparse=True advertises the reference's permuted-LDL mode which
    this framework replaces by the dense KKT maps — it must raise."""
    sys0, param0, st = base
    sys, param = _params_for("HMPC", sys0, param0, st)
    with pytest.raises(ValueError, match="sparse"):
        sp.make_solver(sys, param, formulation="HMPC", method="ADMM",
                       sparse=True)


def test_force_diagonal_consumed(base):
    """force_diagonal selects the diagonal offline H3 representation in
    MPCT-EADMM (reference compute_MPCT_EADMM_ingredients.m:142-155); the
    solve must be identical either way on diagonal Q/R."""
    sys0, param0, st = base
    sys, param = _params_for("MPCT", sys0, param0, st)
    opt = sp.default_options("MPCT", "EADMM", tol=1e-5, k_max=2000)
    opt.force_diagonal = True
    s1 = sp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                        options=opt)
    s2 = sp.make_solver(sys, param, formulation="MPCT", method="EADMM",
                        tol=1e-5, k_max=2000)
    r1 = s1(st["x"], st["xr"], st["ur"])
    r2 = s2(st["x"], st["xr"], st["ur"])
    assert int(r1.k[0]) == int(r2.k[0])
    np.testing.assert_allclose(np.asarray(r1.u), np.asarray(r2.u),
                               atol=1e-12)


def test_timing_phase_times(base):
    """Options.timing stamps update/solve/polish/run phase times in ms on
    the result (the MEASURE_TIME contract, docs/timing.md;
    snippets/get_elapsed_time.c:12-15)."""
    sys, param, st = base
    s = sp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                       rho=15.0, tol=1e-4, k_max=500)
    assert s.options.timing
    res = s(st["x"], st["xr"], st["ur"])
    times = res.sol["times_ms"]
    assert set(times) == {"update", "solve", "polish", "run"}
    assert all(t >= 0.0 for t in times.values())
    assert times["run"] >= times["solve"]

    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4, k_max=500)
    opt.timing = False
    s2 = sp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                        options=opt)
    res2 = s2(st["x"], st["xr"], st["ur"])
    assert "times_ms" not in res2.sol


def test_debug_is_int_level(base):
    """debug is an int level (0/1/2); bool input is accepted and coerced
    (VERDICT r1 weak #6: it was typed bool but consumed as a level)."""
    opt = sp.default_options("laxMPC", "ADMM")
    assert opt.debug == 0 and isinstance(opt.debug, int)
    opt2 = sp.Options(formulation="laxMPC", method="ADMM", debug=True)
    assert opt2.debug == 1 and isinstance(opt2.debug, int)
    opt3 = sp.Options(formulation="laxMPC", method="ADMM", debug=2)
    assert opt3.debug == 2


def test_verbose_gates_personal_default_warning(base):
    """Options.verbose mirrors Spcies_options.m:506-509: when the triple
    has no registered defaults (the 'personal' escape hatch), verbose>0
    warns and verbose=0 is silent (VERDICT r2 next-#7)."""
    import warnings as _w
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        sp.Options(formulation="personal", method="X", verbose=1,
                   solver=dict(rho=1.0))
    assert any("personal" in str(w.message) for w in rec)
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        sp.Options(formulation="personal", method="X", verbose=0,
                   solver=dict(rho=1.0))
    assert not rec


def test_inf_value_consumed(base):
    """inf_value fills missing bounds in the baked ingredients
    (platforms/+C_code/dec_var.m clamps inf at codegen; here the bound is
    baked directly)."""
    sys, param, st = base
    sys2 = {k: v for k, v in sys.items() if k not in ("LBx", "UBx")}
    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                             k_max=100)
    opt.inf_value = 12345.0
    s = sp.make_solver(sys2, param, formulation="laxMPC", method="ADMM",
                       options=opt)
    LB = np.asarray(s.ingredients["LB_z"])
    UB = np.asarray(s.ingredients["UB_z"])
    assert LB.min() == -12345.0 and UB.max() == 12345.0


def test_override_and_const_are_static_consumed(base, tmp_path):
    """override=False picks an unused _vN name
    (+sp_utils/find_unused_file_name.m); const_are_static=False emits
    plain `const` (dec_var.m 'static' option)."""
    sys, param, st = base
    from spcies_tpu.codegen import generate_embedded_solver
    opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                             k_max=100)
    opt.const_are_static = False
    files = generate_embedded_solver(sys, param, formulation="laxMPC",
                                     method="ADMM", options=opt,
                                     directory=str(tmp_path),
                                     save_name="ovr", compile_mex=False)
    src = (tmp_path / "ovr.c").read_text()
    assert "static const" not in src and "const" in src
    opt2 = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                              k_max=100)
    opt2.override = False
    generate_embedded_solver(sys, param, formulation="laxMPC",
                             method="ADMM", options=opt2,
                             directory=str(tmp_path), save_name="ovr",
                             compile_mex=False)
    assert (tmp_path / "ovr_v2.c").exists()   # first collision -> _v2



def test_debug_traces_per_backend(base):
    """Per-backend genHist contract: debug=1/2
    traces exist on the dense and banded loops."""
    sys, param, st = base
    for be in ("dense", "banded"):
        opt = sp.default_options("laxMPC", "ADMM", rho=15.0, tol=1e-4,
                                 k_max=200)
        opt.debug = 1
        s = sp.make_solver(sys, param, formulation="laxMPC", method="ADMM",
                           options=opt, backend=be)
        res = s(st["x"], st["xr"], st["ur"])
        assert "hRp" in res.sol and "hRd" in res.sol
