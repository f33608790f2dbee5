"""Backend selection, the precision guard and the compile-cache location."""

import os

import jax
import pytest

import spcies_tpu as sp
from spcies_tpu.systems import families
from spcies_tpu.utils import compile_cache

CASES = {c.name: c for c in families.cases(10)}


@pytest.mark.parametrize("name", list(CASES))
def test_fused_raises_where_the_triple_has_none(name):
    """backend='fused' (no triple has a hand-written kernel) names the
    backends that exist instead of being served by another one."""
    with pytest.raises(ValueError, match="has no backend 'fused'; its "
                                         "backends are"):
        CASES[name].make("fused")


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match=r"\('dense', 'banded'"):
        CASES["laxMPC-FISTA"].make("sparse")


def test_double_precision_needs_x64():
    """precision='double' without 64-bit floats would silently compute in
    float32; make_solver refuses instead."""
    sys_, param, _ = sp.systems.tester_fixture()
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.raises(ValueError, match="jax_enable_x64"):
            sp.make_solver(sys_, param, formulation="laxMPC", method="ADMM")
        opt = sp.default_options("laxMPC", "ADMM")
        opt.precision = "float"
        s = sp.make_solver(sys_, param, options=opt)
        assert s.dtype == jax.numpy.float32
    finally:
        jax.config.update("jax_enable_x64", True)


def test_compile_cache_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper uses it and sets
    nothing in code."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_env_unset(monkeypatch):
    """Without it, the cache goes to the fixed <checkout>/.jax_cache."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert compile_cache.enable_compile_cache() == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
