"""Utility tests: checkpoint save/restore and device-synchronized timing."""

import os

import numpy as np

import nllstpu as nt
from nllstpu.models.rosenbrock import make_rosenbrock
from nllstpu.utils import checkpoint, profiling


def test_checkpoint_roundtrip(tmp_path):
    p, x, y = make_rosenbrock(x0=-0.5, y0=2.5)
    nt.optimize(p, nt.Options(max_iters=3))
    path = os.path.join(tmp_path, "state.npz")
    checkpoint.save_variables(path, p, extra={"lm_lambda": 1e-3})
    vx, vy = p.get_value(x), p.get_value(y)
    # Clobber and restore.
    p.set_value(x, 42.0)
    p.set_value(y, -7.0)
    extras = checkpoint.load_variables(path, p)
    np.testing.assert_allclose(p.get_value(x), vx)
    np.testing.assert_allclose(p.get_value(y), vy)
    np.testing.assert_allclose(extras["lm_lambda"], 1e-3)
    # Resuming continues to the optimum.
    result = nt.optimize(p)
    np.testing.assert_allclose(float(p.get_value(x)), 1.0, rtol=1e-8)


def test_timed_fence():
    import jax.numpy as jnp
    import jax

    f = jax.jit(lambda x: (x * 2, {"y": x + 1}))
    secs, out = profiling.timed(f, jnp.ones(16))
    assert secs > 0
    np.testing.assert_allclose(out[0], 2.0)


def _record_config_updates(monkeypatch):
    from nllstpu.utils import compile_cache

    calls = {}
    monkeypatch.setattr(
        compile_cache.jax.config, "update",
        lambda name, value: calls.__setitem__(name, value),
    )
    return compile_cache, calls


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself: no code
    sets a cache directory."""
    compile_cache, calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_defaults_into_checkout(monkeypatch):
    """Without the variable the cache is the fixed, gitignored
    ``<repo>/.jax_cache``."""
    compile_cache, calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, ".jax_cache")
    assert compile_cache.configure_compile_cache(2.0) == want
    assert calls["jax_compilation_cache_dir"] == want
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 2.0
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
