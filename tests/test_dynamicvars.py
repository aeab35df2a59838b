"""Runtime-sized variables — the reference's test/dynamicvars.jl: one
variable whose dimension is chosen at runtime (not a compile-time constant),
a scalar linear residual plus a full-vector regularizer, Newton optimize,
and the optimum must be collinear with the data vector.

Here "dynamic" sizes are sizes fixed at problem-build (trace)
time rather than in the type system; XLA still sees static shapes.
"""

import jax.numpy as jnp
import numpy as np

import nllstpu as nt


def linear_residual(X, w):
    return jnp.atleast_1d(X @ w - 1.0)


def norm_residual(_, w):
    return w


def test_dynamic_size_variable_newton():
    rng = np.random.default_rng(1)
    n = int(np.ceil((1.0 + rng.random()) * 50))
    X = rng.standard_normal(n)
    X /= np.linalg.norm(X)

    p = nt.Problem()
    w = p.add_variable(nt.Euclidean(n), np.zeros(n))
    p.add_cost(linear_residual, (w,), params=X)
    p.add_cost(norm_residual, (w,))

    result = nt.optimize(p, nt.Options(iterator=nt.NEWTON))
    y = np.asarray(p.get_value(w))
    # minimizing (X'w - 1)^2 + |w|^2 gives w = X/2: X'y == |y| (collinear).
    np.testing.assert_allclose(X @ y, np.linalg.norm(y), rtol=1e-10)
    assert result.best_cost < 0.251  # optimum cost = 1/4 (+ rounding)
