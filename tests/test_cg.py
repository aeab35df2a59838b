"""Matrix-free PCG backend tests: solves must match the dense backend, and
the SE(3) pose-graph family must converge to the ground truth with
``solver="cg"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nllstpu as nt
from nllstpu.core.iterators import DenseOps
from nllstpu.core.manifolds import so3_exp, so3_log
from nllstpu.core.optimize import compile_problem
from nllstpu.models.ba import make_affine_ba, perturb_ba
from nllstpu.models.posegraph import make_pose_graph


def test_so3_log_roundtrip():
    rng = np.random.default_rng(0)
    for _ in range(10):
        w = rng.standard_normal(3)
        w = w / np.linalg.norm(w) * rng.uniform(0, 2.5)
        r = so3_exp(jnp.asarray(w))
        np.testing.assert_allclose(so3_log(r), w, rtol=1e-9, atol=1e-10)
    # Identity.
    np.testing.assert_allclose(so3_log(jnp.eye(3)), np.zeros(3), atol=1e-12)


def test_cg_matches_dense():
    p, cams, lmks = make_affine_ba(4, 9, 1.0)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    unfixed = cams + lmks[3:]  # pin the gauge
    dense = compile_problem(p, unfixed=unfixed)
    cgc = compile_problem(p, unfixed=unfixed, solver="cg")
    variables = p.stacked_variables()
    cd, sys_d = jax.jit(dense.assemble)(variables)
    cc, sys_c = jax.jit(cgc.assemble)(variables)
    dops = DenseOps(dense.layout.dof_total)
    cops = cgc.cg_ops

    np.testing.assert_allclose(cd, cc, rtol=1e-12)
    np.testing.assert_allclose(dops.grad(sys_d), cops.grad(sys_c), rtol=1e-10)
    np.testing.assert_allclose(
        dops.diag_max(sys_d), cops.diag_max(sys_c), rtol=1e-12
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dense.layout.dof_total))
    np.testing.assert_allclose(dops.quad(sys_d, x), cops.quad(sys_c, x), rtol=1e-9)
    for lam in [0.0, 1e-3, 1.0]:
        xd = dops.solve(sys_d, jnp.asarray(lam))
        xc = cops.solve(sys_c, jnp.asarray(lam))
        np.testing.assert_allclose(xd, xc, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_pose_graph_converges(solver):
    p, poses, truth = make_pose_graph(n_poses=16, n_loops=4, perturb=0.05)
    start = nt.cost(p)
    assert start > 1e-4
    # Fix the first pose to pin the gauge.
    result = nt.optimize(
        p,
        nt.Options(solver=solver, iterator=nt.LEVENBERG_MARQUARDT),
        unfixed=poses[1:],
    )
    assert result.best_cost < 1e-18
    # Recovered poses match ground truth (gauge anchored at pose 0).
    final = np.stack([p.get_value(h) for h in poses])
    np.testing.assert_allclose(final, truth, atol=1e-8)


def test_dogleg_on_cg_backend():
    p, poses, truth = make_pose_graph(n_poses=12, n_loops=3, perturb=0.05)
    result = nt.optimize(
        p, nt.Options(solver="cg", iterator=nt.DOGLEG), unfixed=poses[1:]
    )
    assert result.best_cost < 1e-10


def test_auto_solver_selection():
    """solver="auto" mirrors the reference's ``makesymmvls`` decision
    (src/linearsystem.jl:109-118): dense for small systems (d <= 40), the
    fill heuristic ``sparse_dense_decision`` (src/utils.jl:108) for large
    ones — "sparse" selecting the matrix-free CG backend."""
    import nllstpu.models.rosenbrock as rb

    p_small, _, _ = rb.make_rosenbrock()
    c_small = compile_problem(p_small, solver="auto")
    assert c_small.cg_ops is None and c_small.schur_info is None

    # A long sparse pose chain: d = 17*6 > 40, nearest-neighbour coupling.
    p_chain, poses, _ = make_pose_graph(n_poses=18, n_loops=0, perturb=0.01)
    c_chain = compile_problem(p_chain, unfixed=poses[1:], solver="auto")
    assert c_chain.cg_ops is not None

    # Fully coupled affine BA at moderate size stays dense (high fill).
    p_ba, cams, lmks = make_affine_ba(6, 10, 1.0)
    c_ba = compile_problem(p_ba, solver="auto")
    assert c_ba.cg_ops is None and c_ba.schur_info is None


def test_pose_graph_f32_converges():
    """f32 pose graphs must reach a deep cost floor: the arccos-based
    so3_log had an infinite derivative at the (clipped) identity, which
    NaN'd jacfwd under reduced-precision matmul rounding and floored the f32 cost at
    ~1e-2 even on CPU; the atan2 form + full-precision residual matmuls fix
    both (see core/manifolds.so3_log)."""
    import jax.numpy as jnp

    p, poses, truth = make_pose_graph(
        n_poses=64, n_loops=8, perturb=0.05, dtype=jnp.float32
    )
    result = nt.optimize(p, nt.Options(solver="cg", max_iters=30))
    assert result.best_cost < 1e-6, result.best_cost


def test_so3_log_differentiable_at_identity():
    """jacfwd of log∘exp at the zero tangent is the identity — no NaN from
    the arccos endpoint (its derivative is infinite at c = 1)."""
    import jax
    import jax.numpy as jnp

    from nllstpu.core.manifolds import so3_exp, so3_log

    j = jax.jacfwd(lambda t: so3_log(so3_exp(t)))(jnp.zeros(3, jnp.float64))
    assert np.all(np.isfinite(np.asarray(j)))
    np.testing.assert_allclose(np.asarray(j), np.eye(3), atol=1e-9)


def test_linear_tol_option():
    """``Options(linear_tol=...)`` (the Ceres eta analogue) loosens the
    inner CG tolerance; LM still converges to the reference target with
    inexact steps."""
    p, poses, truth = make_pose_graph(n_poses=32, n_loops=6, perturb=0.05)
    result = nt.optimize(
        p, nt.Options(solver="cg", linear_tol=1e-2, max_iters=40)
    )
    assert result.best_cost < 1e-18
