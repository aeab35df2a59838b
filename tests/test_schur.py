"""Schur-complement solver tests: the landmark-eliminated system must agree
with the dense normal equations on gradient, quadratic form, damped solves
and final optima (the reference only asserts Schur-reorder cost invariance,
test/optimizeba.jl:55-58; the marginalized solve itself is this framework's
replacement for sparse LDLᵀ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nllstpu as nt
from nllstpu.core.iterators import DenseOps
from nllstpu.core.optimize import compile_problem
from nllstpu.models.ba import make_affine_ba, perturb_ba

LMK = nt.Euclidean(3)


def _both_systems(p, unfixed=None):
    dense = compile_problem(p, unfixed=unfixed)
    schur = compile_problem(p, unfixed=unfixed, solver="schur", schur_family=LMK)
    variables = p.stacked_variables()
    # Cameras were added before landmarks, so ordering the landmark family
    # last leaves the layouts identical and the tangent spaces comparable.
    np.testing.assert_array_equal(
        np.asarray(dense.layout.offsets[nt.family_name(LMK)]),
        np.asarray(schur.layout.offsets[nt.family_name(LMK)]),
    )
    cd, sys_d = jax.jit(dense.assemble)(variables)
    cs, sys_s = jax.jit(schur.assemble)(variables)
    return dense, schur, sys_d, sys_s, cd, cs


def test_schur_matches_dense_system():
    # Full visibility, and the gauge pinned by fixing 3 landmarks (affine BA
    # has a 9-dim GL(3) gauge), so H is nonsingular and the λ=0 solves are
    # well posed on both backends.
    p, cams, lmks = make_affine_ba(4, 9, 1.0)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    dense, schur, sys_d, sys_s, cd, cs = _both_systems(p, unfixed=cams + lmks[3:])
    dops = DenseOps(dense.layout.dof_total)
    sops = schur.schur_info.ops()

    np.testing.assert_allclose(cd, cs, rtol=1e-12)
    np.testing.assert_allclose(dops.grad(sys_d), sops.grad(sys_s), rtol=1e-10)
    np.testing.assert_allclose(
        dops.diag_max(sys_d), sops.diag_max(sys_s), rtol=1e-12
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(dense.layout.dof_total))
    np.testing.assert_allclose(
        dops.quad(sys_d, x), sops.quad(sys_s, x), rtol=1e-9
    )
    for lam in [0.0, 1e-4, 1.0]:
        xd = dops.solve(sys_d, jnp.asarray(lam))
        xs = sops.solve(sys_s, jnp.asarray(lam))
        np.testing.assert_allclose(xd, xs, rtol=1e-6, atol=1e-9)


def test_schur_solve0_quad_grad_fused():
    """Dogleg's fused Newton-solve + Cauchy-curvature path must equal the
    separate solve(λ=0) and quad(grad) calls it replaces."""
    p, cams, lmks = make_affine_ba(4, 9, 1.0)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    _, schur, _, sys_s, _, _ = _both_systems(p, unfixed=cams + lmks[3:])
    sops = schur.schur_info.ops()
    x_fused, ghg_fused = jax.jit(sops.solve0_quad_grad)(sys_s)
    g = sops.grad(sys_s)
    x_ref = sops.solve(sys_s, jnp.zeros((), dtype=g.dtype))
    ghg_ref = sops.quad(sys_s, g)
    np.testing.assert_allclose(x_fused, x_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ghg_fused, ghg_ref, rtol=1e-10)


def test_schur_matches_dense_damped_sparse():
    # Sparse visibility leaves H singular at λ=0 (some landmarks are barely
    # observed), so compare the damped solves only.
    p, cams, lmks = make_affine_ba(4, 9, 0.6)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    dense, schur, sys_d, sys_s, cd, cs = _both_systems(p)
    dops = DenseOps(dense.layout.dof_total)
    sops = schur.schur_info.ops()
    np.testing.assert_allclose(cd, cs, rtol=1e-12)
    np.testing.assert_allclose(dops.grad(sys_d), sops.grad(sys_s), rtol=1e-10)
    for lam in [1e-4, 1.0]:
        xd = dops.solve(sys_d, jnp.asarray(lam))
        xs = sops.solve(sys_s, jnp.asarray(lam))
        np.testing.assert_allclose(xd, xs, rtol=1e-6, atol=1e-9)


def test_schur_with_fixed_cameras_and_landmarks():
    p, cams, lmks = make_affine_ba(4, 9, 0.6)
    perturb_ba(p, lmks, 0.05, seed=3)
    # Fix one camera and two landmarks: dustbin paths on both sides.
    unfixed = cams[1:] + lmks[:-2]
    dense = compile_problem(p, unfixed=unfixed)
    schur = compile_problem(p, unfixed=unfixed, solver="schur", schur_family=LMK)
    variables = p.stacked_variables()
    cd, sys_d = dense.assemble(variables)
    cs, sys_s = schur.assemble(variables)
    dops = DenseOps(dense.layout.dof_total)
    sops = schur.schur_info.ops()
    np.testing.assert_allclose(cd, cs, rtol=1e-12)
    np.testing.assert_allclose(dops.grad(sys_d), sops.grad(sys_s), rtol=1e-10)
    xd = dops.solve(sys_d, jnp.asarray(1e-3))
    xs = sops.solve(sys_s, jnp.asarray(1e-3))
    np.testing.assert_allclose(xd, xs, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("iterator", [nt.LEVENBERG_MARQUARDT, nt.DOGLEG])
def test_schur_full_optimize(iterator):
    p, cams, lmks = make_affine_ba(10, 50, 0.3)
    perturb_ba(p, lmks, 0.001, seed=3)
    perturb_ba(p, cams, 0.001, seed=4)
    result = nt.optimize(
        p, nt.Options(iterator=iterator, solver="schur", schur_family=LMK)
    )
    assert result.best_cost < 1e-15
    np.testing.assert_allclose(nt.cost(p), result.best_cost, atol=1e-300)


def test_cost_invariant_under_cost_order():
    """Parity with the reference's reordering invariance check
    (test/optimizeba.jl:55-58): the assembled cost does not depend on the
    order costs were added (segment-sum assembly is order-independent)."""
    p1, cams, lmks = make_affine_ba(4, 9, 0.6)
    c1 = nt.cost(p1)
    # Rebuild with costs added in a shuffled order.
    p2, _, _ = make_affine_ba(4, 9, 0.6)
    groups = p2._groups
    key = next(iter(groups))
    g = groups[key]
    rng = np.random.default_rng(0)
    perm = rng.permutation(len(g.indices))
    g.indices = [g.indices[i] for i in perm]
    g.params = [g.params[i] for i in perm]
    np.testing.assert_allclose(nt.cost(p2), c1, rtol=1e-12)


def test_implicit_schur_matches_direct():
    """schur_cg (implicit reduced matvec + PCG) must agree with the dense-W
    direct elimination."""
    p, cams, lmks = make_affine_ba(5, 12, 0.7)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    direct = compile_problem(p, solver="schur", schur_family=LMK)
    implicit = compile_problem(p, solver="schur_cg", schur_family=LMK)
    variables = p.stacked_variables()
    cd, sys_d = jax.jit(direct.assemble)(variables)
    ci, sys_i = jax.jit(implicit.assemble)(variables)
    dops = direct.schur_info.ops()
    iops = implicit.schur_info.ops()
    np.testing.assert_allclose(cd, ci, rtol=1e-12)
    np.testing.assert_allclose(dops.grad(sys_d), iops.grad(sys_i), rtol=1e-10)
    np.testing.assert_allclose(
        dops.diag_max(sys_d), iops.diag_max(sys_i), rtol=1e-12
    )
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(direct.layout.dof_total))
    np.testing.assert_allclose(dops.quad(sys_d, x), iops.quad(sys_i, x), rtol=1e-9)
    for lam in [1e-3, 1.0]:
        xd = dops.solve(sys_d, jnp.asarray(lam))
        xi = iops.solve(sys_i, jnp.asarray(lam))
        np.testing.assert_allclose(xd, xi, rtol=1e-6, atol=1e-8)


def test_implicit_schur_full_optimize():
    p, cams, lmks = make_affine_ba(10, 50, 0.3)
    perturb_ba(p, lmks, 0.001, seed=3)
    perturb_ba(p, cams, 0.001, seed=4)
    result = nt.optimize(
        p, nt.Options(solver="schur_cg", schur_family=LMK)
    )
    assert result.best_cost < 1e-15


def test_implicit_schur_fixed_trip_cg():
    """The fixed-trip-count (fori_loop) CG with frozen-on-convergence
    updates must reproduce the dynamic while_loop solve and still drive a
    full optimization to the reference target."""
    import dataclasses

    p, cams, lmks = make_affine_ba(5, 12, 0.7)
    perturb_ba(p, lmks, 0.05, seed=3)
    implicit = compile_problem(p, solver="schur_cg", schur_family=LMK)
    variables = p.stacked_variables()
    _, sys_i = jax.jit(implicit.assemble)(variables)
    dyn = implicit.schur_info.ops()
    fixed = dataclasses.replace(dyn, fixed_iters=200)
    for lam in [1e-3, 1.0]:
        xd = dyn.solve(sys_i, jnp.asarray(lam))
        xf = fixed.solve(sys_i, jnp.asarray(lam))
        np.testing.assert_allclose(xd, xf, rtol=1e-8, atol=1e-10)

    # Env-selected fixed-trip mode end to end.
    import os

    p2, cams2, lmks2 = make_affine_ba(10, 50, 0.3)
    perturb_ba(p2, lmks2, 0.001, seed=3)
    perturb_ba(p2, cams2, 0.001, seed=4)
    os.environ["NLLSTPU_CG_FIXED_ITERS"] = "150"
    try:
        result = nt.optimize(
            p2, nt.Options(solver="schur_cg", schur_family=LMK)
        )
    finally:
        del os.environ["NLLSTPU_CG_FIXED_ITERS"]
    assert result.best_cost < 1e-15


@pytest.mark.parametrize("iterator", [nt.NEWTON, nt.GRADIENT_DESCENT])
def test_more_iterators_on_schur(iterator):
    """Newton and gradient descent also run on the Schur backend (protocol
    completeness: solve/grad/quad/diag_max)."""
    p, cams, lmks = make_affine_ba(4, 9, 1.0)
    perturb_ba(p, lmks, 0.001, seed=3)
    result = nt.optimize(
        p,
        nt.Options(
            iterator=iterator, solver="schur", schur_family=LMK, max_iters=40
        ),
        unfixed=cams + lmks[3:],  # pin the gauge for the λ=0 Newton solve
    )
    assert result.best_cost < result.start_cost


def test_schur_jacobi_preconditioner_blocks_exact():
    """The implicit backend's Schur-Jacobi preconditioner blocks must equal
    the exact diagonal blocks of the damped reduced matrix
    S(λ) = (A_rr + λI) − W·(H_ll + λI)⁻¹·Wᵀ formed explicitly by the direct
    backend (Ceres SCHUR_JACOBI analogue)."""
    from nllstpu.core.linearsolver import batched_inv_spd

    p, cams, lmks = make_affine_ba(6, 15, 0.6)
    perturb_ba(p, lmks, 0.1, seed=7)
    ci = compile_problem(p, solver="schur_cg", schur_family=nt.Euclidean(3))
    cd = compile_problem(p, solver="schur", schur_family=nt.Euclidean(3))
    variables = p.stacked_variables()
    _, sys_i = jax.jit(ci.assemble)(variables)
    _, sys_d = jax.jit(cd.assemble)(variables)
    a_rr, _, h_ll, _, w = sys_d
    lam = 1e-4
    dl = 3
    from nllstpu.core.linearsolver import batched_inv_spd_cm

    h_inv = batched_inv_spd_cm(h_ll + lam * jnp.eye(dl)[:, :, None])
    y = jnp.einsum("dlr,del->elr", w, h_inv)
    s = a_rr + lam * jnp.eye(a_rr.shape[0]) - jnp.einsum("elr,els->rs", y, w)
    ops = ci.schur_info.ops()
    assert ops.wpart_fam and any(f is not None for f in ops.wpart_fam)
    blocks, corrected = ops.precond_blocks(sys_i, jnp.asarray(lam), h_inv)
    assert corrected == [True]
    (name, offs, dof), = ops.fam_offsets
    expect = np.stack(
        [np.asarray(s)[o : o + dof, o : o + dof] for o in offs]
    )
    np.testing.assert_allclose(np.asarray(blocks[0]), expect, rtol=1e-10)


def test_schur_jacobi_preconditioner_converges_no_worse():
    """Under a fixed PCG budget on a sparse-visibility BAL problem, the
    Schur-Jacobi blocks must (in aggregate over λ) converge at least as fast
    as the A_rr-only block-Jacobi blocks, and the converged solve must be
    unchanged."""
    import dataclasses

    from nllstpu.models import bal

    data = bal.make_synthetic_bal(12, 240, obs_per_point=4, seed=0, noise=0.02)
    p, cams, pts = bal.make_bal_problem(data)
    ci = compile_problem(p, solver="schur_cg", schur_family=nt.Euclidean(3))
    variables = p.stacked_variables()
    _, sys_i = jax.jit(ci.assemble)(variables)
    ops = ci.schur_info.ops()
    exact = dataclasses.replace(ops, max_iters=4000, tol=1e-14)
    schur_jac = dataclasses.replace(ops, max_iters=8)
    block_jac = dataclasses.replace(ops, max_iters=8, wpart_fam=())
    e_schur = e_block = 0.0
    for lam in [1e-2, 1e-1, 1.0]:
        lamj = jnp.asarray(lam)
        x_true = exact.solve(sys_i, lamj)
        scale = float(jnp.linalg.norm(x_true))
        e_schur += float(jnp.linalg.norm(schur_jac.solve(sys_i, lamj) - x_true)) / scale
        e_block += float(jnp.linalg.norm(block_jac.solve(sys_i, lamj) - x_true)) / scale
    assert e_schur <= e_block * 1.02


def test_auto_implicit_fallback_past_w_budget(monkeypatch):
    """solver="schur" silently switches to the implicit (matrix-free)
    reduced solve when the dense W exceeds the memory budget."""
    from nllstpu.core import optimize as opt

    p, cams, lmks = make_affine_ba(4, 9, 1.0)
    direct = compile_problem(p, solver="schur", schur_family=nt.Euclidean(3))
    assert not direct.schur_info.implicit
    monkeypatch.setattr(opt, "DENSE_W_BYTE_LIMIT", 1)
    implicit = compile_problem(p, solver="schur", schur_family=nt.Euclidean(3))
    assert implicit.schur_info.implicit
    result = nt.optimize(
        p,
        nt.Options(solver="schur", schur_family=nt.Euclidean(3),
                   iterator=nt.LEVENBERG_MARQUARDT),
    )
    assert result.best_cost < 1e-15


def test_implicit_schur_stepped_driver():
    """The stepped driver (Python outer loop + jitted assemble/solve) on the
    implicit backend: the outer loop on the host, jitted assemble and solve."""
    p, cams, lmks = make_affine_ba(6, 20, 0.5)
    perturb_ba(p, lmks, 0.01, seed=3)
    result = nt.optimize(
        p,
        nt.Options(solver="schur_cg", schur_family=LMK,
                   iterator=nt.LEVENBERG_MARQUARDT),
        callback=nt.null_callback,  # forces the stepped driver
    )
    assert result.best_cost < 1e-15


def test_cg_fixed_iters_option():
    """``Options(cg_fixed_iters=N)`` runs the implicit reduced PCG as a
    fixed-trip fori_loop and still reaches the reference cost target."""
    p, cams, lmks = make_affine_ba(6, 20, 0.5)
    perturb_ba(p, lmks, 0.01, seed=3)
    result = nt.optimize(
        p,
        nt.Options(
            solver="schur_cg", schur_family=LMK, cg_fixed_iters=80,
            iterator=nt.LEVENBERG_MARQUARDT,
        ),
    )
    assert result.best_cost < 1e-15


def test_giant_implicit_auto_fixed_cg(monkeypatch):
    """Fully-jitted implicit programs above the giant-observation limit get
    the fixed-trip CG automatically; the option still converges to the reference target."""
    from nllstpu.core import optimize as opt

    monkeypatch.setattr(opt, "GIANT_IMPLICIT_OBS_LIMIT", 1)
    p, cams, lmks = make_affine_ba(6, 20, 0.5)
    perturb_ba(p, lmks, 0.01, seed=3)
    result = nt.optimize(
        p, nt.Options(solver="schur_cg", schur_family=LMK)
    )
    assert result.best_cost < 1e-15


def test_dual_assembly_matches_dense_mixed_fixing():
    """The dual-sorted direct assembly (obs-major + camera-major repacks,
    blocks composed from the Jacobian) must reproduce the dense-backend
    normal equations through the damped solve, including robust kernels and
    dustbin routing for fixed cameras AND fixed landmarks."""
    from nllstpu.models.ba import make_pinhole_ba

    p, cams, lmks = make_pinhole_ba(
        6, 41, 0.6, dtype=jnp.float64, batched="cm", robust_width=0.001
    )
    perturb_ba(p, lmks, 0.05, seed=7)
    unfixed = cams[1:] + lmks[2:]  # one camera and two landmarks fixed
    cd = compile_problem(
        p, unfixed, solver="schur", schur_family=nt.Euclidean(3)
    )
    fast = cd.schur_info.fast[0]
    assert fast is not None and fast.obs_k is not None
    assert fast.cam_batch is not None  # the dual path is actually active
    pd = compile_problem(p, unfixed, solver="dense")
    v = p.stacked_variables()
    c_s, sys_s = jax.jit(cd.assemble)(v)
    c_d, (a, g) = jax.jit(pd.assemble)(v)
    np.testing.assert_allclose(float(c_s), float(c_d), rtol=1e-14)
    lam = 0.1
    x_s = np.asarray(cd.schur_info.ops().solve(sys_s, jnp.float64(lam)))
    x_d = np.linalg.solve(
        np.asarray(a) + lam * np.eye(a.shape[0]), np.asarray(g)
    )
    # Schur's layout orders landmarks last (order_last), which matches the
    # dense layout's family order here — compare elementwise so sign /
    # permutation errors cannot cancel in a norm.
    np.testing.assert_allclose(x_s, x_d, atol=1e-12)


def test_cluster_jacobi_blocks_exact():
    """Cluster-Jacobi preconditioner blocks must equal the exact diagonal
    CLUSTER blocks of the damped reduced matrix S(λ) formed explicitly by
    the direct backend (Ceres CLUSTER_JACOBI analogue), and the
    cluster-preconditioned CG must converge to the direct solver's step."""
    import dataclasses

    from nllstpu.core.linearsolver import batched_inv_spd_cm
    from nllstpu.models.ba import make_pinhole_ba

    p, cams, lmks = make_pinhole_ba(8, 63, 0.6, dtype=jnp.float64, batched="cm")
    perturb_ba(p, lmks, 0.05, seed=7)
    ci = compile_problem(p, solver="schur_cg", schur_family=nt.Euclidean(3))
    cd = compile_problem(p, solver="schur", schur_family=nt.Euclidean(3))
    v = p.stacked_variables()
    _, sys_i = jax.jit(ci.assemble)(v)
    _, sys_d = jax.jit(cd.assemble)(v)
    ops = dataclasses.replace(ci.schur_info.ops(), cluster_size=3)
    cl = ops._cluster_layout()
    assert cl is not None
    lam = 1e-3
    a_rr, _, h_ll, _, w = sys_d
    h_inv = batched_inv_spd_cm(h_ll + lam * jnp.eye(3)[:, :, None])
    y = jnp.einsum("dlr,del->elr", w, h_inv)
    s = a_rr + lam * jnp.eye(a_rr.shape[0]) - jnp.einsum("elr,els->rs", y, w)
    cinv = np.asarray(ops.cluster_inverses(sys_i, jnp.float64(lam), h_inv, cl))
    n_cl, m, dof, cdim, n_r = cl
    S = np.asarray(s)
    for cix in range(n_cl):
        a, b = cix * cdim, min((cix + 1) * cdim, S.shape[0])
        blk = np.eye(cdim) * (1.0 + lam)  # pad rows: identity + damping
        blk[: b - a, : b - a] = S[a:b, a:b]
        np.testing.assert_allclose(
            cinv[cix], np.linalg.inv(blk), rtol=1e-8, atol=1e-10
        )
    x_ref = np.asarray(cd.schur_info.ops().solve(sys_d, jnp.float64(lam)))
    x_cl = np.asarray(
        dataclasses.replace(ops, tol=1e-14, max_iters=4000).solve(
            sys_i, jnp.float64(lam)
        )
    )
    np.testing.assert_allclose(x_cl, x_ref, atol=1e-10)


def test_cluster_jacobi_option_converges():
    """``Options(schur_cluster_size=m)`` end to end: reaches the reference
    cost target and under a fixed inner budget converges at least as fast
    as per-camera Schur-Jacobi."""
    import dataclasses

    from nllstpu.models.ba import make_pinhole_ba

    p, cams, lmks = make_pinhole_ba(8, 63, 0.6, dtype=jnp.float64, batched="cm")
    perturb_ba(p, lmks, 0.05, seed=7)
    ci = compile_problem(p, solver="schur_cg", schur_family=nt.Euclidean(3))
    v = p.stacked_variables()
    _, sys_i = jax.jit(ci.assemble)(v)
    exact = dataclasses.replace(ci.schur_info.ops(), max_iters=4000, tol=1e-14)
    sj = dataclasses.replace(ci.schur_info.ops(), max_iters=6)
    clp = dataclasses.replace(ci.schur_info.ops(), max_iters=6, cluster_size=3)
    e_sj = e_cl = 0.0
    for lam in [1e-2, 1e-1, 1.0]:
        xt = np.asarray(exact.solve(sys_i, jnp.float64(lam)))
        sc = np.linalg.norm(xt)
        e_sj += np.linalg.norm(np.asarray(sj.solve(sys_i, jnp.float64(lam))) - xt) / sc
        e_cl += np.linalg.norm(np.asarray(clp.solve(sys_i, jnp.float64(lam))) - xt) / sc
    assert e_cl <= e_sj * 1.05
    r = nt.optimize(
        p,
        nt.Options(
            solver="schur_cg", schur_family=nt.Euclidean(3),
            schur_cluster_size=4,
        ),
    )
    assert r.best_cost < 1e-20


def test_chunked_cg_matches_dynamic():
    """cg_chunk_iters (while over fori blocks — the giant-program recipe
    that can still stop early) must reproduce the dynamic while-loop PCG."""
    import dataclasses

    p, cams, lmks = make_affine_ba(5, 12, 0.7)
    perturb_ba(p, lmks, 0.05, seed=3)
    perturb_ba(p, cams, 0.05, seed=4)
    implicit = compile_problem(p, solver="schur_cg", schur_family=LMK)
    variables = p.stacked_variables()
    _, sys_i = jax.jit(implicit.assemble)(variables)
    iops = implicit.schur_info.ops()
    chunked = dataclasses.replace(iops, chunk_iters=7)
    fixed = dataclasses.replace(iops, fixed_iters=200)
    for lam in [1e-3, 1.0]:
        # All PCG variants solve to the same residual tolerance; solution
        # agreement is tolerance-level, not bitwise (different loop
        # structures compile to different fusions).
        xd = jax.jit(iops.solve)(sys_i, jnp.asarray(lam))
        xc = jax.jit(chunked.solve)(sys_i, jnp.asarray(lam))
        xf = jax.jit(fixed.solve)(sys_i, jnp.asarray(lam))
        np.testing.assert_allclose(xc, xd, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(xf, xd, rtol=1e-5, atol=1e-9)


def test_giant_implicit_auto_chunking(monkeypatch):
    """Boundary behavior at GIANT_IMPLICIT_OBS_LIMIT: fully-jitted implicit
    programs above the limit auto-select chunked CG (innermost fori — the
    worker-fault mitigation that can still stop early); at or below they
    keep the dynamic while loop.  The limit is monkeypatched small so the
    test problem stays tiny."""
    import dataclasses as dc

    from nllstpu.core import optimize as opt_mod

    captured = []
    real_ctx = opt_mod.CompiledProblem.ctx

    def spy_ctx(self, options=None):
        captured.append(options)
        return real_ctx(self, options)

    monkeypatch.setattr(opt_mod.CompiledProblem, "ctx", spy_ctx)

    def run(limit):
        monkeypatch.setattr(opt_mod, "GIANT_IMPLICIT_OBS_LIMIT", limit)
        captured.clear()
        p, cams, lmks = make_affine_ba(5, 12, 0.7)
        perturb_ba(p, lmks, 0.01, seed=3)
        compiled = compile_problem(p, solver="schur_cg", schur_family=LMK)
        n_obs = sum(b.n_padded for b in compiled.batches)
        runner = opt_mod._JitRunner(
            compiled, nt.Options(iterator=nt.LEVENBERG_MARQUARDT, max_iters=5)
        )
        _, outs = runner.start(p.stacked_variables(), 5)
        stats = np.asarray(outs[-1])
        assert stats[1] < stats[0]  # descends either way
        return n_obs, captured[-1]

    n_obs, opts_big = run(limit=8)  # n_obs > 8 → giant path
    assert n_obs > 8
    assert opts_big.cg_chunk_iters == opt_mod._GIANT_IMPLICIT_CG_CHUNK
    _, opts_small = run(limit=10_000_000)
    assert opts_small.cg_chunk_iters is None


def test_w_dtype_bf16_knob(monkeypatch):
    """NLLSTPU_W_DTYPE=bf16 stores the dense W coupling in bfloat16 for f32
    problems (and is ignored for f64): the assembled sys carries a bf16 W,
    the damped solve still returns f32 steps close to the f32 reference,
    and a full LM run converges to a comparable cost."""
    from nllstpu.models.ba import make_pinhole_ba

    def fresh(dtype):
        p, cams, lmks = make_pinhole_ba(
            ncameras=6, nlandmarks=40, prop_visible=0.7, noise=1e-3,
            dtype=dtype, batched="cm",
        )
        perturb_ba(p, lmks, 0.03, seed=11)
        return p

    opts = nt.Options(solver="schur", schur_family=LMK, max_iters=25)

    monkeypatch.delenv("NLLSTPU_W_DTYPE", raising=False)
    p = fresh(jnp.float32)
    c = compile_problem(p, solver="schur", schur_family=LMK)
    _, sys_f32 = jax.jit(c.assemble)(p.stacked_variables())
    x_ref = np.asarray(c.schur_info.ops().solve(sys_f32, jnp.asarray(1e-2)))
    r_ref = nt.optimize(fresh(jnp.float32), opts)

    monkeypatch.setenv("NLLSTPU_W_DTYPE", "bf16")
    p = fresh(jnp.float32)
    c = compile_problem(p, solver="schur", schur_family=LMK)
    _, sys_bf = jax.jit(c.assemble)(p.stacked_variables())
    assert sys_bf[4].dtype == jnp.bfloat16
    assert sys_bf[0].dtype == jnp.float32  # only W is downcast
    x_bf = np.asarray(c.schur_info.ops().solve(sys_bf, jnp.asarray(1e-2)))
    assert x_bf.dtype == np.float32
    # bf16 W perturbs the step by O(2^-8) relative, not more.
    denom = max(1e-12, float(np.linalg.norm(x_ref)))
    assert np.linalg.norm(x_bf - x_ref) / denom < 0.05
    r_bf = nt.optimize(fresh(jnp.float32), opts)
    # Converges to the same basin; costs agree loosely (bf16 steps).
    assert float(r_bf.best_cost) < 2.0 * max(float(r_ref.best_cost), 1e-8)

    # f64 problems ignore the knob entirely (reference 1e-15 targets).
    p64 = fresh(jnp.float64)
    c64 = compile_problem(p64, solver="schur", schur_family=LMK)
    _, sys_64 = jax.jit(c64.assemble)(p64.stacked_variables())
    assert sys_64[4].dtype == jnp.float64


def test_flat_lm_fused_trial_matches():
    """Options(fused_trial=True): LM trials evaluate a full assemble whose
    cost output drives the accept decision; the trajectory must match the
    cost-only machine exactly on the autodiff path (affine BA — the trial
    cost is the same residual evaluation either way)."""
    import nllstpu as nt
    from nllstpu.models.ba import make_affine_ba, perturb_ba

    def run(fused):
        p, cams, lmks = make_affine_ba(6, 30, 0.6)
        perturb_ba(p, lmks, 0.05, seed=9)
        return nt.optimize(
            p,
            nt.Options(
                solver="schur", schur_family=nt.Euclidean(3),
                iterator=nt.LEVENBERG_MARQUARDT, max_iters=25,
                fused_trial=fused,
            ),
        )

    r_ref = run(False)
    r_f = run(True)
    assert int(r_f.num_iterations) == int(r_ref.num_iterations)
    assert int(r_f.cost_computations) == int(r_ref.cost_computations)
    np.testing.assert_allclose(
        float(r_f.best_cost), float(r_ref.best_cost), rtol=1e-12
    )
    # fused: one assemble per trial (both counters also include the
    # pre-loop initial evaluation); cost-only: one assemble per completed
    # iteration.
    assert int(r_f.gradient_computations) == int(r_f.cost_computations)
    assert int(r_ref.gradient_computations) <= int(r_ref.cost_computations)


def test_flat_lm_fused_trial_pinhole_converges():
    """fused_trial with the hand-Jacobian pinhole batch (trial costs may
    differ in ulps from the cost-only pass): still converges to the same
    basin."""
    import nllstpu as nt
    from nllstpu.models.ba import make_pinhole_ba, perturb_ba

    def run(fused):
        p, cams, lmks = make_pinhole_ba(
            ncameras=6, nlandmarks=40, prop_visible=0.6, noise=1e-3,
            dtype=jnp.float64, batched="cm",
        )
        perturb_ba(p, lmks, 0.03, seed=7)
        return nt.optimize(
            p,
            nt.Options(
                solver="schur", schur_family=nt.Euclidean(3),
                iterator=nt.LEVENBERG_MARQUARDT, max_iters=25,
                fused_trial=fused,
            ),
        )

    r_ref = run(False)
    r_f = run(True)
    np.testing.assert_allclose(
        float(r_f.best_cost), float(r_ref.best_cost), rtol=1e-8
    )


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in ``jaxpr`` and its
    sub-jaxprs."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_dot_precisions(sub))
    return out


@pytest.mark.parametrize("method", ["solve", "quad", "solve0_quad_grad"])
def test_f32_schur_ops_pin_every_precision(method):
    """No contraction of the f32 direct Schur ops is left at the backend's
    default precision, which on the GPU may be TF32 (~1e-3 relative)."""
    from nllstpu.models.ba import make_pinhole_ba

    p, _, lmks = make_pinhole_ba(ncameras=4, nlandmarks=12, dtype=jnp.float32,
                                 batched="cm")
    perturb_ba(p, lmks, 0.03, seed=2)
    c = compile_problem(p, solver="schur", schur_family=LMK)
    ops = c.schur_info.ops()
    _, sys_ = jax.jit(c.assemble)(p.stacked_variables())
    args = {
        "solve": (sys_, jnp.float32(1e-3)),
        "quad": (sys_, jnp.ones(ops.dim, jnp.float32)),
        "solve0_quad_grad": (sys_,),
    }[method]
    precisions = _dot_precisions(
        jax.make_jaxpr(getattr(ops, method))(*args).jaxpr
    )
    assert precisions and None not in precisions


def test_f32_schur_step_matches_f64_dense():
    """The f32 direct Schur step, at its pinned precisions, against the f64
    dense step of the same long-tailed BAL problem (the reference)."""
    from chip_smoke import step_by_variable
    from nllstpu.models import bal

    d = bal.make_realistic_bal(ncameras=12, npoints=300, seed=2, noise=1e-3)
    steps, lam = {}, None
    for dtype, solver in ((jnp.float64, "dense"), (jnp.float32, "schur")):
        p, _, pts = bal.make_bal_problem(d, dtype=dtype)
        perturb_ba(p, pts, 0.02, seed=3)
        c = compile_problem(p, solver=solver, schur_family=bal.PT)
        ops = c.schur_info.ops() if solver == "schur" else DenseOps(
            c.layout.dof_total)
        _, sys_ = jax.jit(c.assemble)(p.stacked_variables())
        if lam is None:
            lam = 1e-4 * float(ops.diag_max(sys_))
        steps[solver] = step_by_variable(c, ops.solve(sys_, dtype(lam)))
    xs, xd = steps["schur"], steps["dense"]
    cos = xs @ xd / (np.linalg.norm(xs) * np.linalg.norm(xd))
    # Seen on the CPU: 1 - cos ~4e-11, relative difference ~9e-6 (f32
    # round-off of the assembly and solve).
    assert cos > 1 - 1e-8
    assert np.linalg.norm(xs - xd) / np.linalg.norm(xd) < 1e-4
