"""Adaptive robustifier end-to-end, mirroring
/root/reference/test/adaptivecost.jl: a ContaminatedGaussian kernel whose
3 parameters are jointly optimized with two means over a contaminated sample,
then the same fit via EM-alternation driven from a callback (the kernel
variable fixed for the inner Newton solves)."""

import numpy as np
import jax.numpy as jnp

import nllstpu as nt

KERNEL = nt.ContaminatedGaussian()
SCALAR = nt.Scalar()


def mean_residual(data, mean):
    return mean - data


def make_problem():
    rng = np.random.default_rng(1)
    points = np.concatenate([rng.normal(0, 1, 800), rng.normal(0, 10, 200)])
    p = nt.Problem()
    kvar = p.add_variable(
        KERNEL.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6)
    )
    m1 = p.add_variable(SCALAR, 0.0)
    m2 = p.add_variable(SCALAR, 0.0)
    for pt in points:
        p.add_cost(mean_residual, (kvar, m1), params=pt - 1.0, kernel=KERNEL)
        p.add_cost(mean_residual, (kvar, m2), params=pt + 1.0, kernel=KERNEL)
    return p, kvar, m1, m2, points


def check(p, kvar, m1, m2):
    sw = np.asarray(
        nt.ContaminatedGaussian.sigmas_weight(jnp.asarray(p.get_value(kvar)))
    )
    np.testing.assert_allclose(sw, [1.0, 10.0, 0.8], rtol=0.12)
    np.testing.assert_allclose(float(p.get_value(m1)), -1.0, rtol=0.1)
    np.testing.assert_allclose(float(p.get_value(m2)), 1.0, rtol=0.1)


def test_joint_lm():
    p, kvar, m1, m2, _ = make_problem()
    nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    check(p, kvar, m1, m2)


def test_em_alternation():
    p, kvar, m1, m2, points = make_problem()
    kfam = kvar.family
    sfam = m1.family
    data1 = jnp.asarray(points - 1.0)
    data2 = jnp.asarray(points + 1.0)

    def em_callback(cost, ctx):
        # Squared errors of every residual at the trial means
        # (test/adaptivecost.jl:15-25).
        means = ctx.variables[sfam]
        sq = jnp.concatenate(
            [(means[0] - data1) ** 2, (means[1] - data2) ** 2]
        )
        kparams = ctx.variables[kfam][0]
        new_kparams = nt.em_fit(kparams, sq)
        ctx.variables[kfam] = ctx.variables[kfam].at[0].set(new_kparams)
        new_cost = float(ctx.cost_fn(ctx.variables))
        return new_cost, 0

    # Kernel fixed for the Newton solves; EM updates it between iterations.
    nt.optimize(
        p,
        nt.Options(iterator=nt.NEWTON),
        unfixed=[m1, m2],
        callback=em_callback,
    )
    check(p, kvar, m1, m2)


def test_scaled_adaptive_kernel():
    """Scaled over an ADAPTIVE kernel (reference Scaled{T,R} wraps any
    robustifier, src/robust.jl:22-31): joint optimization with
    Scaled(ContaminatedGaussian, h) recovers the same mixture parameters,
    and the kernel keeps behaving as an adaptive variable."""
    scaled = nt.Scaled(KERNEL, 2.0)
    assert isinstance(scaled, nt.AdaptiveRobustifier)
    assert scaled.manifold == KERNEL.manifold

    rng = np.random.default_rng(1)
    points = np.concatenate([rng.normal(0, 1, 800), rng.normal(0, 10, 200)])
    p = nt.Problem()
    kvar = p.add_variable(
        scaled.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6)
    )
    m1 = p.add_variable(SCALAR, 0.0)
    for pt in points:
        p.add_cost(mean_residual, (kvar, m1), params=pt - 1.0, kernel=scaled)
    nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    sw = np.asarray(
        nt.ContaminatedGaussian.sigmas_weight(jnp.asarray(p.get_value(kvar)))
    )
    # The ×2 height doubles every term of the robustified NLL uniformly, so
    # the optimum is unchanged (weight slightly less tight than unscaled).
    np.testing.assert_allclose(sw, [1.0, 10.0, 0.8], rtol=0.15)
    np.testing.assert_allclose(float(p.get_value(m1)), -1.0, rtol=0.1)


def test_adaptive_cm_batch_matches_per_cost():
    """batched='cm' adaptive batches (kernel slot gathered components-major,
    derivative blocks via rho_dkernel_cm) must match the per-cost vmapped
    path exactly: cost, dense normal equations, converged optimum."""
    import jax
    from nllstpu.core.optimize import compile_problem

    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(0, 1, 400), rng.normal(0, 10, 100)])
    n = pts.shape[0]

    def build(cm):
        p = nt.Problem()
        kvar = p.add_variable(
            KERNEL.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.6)
        )
        m = p.add_variable(SCALAR, 0.0)
        if cm:
            def res_cm(params, m_cm):
                return m_cm - params.T

            p.add_cost_batch(
                res_cm,
                slots=[
                    (KERNEL.manifold, np.zeros(n, np.int32)),
                    (SCALAR, np.zeros(n, np.int32)),
                ],
                params=(pts - 1.0)[:, None],
                kernel=KERNEL,
                batched="cm",
            )
        else:
            for pt in pts:
                p.add_cost(mean_residual, (kvar, m), params=pt - 1.0,
                           kernel=KERNEL)
        return p, kvar, m

    p_cm, k1, m1 = build(True)
    p_ref, k2, m2 = build(False)
    c_cm, c_ref = compile_problem(p_cm), compile_problem(p_ref)
    v_cm, v_ref = p_cm.stacked_variables(), p_ref.stacked_variables()
    np.testing.assert_allclose(
        float(jax.jit(c_cm.cost)(v_cm)), float(jax.jit(c_ref.cost)(v_ref)),
        rtol=1e-13,
    )
    _, (a1, b1) = jax.jit(c_cm.assemble)(v_cm)
    _, (a2, b2) = jax.jit(c_ref.assemble)(v_ref)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b1), np.asarray(b2),
                               rtol=1e-10, atol=1e-12)
    r1, r2 = nt.optimize(p_cm), nt.optimize(p_ref)
    np.testing.assert_allclose(r1.best_cost, r2.best_cost, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(p_cm.get_value(k1)), np.asarray(p_ref.get_value(k2)),
        rtol=1e-6,
    )


def test_adaptive_bal_schur_fast_path():
    """Adaptive BA on the Schur fast path: a
    (kernel, camera, point) cm batch with ONE shared ContaminatedGaussian
    rides the dual-sorted assembly — kernel blocks land via single
    reductions (kk/g_k sums, per-camera one-hot cross, per-landmark run
    sums into W's kernel columns) — and must match the generic per-cost
    scatter path: assembled system, damped solve, converged optimum and
    recovered mixture parameters."""
    import jax
    import jax.numpy as jnp
    from nllstpu.core.optimize import compile_problem
    from nllstpu.models import bal
    from nllstpu.models.ba import perturb_ba

    kp0 = nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8)
    d = bal.make_synthetic_bal(6, 64, obs_per_point=4, noise=1e-3)
    rng = np.random.default_rng(3)
    out = rng.choice(len(d["pt_idx"]), size=len(d["pt_idx"]) // 10,
                     replace=False)
    d["observations"][out] += 50.0

    def build(batched):
        p, cams, pts, kh = bal.make_bal_problem(
            d, kernel=KERNEL, kernel_params=kp0, batched=batched
        )
        perturb_ba(p, pts, 0.01, seed=7)
        return p, kh

    p_cm, k1 = build("cm")
    p_ref, k2 = build(False)
    c_cm = compile_problem(p_cm, solver="schur", schur_family=bal.PT)
    c_ref = compile_problem(p_ref, solver="schur", schur_family=bal.PT)
    f = c_cm.schur_info.fast[0]
    assert f is not None and f.kernel_rows is not None and f.obs_k is not None
    v_cm, v_ref = p_cm.stacked_variables(), p_ref.stacked_variables()
    _, sys1 = jax.jit(c_cm.assemble)(v_cm)
    _, sys2 = jax.jit(c_ref.assemble)(v_ref)
    for name, x, y in zip("a_rr b_r h_ll g_l w".split(), sys1, sys2):
        np.testing.assert_allclose(
            np.asarray(x), np.asarray(y), rtol=1e-8,
            atol=1e-8 * max(1.0, float(np.abs(np.asarray(y)).max())),
            err_msg=name,
        )
    lam = jnp.asarray(1e-2, p_cm.dtype)
    x1 = c_cm.ctx().linops.solve(sys1, lam)
    x2 = c_ref.ctx().linops.solve(sys2, lam)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2),
                               rtol=1e-6, atol=1e-9)
    o = nt.Options(solver="schur", schur_family=bal.PT, max_iters=60)
    r1, r2 = nt.optimize(p_cm, o), nt.optimize(p_ref, o)
    np.testing.assert_allclose(r1.best_cost, r2.best_cost, rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(p_cm.get_value(k1)), np.asarray(p_ref.get_value(k2)),
        rtol=1e-5,
    )


def test_adaptive_barron_cm():
    """Barron adaptive kernel through the cm fast path (rho_dkernel_cm is
    generic forward-over-forward): joint fit converges and matches the
    per-cost path."""
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(0, 1, 300), rng.normal(0, 20, 60)])
    n = pts.shape[0]
    barron = nt.Barron()
    kp0 = nt.Barron.make_params(1.0, 1.0)

    def build(cm):
        p = nt.Problem()
        kvar = p.add_variable(barron.manifold, kp0)
        m = p.add_variable(SCALAR, 0.5)
        if cm:
            def res_cm(params, m_cm):
                return m_cm - params.T

            p.add_cost_batch(
                res_cm,
                slots=[
                    (barron.manifold, np.zeros(n, np.int32)),
                    (SCALAR, np.zeros(n, np.int32)),
                ],
                params=pts[:, None],
                kernel=barron,
                batched="cm",
            )
        else:
            for pt in pts:
                p.add_cost(mean_residual, (kvar, m), params=pt, kernel=barron)
        return p, kvar, m

    p_cm, k1, m1 = build(True)
    p_ref, k2, m2 = build(False)
    r1, r2 = nt.optimize(p_cm), nt.optimize(p_ref)
    np.testing.assert_allclose(r1.best_cost, r2.best_cost, rtol=1e-7)
    np.testing.assert_allclose(
        float(p_cm.get_value(m1)), float(p_ref.get_value(m2)), atol=1e-5
    )
