"""Bulk ingestion APIs must be exactly equivalent to per-item calls."""

import numpy as np
import pytest

import nllstpu as nt
from nllstpu.core.optimize import compile_problem


def residual(meas, a, b):
    return a * b[0] - meas


def test_bulk_equivalent_to_single():
    rng = np.random.default_rng(0)
    scalars = rng.standard_normal(5)
    vecs = rng.standard_normal((4, 2))
    ia = rng.integers(0, 5, size=12).astype(np.int32)
    ib = rng.integers(0, 4, size=12).astype(np.int32)
    meas = rng.standard_normal(12)

    p1 = nt.Problem()
    hs = [p1.add_variable(nt.Scalar(), v) for v in scalars]
    hv = [p1.add_variable(nt.Euclidean(2), v) for v in vecs]
    for k in range(12):
        p1.add_cost(residual, (hs[ia[k]], hv[ib[k]]), params=meas[k])

    p2 = nt.Problem()
    p2.add_variables(nt.Scalar(), scalars)
    p2.add_variables(nt.Euclidean(2), vecs)
    p2.add_cost_batch(
        residual, slots=[(nt.Scalar(), ia), (nt.Euclidean(2), ib)], params=meas
    )

    assert p1.num_costs() == p2.num_costs() == 12
    np.testing.assert_allclose(nt.cost(p1), nt.cost(p2), rtol=1e-15)
    c1 = compile_problem(p1)
    c2 = compile_problem(p2)
    v1, v2 = p1.stacked_variables(), p2.stacked_variables()
    cost1, (a1, b1) = c1.assemble(v1)
    cost2, (a2, b2) = c2.assemble(v2)
    np.testing.assert_allclose(a1, a2, rtol=1e-14)
    np.testing.assert_allclose(b1, b2, rtol=1e-14)
    counts1 = p1.var_cost_counts()
    counts2 = p2.var_cost_counts()
    for k in counts1:
        np.testing.assert_array_equal(counts1[k], counts2[k])


def test_mixed_single_and_bulk():
    p = nt.Problem()
    x = p.add_variable(nt.Scalar(), 1.0)
    v = p.add_variable(nt.Euclidean(2), np.array([2.0, 3.0]))
    p.add_cost(residual, (x, v), params=0.5)
    p.add_cost_batch(
        residual,
        slots=[(nt.Scalar(), np.array([0, 0])), (nt.Euclidean(2), np.array([0, 0]))],
        params=np.array([1.0, 2.0]),
    )
    assert p.num_costs() == 3
    # 3 residuals: 1·2−0.5, 1·2−1, 1·2−2 → ½(1.5² + 1² + 0²) = 1.625
    np.testing.assert_allclose(nt.cost(p), 0.5 * (1.5**2 + 1.0**2 + 0.0**2))


def test_varcostmap_coo():
    """Full incidence export (reference updatevarcostmap!/getvarcostmap,
    src/problem.jl:124-175): COO pairs per family, cost ids global in
    batches() order, matching a hand-built incidence."""
    rng = np.random.default_rng(1)
    ia = rng.integers(0, 5, size=9).astype(np.int32)
    ib = rng.integers(0, 4, size=9).astype(np.int32)
    p = nt.Problem()
    hs = [p.add_variable(nt.Scalar(), 0.1 * k) for k in range(5)]
    p.add_variables(nt.Euclidean(2), rng.standard_normal((4, 2)))
    # Mixed ingestion: 3 singles then a 6-row chunk, same group.
    for k in range(3):
        p.add_cost(residual, (hs[ia[k]], nt.VarHandle(nt.Euclidean(2), int(ib[k]))),
                   params=float(k))
    p.add_cost_batch(residual, slots=[(nt.Scalar(), ia[3:]), (nt.Euclidean(2), ib[3:])],
                     params=np.zeros(6))
    coo = p.varcostmap()
    vs, cs = coo[nt.family_name(nt.Scalar())]
    np.testing.assert_array_equal(vs, ia)
    np.testing.assert_array_equal(cs, np.arange(9))
    ve, ce = coo[nt.family_name(nt.Euclidean(2))]
    np.testing.assert_array_equal(ve, ib)
    np.testing.assert_array_equal(ce, np.arange(9))
    counts = p.var_cost_counts()
    np.testing.assert_array_equal(
        counts[nt.family_name(nt.Scalar())], np.bincount(ia, minlength=5)
    )


def test_subproblem_preserves_jacobian_and_batched():
    """subproblem keeps the group's hand jacobian and batched layout (a
    rebound per-cost function would be silently wrong/slow)."""
    rng = np.random.default_rng(2)

    def bres(meas, a, b):
        return a[:, None] * b - meas  # batched: whole [B] / [B,2] arrays

    def bjac(meas, a, b):
        import jax.numpy as jnp

        r = a[:, None] * b - meas
        B = r.shape[0]
        ja = b[:, :, None]  # dr/da [B, 2, 1]
        jb = jnp.tile(jnp.eye(2)[None], (B, 1, 1)) * a[:, None, None]
        return r, jnp.concatenate([ja, jb], axis=2)

    ia = rng.integers(0, 3, size=10).astype(np.int32)
    ib = rng.integers(0, 4, size=10).astype(np.int32)
    meas = rng.standard_normal((10, 2))
    p = nt.Problem()
    p.add_variables(nt.Scalar(), rng.standard_normal(3))
    p.add_variables(nt.Euclidean(2), rng.standard_normal((4, 2)))
    p.add_cost_batch(
        bres,
        slots=[(nt.Scalar(), ia), (nt.Euclidean(2), ib)],
        params=meas,
        jacobian=bjac,
        batched=True,
    )
    target = nt.VarHandle(nt.Scalar(), 1)
    sub = p.subproblem(target)
    g = sub._groups[next(iter(sub._groups))]
    assert g.jacobian is bjac and g.batched is True
    assert sub.num_costs() == int((ia == 1).sum())
    # Sub cost equals the masked share of the full cost.
    a_all = p.stacked_variables()[nt.family_name(nt.Scalar())]
    b_all = p.stacked_variables()[nt.family_name(nt.Euclidean(2))]
    r = np.asarray(a_all)[ia][:, None] * np.asarray(b_all)[ib] - meas
    expect = 0.5 * (r[ia == 1] ** 2).sum()
    np.testing.assert_allclose(nt.cost(sub), expect, rtol=1e-12)


def test_subproblem_scales():
    """Subproblem of a 1M-obs problem in < 1s
    (vectorized mask selection, no per-cost Python)."""
    import time

    rng = np.random.default_rng(3)
    n = 1_000_000
    ia = rng.integers(0, 1000, size=n).astype(np.int32)
    ib = rng.integers(0, 5000, size=n).astype(np.int32)
    p = nt.Problem()
    p.add_variables(nt.Scalar(), rng.standard_normal(1000))
    p.add_variables(nt.Euclidean(2), rng.standard_normal((5000, 2)))
    p.add_cost_batch(
        residual, slots=[(nt.Scalar(), ia), (nt.Euclidean(2), ib)],
        params=rng.standard_normal(n),
    )
    # Best-of-3: the operation is ~10 ms, but a single cold timing under
    # background machine load has been seen at >1 s — the criterion is the
    # algorithm's scaling, not one wall-clock sample.
    dt = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sub = p.subproblem(nt.VarHandle(nt.Scalar(), 7))
        dt = min(dt, time.perf_counter() - t0)
    assert sub.num_costs() == int((ia == 7).sum())
    assert dt < 1.0, f"subproblem took {dt:.2f}s"


def test_million_variable_construction_and_lowering():
    """BAL-ingest scale: 1M landmark variables + 1M observations must
    construct and lower (``compile_problem`` — layout, batches, Schur info)
    in bounded wall time with no per-variable Python loops.  Guards the
    vectorized ``build_layout`` offset assignment (round-2 weak item: the
    per-variable loop cost seconds of host time per compile at this
    scale)."""
    import time

    from nllstpu.core.optimize import compile_problem

    rng = np.random.default_rng(11)
    nl, nc = 1_000_000, 64
    p = nt.Problem()
    cam = nt.Euclidean(2)
    lmk = nt.Euclidean(3)
    p.add_variables(cam, rng.standard_normal((nc, 2)))
    p.add_variables(lmk, rng.standard_normal((nl, 3)))
    il = np.arange(nl, dtype=np.int32)
    ic = (il % nc).astype(np.int32)

    def res(meas, c, l):
        return c[0] * l + c[1] - meas

    p.add_cost_batch(
        res,
        slots=[(cam, ic), (lmk, il)],
        params=rng.standard_normal((nl, 3)),
    )
    t0 = time.perf_counter()
    compiled = compile_problem(p, solver="schur", schur_family=lmk)
    dt = time.perf_counter() - t0
    assert compiled.layout.dof_total == nc * 2 + nl * 3
    off = np.asarray(compiled.layout.offsets[nt.family_name(lmk)])
    # Landmarks are ordered last (Schur) with contiguous 3-dof offsets.
    assert off[0] == nc * 2 and off[-1] == nc * 2 + (nl - 1) * 3
    assert dt < 30.0, f"compile_problem took {dt:.1f}s at 1M variables"


def test_subproblem_view_swaps_without_recompile():
    """Reference ``subproblem!`` parity (src/problem.jl:47-83): one
    SubproblemView compiled once, two subset swaps run through the SAME
    traced program (trace_count stays 1), and each swap optimizes exactly
    the selected costs (matches a fresh per-subset subproblem)."""
    rng = np.random.default_rng(4)
    sc = nt.Scalar()
    meas = rng.standard_normal(24)
    ia = (np.arange(24) % 6).astype(np.int32)

    def build():
        p = nt.Problem()
        p.add_variables(sc, np.zeros(6))
        p.add_cost_batch(
            lambda t, x: x - t, slots=[(sc, ia)], params=meas
        )
        return p

    opts = nt.Options(iterator=nt.LEVENBERG_MARQUARDT, max_iters=25)
    p = build()
    view = nt.SubproblemView(p)

    # Swap 1: costs touching variable 0 only.
    r0 = view.select(nt.VarHandle(sc, 0)).optimize(opts)
    assert view.trace_count == 1
    x = np.asarray(p.stacked_variables()[nt.family_name(sc)])
    np.testing.assert_allclose(x[0], meas[ia == 0].mean(), rtol=1e-9)
    # Unselected variables received exactly zero step.
    np.testing.assert_array_equal(x[1:], 0.0)

    # Swap 2: variable 3 — same program, new mask value.
    r3 = view.select(nt.VarHandle(sc, 3)).optimize(opts)
    assert view.trace_count == 1, "subset swap must not retrace"
    x = np.asarray(p.stacked_variables()[nt.family_name(sc)])
    np.testing.assert_allclose(x[3], meas[ia == 3].mean(), rtol=1e-9)
    assert r0.best_cost >= 0 and r3.best_cost >= 0

    # Matches the rebuild-per-subset path (Problem.subproblem).
    p2 = build()
    sub = p2.subproblem(nt.VarHandle(sc, 3))
    nt.optimize(sub, opts, unfixed=nt.VarHandle(sc, 3))
    np.testing.assert_allclose(
        np.asarray(p2.stacked_variables()[nt.family_name(sc)])[3],
        x[3],
        rtol=1e-9,
    )

    # cost() of the active subset, also swap-stable.
    view.select(nt.VarHandle(sc, 0))
    expect = 0.5 * ((x[0] - meas[ia == 0]) ** 2).sum()
    np.testing.assert_allclose(view.cost(), expect, rtol=1e-9)

    # Structure edits invalidate the view loudly.
    p.add_cost(lambda t, v: v - t, (nt.VarHandle(sc, 1),), params=0.5)
    with pytest.raises(ValueError):
        view.select(nt.VarHandle(sc, 0))


def test_subproblem_view_over_schur():
    """SubproblemView over the direct Schur backend:
    compile once, swap cost subsets as runtime masks with zero retraces,
    matching the rebuild-per-subset (Problem.subproblem) optimum — the
    dual-path fast assembly gates every contribution through the traced
    robust weights, and masks map through the obs-major/camera repack
    permutations."""
    from nllstpu.models import bal
    from nllstpu.models.ba import perturb_ba

    d = bal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3)
    opts = nt.Options(
        iterator=nt.LEVENBERG_MARQUARDT, max_iters=40,
        solver="schur", schur_family=bal.PT,
    )

    def build():
        p, cams, pts = bal.make_bal_problem(d)
        perturb_ba(p, pts, 0.01, seed=7)
        return p, cams, pts

    p, cams, pts = build()
    view = nt.SubproblemView(p, solver="schur", schur_family=bal.PT)
    # Sanity: the cm dual-path batch kept its fast tables.
    assert view.compiled.schur_info.fast[0] is not None

    # Swap 1: costs touching the first half of the landmarks.
    half = pts[: len(pts) // 2]
    r1 = view.select(half).optimize(opts)
    assert view.trace_count == 1
    x1 = np.asarray(p.stacked_variables()[nt.family_name(bal.PT)]).copy()

    # Reference: rebuild-per-subset on a fresh problem.
    p2, cams2, pts2 = build()
    sub = p2.subproblem(pts2[: len(pts2) // 2])
    r_ref = nt.optimize(sub, opts)
    x_ref = np.asarray(p2.stacked_variables()[nt.family_name(bal.PT)])
    np.testing.assert_allclose(r1.best_cost, r_ref.best_cost, rtol=1e-7)
    np.testing.assert_allclose(x1, x_ref, rtol=1e-5, atol=1e-8)

    # Swap 2: the other half — same traced program.
    r2 = view.select(pts[len(pts) // 2 :]).optimize(opts)
    assert view.trace_count == 1, "subset swap must not retrace"
    assert r2.best_cost < r2.start_cost

    # cost() restricted to the subset matches the subproblem cost at the
    # SAME (post-optimization) variable values.
    view.select(pts[: len(pts) // 2])
    p3, _, pts3 = build()
    p3.set_values(p.stacked_variables())
    np.testing.assert_allclose(
        view.cost(),
        nt.cost(p3.subproblem(pts3[: len(pts3) // 2])),
        rtol=1e-6,
    )
