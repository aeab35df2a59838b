"""End-to-end Rosenbrock optimization, mirroring
/root/reference/test/functional.jl: mixed ndeps-1/ndeps-2 residuals, one
robustified with Scaled∘Huber2o, convergence to (1, 1) under all four
iterators, callback/termination flags and cost-trajectory recording.
"""

import numpy as np
import pytest

import nllstpu as nt


def rosenbrock_a(a, x):
    # residual: a·(1 − x), robustified (test/functional.jl:12-15)
    return a * (1.0 - x)


def rosenbrock_b(b, x, y):
    # residual: b·(x² − y) (test/functional.jl:24)
    return b * (x * x - y)


KERNEL_A = nt.Scaled(nt.Huber2o(1.6), 1.0)


def make_problem(x0=0.0, y0=0.0):
    p = nt.Problem()
    x = p.add_variable(nt.Scalar(), x0)
    y = p.add_variable(nt.Scalar(), y0)
    p.add_cost(rosenbrock_a, (x,), params=1.0, kernel=KERNEL_A)
    p.add_cost(rosenbrock_b, (x, y), params=10.0)
    return p, x, y


def test_problem_construction():
    p, x, y = make_problem()
    assert p.num_variables() == 2
    assert p.num_costs() == 2
    # Initial cost = ½·ρ(1²) + ½·0² = 0.5 (test/functional.jl:38).
    np.testing.assert_allclose(nt.cost(p), 0.5)
    # varcostmap row sums (test/functional.jl:42): x touched by 2 costs, y by 1.
    counts = p.var_cost_counts()
    name = nt.family_name(nt.Scalar())
    np.testing.assert_array_equal(counts[name], [2, 1])


def test_subproblem():
    p, x, y = make_problem()
    # Subproblem keeping only costs touching y (test/functional.jl:45-48).
    sub = p.subproblem(lambda handles: any(h == y for h in handles))
    assert sub.num_costs() == 1
    np.testing.assert_allclose(nt.cost(sub), 0.0)


def test_callback_and_maxtime_termination():
    p, _, _ = make_problem()
    result = nt.optimize(
        p, nt.Options(max_time=0.0), callback=lambda c, ctx: (c, 13)
    )
    assert result.termination == (1 << 9) | (13 << 16)
    assert result.num_iterations == 1
    np.testing.assert_allclose(nt.cost(p), result.best_cost)


def test_jit_driver_maxtime_termination():
    """``jit_max_time=True`` enforces the wall clock INSIDE the jitted loop
    (host-clock io_callback per outer iteration); every other termination
    test is disabled so the time bit is the only exit."""
    p, _, _ = make_problem()
    result = nt.optimize(
        p,
        nt.Options(
            max_iters=1 << 30,
            rel_dcost=0.0,
            abs_dcost=0.0,
            dstep=0.0,
            max_fails=1 << 30,
            max_time=0.2,
            jit_max_time=True,
        ),
    )
    assert result.termination & (1 << 9)
    assert result.num_iterations >= 1


@pytest.mark.parametrize(
    "iterator,x0,y0,rtol",
    [
        (nt.NEWTON, 0.0, 0.0, 1e-10),
        (nt.LEVENBERG_MARQUARDT, -0.5, 2.5, 1e-10),
        (nt.DOGLEG, -0.5, 2.5, 1e-10),
        (nt.GRADIENT_DESCENT, 1.0 - 1e-5, 1.0, 1e-5),
    ],
)
def test_rosenbrock_converges(iterator, x0, y0, rtol):
    p, x, y = make_problem(x0, y0)
    result = nt.optimize(p, nt.Options(iterator=iterator))
    np.testing.assert_allclose(nt.cost(p), result.best_cost, rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(float(p.get_value(x)), 1.0, rtol=rtol)
    np.testing.assert_allclose(float(p.get_value(y)), 1.0, rtol=rtol)


def test_trajectory_monotonic():
    p, _, _ = make_problem(-0.5, 2.5)
    ct = nt.CostTrajectory()
    result = nt.optimize(
        p,
        nt.Options(iterator=nt.LEVENBERG_MARQUARDT),
        callback=nt.store_costs_callback(ct),
    )
    n = len(ct.costs)
    assert len(ct.times_ns) == n and len(ct.trajectory) == n
    assert all(np.diff(ct.costs) <= 0.0)  # costs decrease
    assert all(len(s) == 2 for s in ct.trajectory)
    np.testing.assert_allclose(float(p.get_value(nt.VarHandle(nt.Scalar(), 0))), 1.0, rtol=1e-10)


def test_jit_and_stepped_agree():
    p1, _, _ = make_problem(-0.5, 2.5)
    p2, _, _ = make_problem(-0.5, 2.5)
    r1 = nt.optimize(p1, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    r2 = nt.optimize(
        p2, nt.Options(iterator=nt.LEVENBERG_MARQUARDT), callback=nt.null_callback
    )
    np.testing.assert_allclose(r1.best_cost, r2.best_cost, atol=1e-25)
    assert r1.num_iterations == r2.num_iterations


def test_float32_problem():
    """f32 problems run end-to-end (the production dtype on the GPU) and converge to an
    f32-appropriate tolerance."""
    import jax.numpy as jnp
    from nllstpu.models.rosenbrock import make_rosenbrock

    p, x, y = make_rosenbrock(x0=-0.5, y0=2.5)
    # rebuild as f32
    p32 = nt.Problem(dtype=jnp.float32)
    x = p32.add_variable(nt.Scalar(), -0.5)
    y = p32.add_variable(nt.Scalar(), 2.5)
    p32.add_cost(rosenbrock_a, (x,), params=1.0, kernel=KERNEL_A)
    p32.add_cost(rosenbrock_b, (x, y), params=10.0)
    result = nt.optimize(p32, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    np.testing.assert_allclose(float(p32.get_value(x)), 1.0, rtol=1e-3)
    np.testing.assert_allclose(float(p32.get_value(y)), 1.0, rtol=1e-3)


def test_jit_trajectory():
    """store_trajectory works in the stepped driver and records decreasing
    costs for a Schur-backed problem too."""
    from nllstpu.models.ba import make_affine_ba, perturb_ba

    p, cams, lmks = make_affine_ba(3, 5, 1.0)
    perturb_ba(p, lmks, 0.01, seed=3)
    result = nt.optimize(
        p,
        nt.Options(
            solver="schur", schur_family=nt.Euclidean(3), store_trajectory=True
        ),
    )
    assert result.trajectory is not None
    assert len(result.trajectory.costs) == result.num_iterations
    assert result.trajectory.costs[-1] <= result.trajectory.costs[0]


def test_jit_driver_trajectory_mode():
    """store_trajectory="jit" records per-iteration costs and step norms
    from INSIDE the compiled loop (reference CostTrajectory semantics,
    src/callbacks.jl:85-107, minus full step vectors); adding
    jit_max_time=True also fills per-iteration times."""
    p, _, _ = make_problem(-0.5, 2.5)
    r = nt.optimize(
        p,
        nt.Options(iterator=nt.LEVENBERG_MARQUARDT, store_trajectory="jit"),
    )
    tr = r.trajectory
    assert tr is not None
    assert len(tr.costs) == r.num_iterations == len(tr.step_norms)
    assert all(np.diff(tr.costs) <= 0.0)
    assert all(s >= 0 for s in tr.step_norms)
    assert tr.times_ns == [] and tr.trajectory == []  # documented limits

    p2, _, _ = make_problem(-0.5, 2.5)
    r2 = nt.optimize(
        p2, nt.Options(store_trajectory="jit", jit_max_time=True)
    )
    assert len(r2.trajectory.times_ns) == r2.num_iterations
    assert all(np.diff(r2.trajectory.times_ns) >= 0)


def test_jit_full_trajectory_vectors():
    """store_trajectory="jit_full" records the FULL per-iteration step
    vectors from inside the compiled loop (reference
    CostTrajectory.trajectory, src/callbacks.jl:85-107), matching the
    stepped driver's vectors."""
    p, _, _ = make_problem(-0.5, 2.5)
    r = nt.optimize(
        p,
        nt.Options(
            iterator=nt.LEVENBERG_MARQUARDT, store_trajectory="jit_full"
        ),
    )
    tr = r.trajectory
    assert tr is not None
    assert len(tr.trajectory) == r.num_iterations == len(tr.costs)
    p2, _, _ = make_problem(-0.5, 2.5)
    r2 = nt.optimize(
        p2,
        nt.Options(iterator=nt.LEVENBERG_MARQUARDT, store_trajectory=True),
    )
    assert r2.num_iterations == r.num_iterations
    for vj, vs, nj in zip(
        tr.trajectory, r2.trajectory.trajectory, tr.step_norms
    ):
        np.testing.assert_allclose(vj, vs, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(np.linalg.norm(vj), nj, rtol=1e-12)


def test_jit_max_time_always_enforced():
    """The DEFAULT jit driver honors ``max_time`` (reference
    src/optimize.jl:160-163 enforces it unconditionally): with an
    impossible budget and every other termination test disabled, the run
    stops with TERM_MAX_TIME after at least one chunk instead of burning
    all of ``max_iters``."""
    from nllstpu.core import structs

    p, _, _ = make_problem(-0.5, 2.5)
    r = nt.optimize(
        p,
        nt.Options(
            max_time=1e-9, rel_dcost=0.0, abs_dcost=0.0, dstep=0.0,
            max_fails=10**9, max_iters=10**6,
        ),
    )
    assert r.termination & structs.TERM_MAX_TIME
    assert 1 <= r.num_iterations <= 64  # one chunk, not the whole budget


def test_jit_chunked_resume_bitwise_matches_single_program():
    """The chunked driver (finite max_time → host-resumable while_loops)
    must execute EXACTLY the sequence of the single-program loop: same
    costs, same counts, bit-identical result — chunk boundaries only pause
    and resume the state machine."""
    p1, _, _ = make_problem(-0.5, 2.5)
    p2, _, _ = make_problem(-0.5, 2.5)
    # max_iters > chunk size so at least one resume happens; dstep on a
    # flat quadratic tail keeps LM iterating past the first chunk.
    o = dict(
        iterator=nt.GRADIENT_DESCENT, max_iters=150,
        rel_dcost=0.0, abs_dcost=0.0, dstep=0.0,
    )
    r_single = nt.optimize(p1, nt.Options(max_time=float("inf"), **o))
    r_chunked = nt.optimize(p2, nt.Options(max_time=3600.0, **o))
    assert r_single.num_iterations == r_chunked.num_iterations == 150
    assert r_single.best_cost == r_chunked.best_cost  # bitwise
    assert r_single.cost_computations == r_chunked.cost_computations
    np.testing.assert_array_equal(
        np.asarray(p1.stacked_variables()[repr(nt.Scalar())]),
        np.asarray(p2.stacked_variables()[repr(nt.Scalar())]),
    )


def test_subproblem_handles_overload():
    """subproblem accepts a handle / handle list directly (reference
    integer form, src/problem.jl:47-83)."""
    p, x, y = make_problem()
    sub_y = p.subproblem(y)
    assert sub_y.num_costs() == 1
    sub_both = p.subproblem([x, y])
    assert sub_both.num_costs() == 2


def test_measurement_residual_helper():
    """SimpleError-style measurement residuals (reference src/residual.jl:3-41)."""
    import jax.numpy as jnp
    from nllstpu.models.simple_error import measurement_residual

    def generate(pose, point):
        return jnp.stack([pose[:3] @ point, pose[3:] @ point])

    res = measurement_residual(generate)
    p = nt.Problem()
    cam = p.add_variable(nt.Euclidean(6), np.array([1.0, 0, 0, 0, 1.0, 0]))
    pt = p.add_variable(nt.Euclidean(3), np.array([0.5, -0.5, 2.0]))
    meas = np.array([0.5, -0.5])
    p.add_cost(res, (cam, pt), params=meas)
    np.testing.assert_allclose(nt.cost(p), 0.0, atol=1e-30)
    p.set_value(pt, np.array([0.4, -0.4, 2.0]))
    assert nt.cost(p) > 0
    nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT), unfixed=pt)
    assert nt.cost(p) < 1e-20


def test_runner_cache_holds_multiple_entries():
    """Alternating optimize() across problems/options must not recompile
    every call: the runner cache is an LRU of several entries."""
    from nllstpu.core import optimize as opt_mod

    opt_mod._runner_cache.clear()
    problems = []
    for seed in (1, 2, 3):
        p = nt.Problem()
        x = p.add_variable(nt.Scalar(), 5.0 + seed)
        p.add_cost(lambda t, x: x - t, (x,), params=2.0)
        problems.append(p)
    for p in problems:
        nt.optimize(p, nt.Options(iterator=nt.NEWTON, max_iters=3))
    assert len(opt_mod._runner_cache) == 3
    runners = {k: v[0] for k, v in opt_mod._runner_cache.items()}
    # Re-running reuses the same entry objects (cache hits, no eviction).
    for p in problems:
        nt.optimize(p, nt.Options(iterator=nt.NEWTON, max_iters=3))
    assert {k: v[0] for k, v in opt_mod._runner_cache.items()} == runners
    # Overflow evicts the least recently used entry only.
    for seed in range(opt_mod._RUNNER_CACHE_SIZE):
        p = nt.Problem()
        x = p.add_variable(nt.Scalar(), 1.0 * seed)
        p.add_cost(lambda t, x: x - t, (x,), params=1.0)
        problems.append(p)
        nt.optimize(p, nt.Options(iterator=nt.NEWTON, max_iters=3))
    assert len(opt_mod._runner_cache) == opt_mod._RUNNER_CACHE_SIZE


def test_result_timing_fields_semantics():
    """Reference NLLSResult reports per-phase times (src/structs.jl:44-46).
    The stepped driver measures all three for real; the jitted driver
    reports NaN ("not measured"), never zeros masquerading as timings."""
    from nllstpu.models.rosenbrock import make_rosenbrock

    p, x, y = make_rosenbrock()
    r = nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT,
                                  store_trajectory=True))
    assert r.time_cost > 0 and r.time_gradient > 0 and r.time_solver > 0
    assert r.time_total >= r.time_cost + r.time_gradient + r.time_solver - 1e-9
    assert "unmeasured" not in str(r)

    p2, x2, y2 = make_rosenbrock()
    r2 = nt.optimize(p2, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    assert np.isnan(r2.time_cost) and np.isnan(r2.time_gradient)
    assert np.isnan(r2.time_solver)
    assert r2.time_total > 0
    assert "unmeasured time (jitted)" in str(r2)


def test_jit_printout(capsys):
    """Options(jit_printout=True): the iteration table prints from INSIDE
    the fully-jitted loop (reference printoutcallback runs inside the main
    optimizer, src/callbacks.jl:39-60) — no stepped driver involved."""
    from nllstpu.models.rosenbrock import make_rosenbrock

    p, x, y = make_rosenbrock(x0=-0.5, y0=2.5)
    r = nt.optimize(
        p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT, jit_printout=True)
    )
    out = capsys.readouterr().out.strip().splitlines()
    # header + iteration-0 row + one row per iteration
    assert len(out) == r.num_iterations + 2
    assert out[0].split() == ["iter", "cost", "cost", "change", "|step|", "trust"]
    assert out[1].split()[0] == "0"
    assert out[-1].split()[0] == str(r.num_iterations)


def test_flat_and_nested_lm_identical():
    """The flat LM machine (damping retry merged into the outer while_loop,
    Options.flat_lm) must reproduce the nested machine exactly: same ops in
    the same order => bitwise-equal costs, counts and lambda trajectory."""
    from nllstpu.models.ba import make_pinhole_ba, perturb_ba

    for make in (
        lambda: make_problem(-0.5, 2.5)[0],
        lambda: make_pinhole_ba(4, 12, 0.9, noise=1e-2, seed=3)[0],
    ):
        results = {}
        for flat in (None, False):
            p = make()
            if flat is False:
                # fresh problem per run: optimize mutates variable state
                pass
            results[flat] = nt.optimize(
                p,
                nt.Options(
                    iterator=nt.LEVENBERG_MARQUARDT, flat_lm=flat, max_iters=25
                ),
            )
        rf, rn = results[None], results[False]
        assert rf.num_iterations == rn.num_iterations
        assert rf.cost_computations == rn.cost_computations
        assert rf.gradient_computations == rn.gradient_computations
        assert rf.linear_solves == rn.linear_solves
        assert rf.termination == rn.termination
        np.testing.assert_array_equal(rf.best_cost, rn.best_cost)
        np.testing.assert_array_equal(rf.start_cost, rn.start_cost)


def test_lm_rejects_non_finite_trials():
    """A trial step that overflows the residual (NaN/Inf cost) is a FAILED
    trial: λ escalates and LM recovers — the reference's ``while cost >
    bestcost`` would adopt the NaN and die (src/iterators.jl:160), which is
    exactly what a wild early step on a distortion polynomial can produce.
    A cost that is non-finite even at
    tiny steps still terminates via the NaN/Inf bits."""
    import jax.numpy as jnp

    from nllstpu.core import structs

    def fragile(params, x):
        # Smooth near the optimum; overflows catastrophically for |x| > 3
        # (exp(x^4) with f32 saturates to inf -> inf - inf = NaN downstream).
        big = jnp.exp(jnp.minimum(x * x * x * x, 200.0))
        blow = jnp.where(jnp.abs(x) > 3.0, big * jnp.inf, 0.0)
        return x - params + blow

    for stepped in (False, True):
        p = nt.Problem()
        x = p.add_variable(nt.Scalar(), 2.9)
        p.add_cost(fragile, (x,), params=1.0)
        # init_lm_lambda tiny => the first Newton-ish step overshoots past
        # |x| = 3 and the trial cost is non-finite; LM must back off.
        r = nt.optimize(
            p,
            nt.Options(
                iterator=nt.LEVENBERG_MARQUARDT, init_lm_lambda=1e-9,
                max_iters=50,
            ),
            callback=nt.null_callback if stepped else None,
        )
        assert not (r.termination & (structs.TERM_COST_NAN | structs.TERM_COST_INF)), (
            stepped, r.termination_reasons())
        np.testing.assert_allclose(float(p.get_value(x)), 1.0, rtol=1e-6)

    # Always-non-finite cost still terminates (small-step exit + NaN bit).
    p = nt.Problem()
    x = p.add_variable(nt.Scalar(), 0.0)
    p.add_cost(lambda t, v: v * jnp.nan, (x,), params=0.0)
    r = nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT, max_iters=30))
    assert r.termination != 0
