"""Multi-device tests on the virtual 8-device CPU mesh: sharded assembly must
reproduce the single-device system bit-for-bit (psum of disjoint partial
sums), and the full sharded optimization must reach the reference cost
targets."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nllstpu as nt
from nllstpu.core.optimize import compile_problem, optimize, run_loop
from nllstpu.models.ba import make_affine_ba, make_pinhole_ba, perturb_ba
from nllstpu.parallel.mesh import make_mesh, parallelize
from nllstpu.parallel.schur_shard import optimize_sharded, parallelize_schur

LMK = nt.Euclidean(3)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("solver,schur_family", [("dense", None), ("schur", LMK)])
def test_sharded_assembly_matches(solver, schur_family):
    p, cams, lmks = make_affine_ba(6, 20, 0.5)
    perturb_ba(p, lmks, 0.05, seed=3)
    compiled = compile_problem(p, solver=solver, schur_family=schur_family)
    mesh = make_mesh(8)
    par = parallelize(compiled, mesh)
    variables = p.stacked_variables()
    c1, sys1 = jax.jit(compiled.assemble)(variables)
    c2, sys2 = jax.jit(par.assemble)(variables)
    np.testing.assert_allclose(c1, c2, rtol=1e-12)
    for l1, l2 in zip(jax.tree.leaves(sys1), jax.tree.leaves(sys2)):
        np.testing.assert_allclose(l1, l2, rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_full_optimize(n_devices):
    p, cams, lmks = make_affine_ba(10, 50, 0.3)
    perturb_ba(p, lmks, 0.001, seed=3)
    perturb_ba(p, cams, 0.001, seed=4)
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    par = parallelize(compiled, make_mesh(n_devices))
    opts = nt.Options()
    final = jax.jit(
        lambda v: run_loop(par.assemble, par.cost, par.ctx(), opts, v)
    )(p.stacked_variables())
    assert float(final["bestcost"]) < 1e-15


# ---------------------------------------------------------------------------
# Landmark-sharded distributed Schur (parallel.schur_shard)
# ---------------------------------------------------------------------------


def _pinhole_problem(nlmk=41):
    # 41 landmarks: does NOT divide 8, exercising the pad-slot handling.
    p, cams, lmks = make_pinhole_ba(
        ncameras=6, nlandmarks=nlmk, prop_visible=0.6, dtype=jnp.float64
    )
    perturb_ba(p, lmks, 0.01, seed=3)
    return p


def test_landmark_sharded_assembly_matches():
    p = _pinhole_problem()
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    variables = p.stacked_variables()
    c1, (a1, b1, h1, g1, w1) = jax.jit(compiled.assemble)(variables)
    par = parallelize_schur(compiled, make_mesh(8))
    c2, (a2, b2, h2, g2, w2) = par.assemble(variables)
    L = h1.shape[-1]
    np.testing.assert_allclose(c1, c2, rtol=1e-12)
    np.testing.assert_allclose(a1, a2, atol=1e-12)
    np.testing.assert_allclose(b1, b2, atol=1e-13)
    # Local landmark blocks are exact (each landmark's costs live on exactly
    # one device — no cross-device reduction touches them).
    np.testing.assert_array_equal(np.asarray(h2)[:, :, :L], np.asarray(h1))
    np.testing.assert_array_equal(np.asarray(g2)[:, :L], np.asarray(g1))
    np.testing.assert_array_equal(np.asarray(w2)[:, :L, :], np.asarray(w1))
    # Pad slots beyond the real landmark count are all-zero.
    assert not np.asarray(h2)[:, :, L:].any()
    assert not np.asarray(g2)[:, L:].any()
    assert not np.asarray(w2)[:, L:, :].any()


def test_landmark_sharded_solve_matches():
    from jax.sharding import PartitionSpec as P

    p = _pinhole_problem()
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    variables = p.stacked_variables()
    _, sys_ref = jax.jit(compiled.assemble)(variables)
    x_ref = np.asarray(compiled.schur_info.ops().solve(sys_ref, jnp.float64(0.1)))
    mesh = make_mesh(8)
    par = parallelize_schur(compiled, mesh)
    _, sys_sh = par.assemble(variables)
    spec = (
        P(), P(), P(None, None, "data"), P(None, "data"), P(None, "data")
    )
    x_sh = np.asarray(
        jax.shard_map(
            lambda sys: par.ops().solve(sys, jnp.float64(0.1)),
            mesh=mesh,
            in_specs=(spec,),
            out_specs=P(),
        )(sys_sh)
    )
    dr = compiled.schur_info.dim_reduced
    L = np.asarray(sys_ref[2]).shape[-1]
    np.testing.assert_allclose(x_sh[: dr + 3 * L], x_ref, atol=1e-12)
    assert not x_sh[dr + 3 * L :].any()  # pad-slot steps are exactly zero


@pytest.mark.parametrize("n_devices", [2, 8])
def test_landmark_sharded_full_optimize(n_devices):
    opts = nt.Options(
        solver="schur", schur_family=LMK, max_iters=30
    )
    p_ref = _pinhole_problem()
    res_ref = optimize(p_ref, opts)
    p_sh = _pinhole_problem()
    res_sh = optimize_sharded(p_sh, make_mesh(n_devices), opts)
    assert res_sh.best_cost < 1e-25
    assert res_sh.num_iterations == res_ref.num_iterations
    for name in p_ref.family_names():
        np.testing.assert_allclose(
            p_sh.stacked_variables()[name],
            p_ref.stacked_variables()[name],
            atol=1e-9,
        )


def test_landmark_sharded_requires_direct_schur():
    p = _pinhole_problem()
    compiled = compile_problem(p, solver="dense")
    with pytest.raises(ValueError):
        parallelize_schur(compiled, make_mesh(2))


def test_landmark_sharded_implicit_solve_matches():
    """The sharded implicit (matrix-free CG) solve must reproduce the
    single-device schur_cg solve: psum-reduced W couplings in the matvec,
    rhs and Schur-Jacobi preconditioner."""
    p = _pinhole_problem()
    imp = compile_problem(p, solver="schur_cg", schur_family=LMK)
    assert imp.schur_info.implicit
    variables = p.stacked_variables()
    _, sys_ref = jax.jit(imp.assemble)(variables)
    x_ref = np.asarray(imp.schur_info.ops().solve(sys_ref, jnp.float64(0.1)))
    par = parallelize_schur(imp, make_mesh(8))
    _, x_sh = par.solve_once(variables, jnp.float64(0.1))
    x_sh = np.asarray(x_sh)
    dr = imp.schur_info.dim_reduced
    L = imp.schur_info.num_elim
    np.testing.assert_allclose(x_sh[: dr + 3 * L], x_ref, atol=1e-12)
    assert not x_sh[dr + 3 * L :].any()


def test_landmark_sharded_implicit_full_optimize():
    opts = nt.Options(solver="schur_cg", schur_family=LMK, max_iters=30)
    p_ref = _pinhole_problem()
    res_ref = optimize(p_ref, opts)
    p_sh = _pinhole_problem()
    res_sh = optimize_sharded(p_sh, make_mesh(8), opts)
    assert res_sh.best_cost < 1e-25
    assert res_sh.num_iterations == res_ref.num_iterations


def test_landmark_sharded_dogleg_fused_quad():
    """Sharded dogleg exercises ShardedSchurOps.solve0_quad_grad (the fused
    Newton-leg + Cauchy-curvature path with its extra scalar psum) and must
    reach the single-device optimum."""
    opts = nt.Options(solver="schur", schur_family=LMK, iterator=nt.DOGLEG,
                      max_iters=40)
    p_ref = _pinhole_problem()
    res_ref = optimize(p_ref, opts)
    p_sh = _pinhole_problem()
    res_sh = optimize_sharded(p_sh, make_mesh(8), opts)
    assert res_sh.best_cost <= max(res_ref.best_cost * (1 + 1e-9), 1e-25)


def _pinhole_f32(seed=7):
    p, cams, lmks = make_pinhole_ba(
        ncameras=6, nlandmarks=48, prop_visible=0.6, noise=1e-3,
        dtype=jnp.float32, batched="cm",
    )
    perturb_ba(p, lmks, 0.03, seed=seed)
    return p


def test_landmark_sharded_w_dtype_bf16(monkeypatch):
    """NLLSTPU_W_DTYPE=bf16 now reaches the landmark-sharded direct Schur
    (round-2 pinned it f32): the sharded W shard is stored bf16, matches the
    f32 sharded assembly within bf16 rounding, and the full sharded LM run
    converges to a comparable cost.  Safe because each device owns its
    landmarks' W rows outright — W is never psum-reduced."""
    monkeypatch.delenv("NLLSTPU_W_DTYPE", raising=False)
    p = _pinhole_f32()
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    variables = p.stacked_variables()
    mesh = make_mesh(8)
    par = parallelize_schur(compiled, mesh)
    _, (_, _, _, _, w_f32) = par.assemble(variables)
    res_f32 = optimize_sharded(_pinhole_f32(), mesh, nt.Options(
        solver="schur", schur_family=LMK, max_iters=25))

    monkeypatch.setenv("NLLSTPU_W_DTYPE", "bf16")
    p2 = _pinhole_f32()
    compiled2 = compile_problem(p2, solver="schur", schur_family=LMK)
    par2 = parallelize_schur(compiled2, mesh)
    _, (_, _, _, _, w_bf) = par2.assemble(p2.stacked_variables())
    assert w_bf.dtype == jnp.bfloat16
    scale = max(1e-12, float(np.abs(np.asarray(w_f32)).max()))
    assert (
        np.abs(
            np.asarray(w_bf, dtype=np.float32) - np.asarray(w_f32)
        ).max()
        / scale
        < 2 ** -7
    )
    res_bf = optimize_sharded(_pinhole_f32(), mesh, nt.Options(
        solver="schur", schur_family=LMK, max_iters=25))
    assert res_bf.best_cost < 2.0 * max(res_f32.best_cost, 1e-8)


def test_sharded_runner_cache_lru():
    """ShardedSchurCompiled.run keeps an LRU of compiled runners across
    Options (round-2 held exactly ONE entry → alternation recompiled every
    swap, the same pathology optimize()'s _runner_cache fixes)."""
    from nllstpu.parallel import schur_shard

    p = _pinhole_problem()
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    par = parallelize_schur(compiled, make_mesh(8))
    vars0 = p.stacked_variables()
    opts_a = nt.Options(solver="schur", schur_family=LMK, max_iters=2)
    opts_b = nt.Options(solver="schur", schur_family=LMK, max_iters=3)
    par.run(vars0, opts_a)
    par.run(vars0, opts_b)
    cache = par.__dict__["_runner_cache"]
    assert set(cache) == {opts_a, opts_b}
    runners = dict(cache)
    # Alternating swaps are pure cache hits: the runner objects persist.
    par.run(vars0, opts_a)
    par.run(vars0, opts_b)
    assert dict(par.__dict__["_runner_cache"]) == runners
    # Overflow evicts the least recently used entry only.
    extra = [
        nt.Options(solver="schur", schur_family=LMK, max_iters=4 + i)
        for i in range(schur_shard._SHARD_RUNNER_CACHE_SIZE)
    ]
    for o in extra:
        par.run(vars0, o)
    cache = par.__dict__["_runner_cache"]
    assert len(cache) == schur_shard._SHARD_RUNNER_CACHE_SIZE
    assert opts_a not in cache and extra[-1] in cache


def test_landmark_sharded_obs_major_routing():
    """The direct sharded path must keep the obs-major run structure per
    shard (meta.obs_k set): run-preserving positional routing keeps every
    landmark's k-column run (masked slots included) on its owning device,
    so per-device landmark reductions stay contiguous reshape+sums instead
    of obs-table gathers.  41 landmarks / 8 devices exercises the -1
    in-place padding (shard 6 owns 5 landmarks, shard 7 owns none)."""
    p = _pinhole_problem()
    compiled = compile_problem(p, solver="schur", schur_family=LMK)
    assert compiled.schur_info.fast[0].obs_k is not None  # global obs-major
    par = parallelize_schur(compiled, make_mesh(8))
    assert par.fast_meta[0] is not None
    assert par.fast_meta[0].obs_k == compiled.schur_info.fast[0].obs_k
    # And the assembled system still matches the single-device one exactly
    # (cost + reduced system; landmark blocks are covered by
    # test_landmark_sharded_assembly_matches).
    variables = p.stacked_variables()
    c1, (a1, b1, *_) = jax.jit(compiled.assemble)(variables)
    c2, (a2, b2, *_) = par.assemble(variables)
    np.testing.assert_allclose(c1, c2, rtol=1e-12)
    np.testing.assert_allclose(a1, a2, atol=1e-12)


def _realistic_problem(dtype=jnp.float64):
    """Skewed-degree (bucketed-layout) BAL problem small enough for the
    8-device CPU mesh tests."""
    from nllstpu.models import bal
    from nllstpu.models.ba import perturb_ba

    data = bal.make_realistic_bal(
        ncameras=10, npoints=180, seed=3, noise=1e-3, track_alpha=2.0
    )
    p, cam_h, pt_h = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pt_h, 0.02, seed=5)
    return p


def test_landmark_sharded_bucketed_layout():
    """Bucketed (skewed-degree) layouts survive landmark sharding: strided
    ownership (_bucket_shard_plan) gives every shard the same local bucket
    plan, the per-shard bucketed fast paths re-engage (fast_meta carries
    local buckets), and assembly/solve/optimize all match the
    single-device results."""
    from nllstpu.models import bal

    p = _realistic_problem()
    compiled = compile_problem(p, solver="schur", schur_family=bal.PT)
    info = compiled.schur_info
    fast = info.fast[0]
    assert fast.buckets is not None  # the shape really bucketed
    variables = p.stacked_variables()
    c1, (a1, b1, h1, g1, w1) = jax.jit(compiled.assemble)(variables)

    mesh = make_mesh(8)
    par = parallelize_schur(compiled, mesh)
    assert par.gid_table is not None  # strided ownership engaged
    assert par.fast_meta[0] is not None
    assert par.fast_meta[0].buckets is not None  # local plan engaged
    c2, (a2, b2, h2, g2, w2) = par.assemble(variables)
    np.testing.assert_allclose(c1, c2, rtol=1e-12)
    np.testing.assert_allclose(a1, a2, atol=1e-11)
    np.testing.assert_allclose(b1, b2, atol=1e-12)
    # Landmark-keyed blocks come back in device-major order; gid_pos maps
    # them to global lid order for comparison.
    L = np.asarray(h1).shape[-1]
    pos = np.asarray(par.gid_pos)
    np.testing.assert_allclose(
        np.asarray(h2)[:, :, pos][:, :, :L], np.asarray(h1), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(g2)[:, pos][:, :L], np.asarray(g1), atol=1e-12
    )
    # W [dl, L, Dr], gid-reordered on the landmark axis.
    np.testing.assert_allclose(
        np.asarray(w2)[:, pos][:, :L], np.asarray(w1), atol=1e-12
    )

    # Damped sharded solve matches the single-device solve in gid order.
    from jax.sharding import PartitionSpec as P

    x_ref = np.asarray(info.ops().solve((a1, b1, h1, g1, w1), jnp.float64(0.1)))
    spec = (P(), P(), P(None, None, "data"), P(None, "data"),
            P(None, "data"))
    x_sh = np.asarray(
        jax.shard_map(
            lambda s: par.ops().solve(s, jnp.float64(0.1)),
            mesh=mesh, in_specs=(spec,), out_specs=P(),
        )((a2, b2, h2, g2, w2))
    )
    dr = info.dim_reduced
    np.testing.assert_allclose(x_sh[: dr + 3 * L], x_ref, atol=1e-10)
    assert not x_sh[dr + 3 * L :].any()  # pad-slot steps exactly zero

    # Full sharded optimize matches the single-device optimum.
    opts = nt.Options(
        solver="schur", schur_family=bal.PT,
        iterator=nt.LEVENBERG_MARQUARDT, max_iters=15,
    )
    p_ref = _realistic_problem()
    res_ref = optimize(p_ref, opts)
    p_sh = _realistic_problem()
    res_sh = optimize_sharded(p_sh, mesh, opts)
    np.testing.assert_allclose(
        res_sh.best_cost, res_ref.best_cost, rtol=1e-8, atol=1e-20
    )
