"""BAL model family tests: loader round-trip (native C++ parser vs numpy
fallback), Snavely residual ground truth, and end-to-end convergence with the
Schur backend on synthetic BAL data."""

import os

import numpy as np
import pytest

import nllstpu as nt
from nllstpu.models import bal
from nllstpu.models.ba import perturb_ba
from nllstpu.utils import native


def test_synthetic_zero_cost():
    data = bal.make_synthetic_bal(8, 64, obs_per_point=4)
    p, cams, pts = bal.make_bal_problem(data)
    # Measurements generated from ground truth → zero cost at the optimum.
    assert nt.cost(p) < 1e-18


def test_loader_roundtrip(tmp_path):
    data = bal.make_synthetic_bal(5, 17, obs_per_point=3)
    path = os.path.join(tmp_path, "toy.txt")
    bal.write_bal(path, data)
    loaded = bal.load_bal(path)
    for key in ("cameras", "points", "observations"):
        np.testing.assert_allclose(loaded[key], data[key], rtol=1e-15)
    np.testing.assert_array_equal(loaded["cam_idx"], data["cam_idx"])
    np.testing.assert_array_equal(loaded["pt_idx"], data["pt_idx"])


def test_native_loader_matches_numpy(tmp_path):
    lib = native._load()
    if lib is None:
        pytest.skip("native loader not built and g++ unavailable")
    data = bal.make_synthetic_bal(4, 11, obs_per_point=2)
    path = os.path.join(tmp_path, "toy.txt")
    bal.write_bal(path, data)
    nat = native.parse_bal(path)
    assert nat is not None
    for key in ("cameras", "points", "observations"):
        np.testing.assert_allclose(nat[key], data[key], rtol=1e-15)
    np.testing.assert_array_equal(nat["cam_idx"], data["cam_idx"])


def test_bal_optimize_schur():
    data = bal.make_synthetic_bal(8, 96, obs_per_point=5)
    p, cams, pts = bal.make_bal_problem(data)
    perturb_ba(p, pts, 0.01, seed=7)
    start = nt.cost(p)
    assert start > 1e-4
    result = nt.optimize(
        p, nt.Options(solver="schur", schur_family=bal.PT)
    )
    assert result.best_cost < start * 1e-12


def test_bal_robust_kernel():
    data = bal.make_synthetic_bal(8, 64, obs_per_point=4, noise=0.5)
    # Inject gross outliers into 5% of observations.
    rng = np.random.default_rng(3)
    k = data["observations"].shape[0]
    out = rng.choice(k, size=k // 20, replace=False)
    data["observations"][out] += 500.0
    p, cams, pts = bal.make_bal_problem(data, robust_width=5.0)
    perturb_ba(p, pts, 0.01, seed=7)
    result = nt.optimize(p, nt.Options(solver="schur", schur_family=bal.PT))
    assert result.best_cost < result.start_cost


def test_bal_ladybug_scale_schur_cg():
    """BAL Ladybug-49-ish scale (49 cameras, 7k points, ~28k observations)
    with the implicit Schur backend: a few LM iterations must reduce the
    cost by orders of magnitude (BASELINE.json config 5 at single-host
    test scale)."""
    data = bal.make_synthetic_bal(49, 7000, obs_per_point=4, noise=0.0)
    p, cams, pts = bal.make_bal_problem(data)
    perturb_ba(p, pts, 0.02, seed=11)
    start = nt.cost(p)
    result = nt.optimize(
        p,
        nt.Options(solver="schur_cg", schur_family=bal.PT, max_iters=8),
    )
    assert result.best_cost < start * 1e-6


def test_native_loader_adversarial_text(tmp_path):
    """Native (strtol/strtod) vs numpy parsing on a NON-trivial text file:
    scientific notation (both cases), explicit +, 17-significant-digit
    round-trip values, negative zero, tabs/multi-space/blank-line
    whitespace.  Guards against int/float text-parsing skew that synthetic
    writer-formatted data would never expose."""
    lib = native._load()
    if lib is None:
        pytest.skip("native loader not built and g++ unavailable")
    rng = np.random.default_rng(9)
    ncam, npt, nobs = 3, 5, 8
    cam_idx = rng.integers(0, ncam, nobs)
    pt_idx = rng.integers(0, npt, nobs)
    obs = rng.standard_normal((nobs, 2)) * np.array([1e-17, 1e14])
    cams = rng.standard_normal((ncam, 9)) * 10.0 ** rng.integers(-12, 12, (ncam, 9))
    cams[0, 0] = -0.0
    cams[1, 1] = 0.1 + 0.2  # 0.30000000000000004 — needs all 17 digits
    pts = rng.standard_normal((npt, 3))
    path = os.path.join(tmp_path, "adversarial.txt")
    with open(path, "w") as f:
        f.write(f"{ncam}  {npt}\t{nobs}\n\n")
        fmts = ["{:.17e}", "{:.17E}", "{:+.17e}"]
        for k in range(nobs):
            sep = "\t" if k % 2 else "   "
            f.write(
                f"{cam_idx[k]}{sep}{pt_idx[k]} "
                + fmts[k % 3].format(obs[k, 0])
                + " "
                + fmts[(k + 1) % 3].format(obs[k, 1])
                + "\n"
            )
        f.write("\n")
        for row in cams:
            for i, v in enumerate(row):
                f.write(fmts[i % 3].format(v) + ("\n" if i % 3 == 2 else " \t"))
            f.write("\n")
        for row in pts:
            f.write(" ".join("{:.17e}".format(v) for v in row) + "\n")

    nat = native.parse_bal(path)
    assert nat is not None
    # Reference: the pure-numpy fallback parser on the same bytes.
    raw = np.fromfile(path, sep=" ")
    body = raw[3:]
    ref_obs = body[: nobs * 4].reshape(nobs, 4)
    rest = body[nobs * 4 :]
    ref_cams = rest[: ncam * 9].reshape(ncam, 9)
    ref_pts = rest[ncam * 9 : ncam * 9 + npt * 3].reshape(npt, 3)
    np.testing.assert_array_equal(nat["cam_idx"], cam_idx)
    np.testing.assert_array_equal(nat["pt_idx"], pt_idx)
    # Bitwise: strtod and numpy must agree on correctly-rounded parsing.
    np.testing.assert_array_equal(nat["observations"], ref_obs[:, 2:4])
    np.testing.assert_array_equal(nat["cameras"], ref_cams)
    np.testing.assert_array_equal(nat["points"], ref_pts)
    # And the 17-digit values round-trip the original doubles exactly.
    np.testing.assert_array_equal(nat["cameras"], cams)
    np.testing.assert_array_equal(nat["observations"], obs)


def test_bal_cm_matches_per_cost():
    """The components-major BAL formulation (synthesized cm Jacobian via
    linearize + basis tangents) must match the per-cost vmapped path:
    identical cost, matching assembled Schur system, and the same
    converged optimum."""
    import jax
    import jax.numpy as jnp
    from nllstpu.core.optimize import compile_problem

    data = bal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3)

    def build(batched):
        p, cams, pts = bal.make_bal_problem(data, batched=batched)
        perturb_ba(p, pts, 0.01, seed=7)
        return p

    p_cm, p_ref = build("cm"), build(False)
    c_cm = compile_problem(p_cm, solver="schur", schur_family=bal.PT)
    c_ref = compile_problem(p_ref, solver="schur", schur_family=bal.PT)
    assert c_cm.batches[0].batched == "cm"
    v_cm, v_ref = p_cm.stacked_variables(), p_ref.stacked_variables()
    np.testing.assert_allclose(
        float(jax.jit(c_cm.cost)(v_cm)), float(jax.jit(c_ref.cost)(v_ref)),
        rtol=1e-13,
    )
    _, sys_cm = jax.jit(c_cm.assemble)(v_cm)
    _, sys_ref = jax.jit(c_ref.assemble)(v_ref)
    for name, a, b in zip("a_rr b_r h_ll g_l w".split(), sys_cm, sys_ref):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-11, err_msg=name
        )
    r_cm = nt.optimize(p_cm, nt.Options(solver="schur", schur_family=bal.PT))
    r_ref = nt.optimize(p_ref, nt.Options(solver="schur", schur_family=bal.PT))
    np.testing.assert_allclose(
        float(r_cm.best_cost), float(r_ref.best_cost), rtol=1e-9
    )


def test_snavely_hand_jacobian_matches_synthesized():
    """The hand analytic cm Snavely Jacobian must match the synthesized
    (linearize + 12 basis-tangent passes) one, including at the tiny-angle
    series branch and with strong distortion."""
    import jax.numpy as jnp
    from nllstpu.core.problem import _auto_cm_jacobian

    rng = np.random.default_rng(5)
    b = 64
    cams = rng.standard_normal((9, b))
    cams[:3] *= 0.8  # exercise the large-angle branch
    cams[:3, :8] *= 1e-9  # and the θ²<1e-14 series branch
    cams[6] = 300.0 + 200.0 * rng.random(b)
    cams[7] = rng.standard_normal(b) * 1e-2
    cams[8] = rng.standard_normal(b) * 1e-3
    pts = rng.standard_normal((3, b))
    pts[2] += 6.0
    meas = rng.standard_normal((b, 2)) * 5.0
    auto = _auto_cm_jacobian(bal.snavely_residual_cm, (bal.CAM, bal.PT))
    r_a, j_a = auto(jnp.asarray(meas), jnp.asarray(cams), jnp.asarray(pts))
    r_h, j_h = bal.snavely_jacobian_cm(
        jnp.asarray(meas), jnp.asarray(cams), jnp.asarray(pts)
    )
    np.testing.assert_allclose(np.asarray(r_h), np.asarray(r_a), rtol=1e-12)
    np.testing.assert_allclose(
        np.asarray(j_h), np.asarray(j_a), rtol=1e-8, atol=1e-10
    )


def test_bal_hand_jacobian_end_to_end():
    """make_bal_problem's default (hand Jacobian) converges to the same
    optimum as the synthesized-Jacobian build."""
    data = bal.make_synthetic_bal(6, 48, obs_per_point=4, noise=1e-3)

    def run(hand):
        p, cams, pts = bal.make_bal_problem(data, hand_jacobian=hand)
        perturb_ba(p, pts, 0.01, seed=7)
        return nt.optimize(p, nt.Options(solver="schur", schur_family=bal.PT))

    r_hand, r_auto = run(True), run(False)
    np.testing.assert_allclose(
        float(r_hand.best_cost), float(r_auto.best_cost), rtol=1e-9
    )


def test_realistic_bal_degree_stats():
    """The realistic generator must actually produce the skew shapes real
    BAL files have — long-tail track lengths (uniform obs-major padding
    would blow the 2.5x budget) and order-of-magnitude camera-degree
    spread (the camera-major repack budget) — with no duplicate
    (camera, point) pairs."""
    d = bal.make_realistic_bal(ncameras=49, npoints=2048, seed=1)
    nobs = len(d["pt_idx"])
    tracks = np.bincount(d["pt_idx"], minlength=2048)
    cam_deg = np.bincount(d["cam_idx"], minlength=49)
    assert 2048 * tracks.max() > 2.5 * nobs  # uniform padding disqualifies
    assert 49 * cam_deg.max() > 2.5 * nobs  # camera repack disqualifies
    pairs = d["cam_idx"].astype(np.int64) * (1 << 32) + d["pt_idx"]
    assert len(np.unique(pairs)) == nobs


def test_realistic_bal_bucketed_direct():
    """Skewed (real-BAL-shaped) degree distributions must keep the fast
    direct-Schur path: the compile degree-sorts the landmark ids and the
    repack produces power-of-two run buckets; the assembled system and the
    damped solve must match the per-cost vmapped generic formulation, and
    the optimizer must reach the noise-floor optimum."""
    import jax
    import jax.numpy as jnp
    from nllstpu.core.optimize import compile_problem

    d = bal.make_realistic_bal(ncameras=12, npoints=160, seed=3, noise=1e-3)
    rng = np.random.default_rng(0)
    d["points"] = d["points"] + rng.standard_normal(d["points"].shape) * 1e-3

    p, cams, pts = bal.make_bal_problem(d)
    c = compile_problem(p, solver="schur", schur_family=bal.PT)
    f = c.schur_info.fast[0]
    assert f is not None and f.buckets is not None and len(f.buckets) > 1
    # Power-of-two run lengths; coverage is asserted via assembly parity.
    assert all(kb & (kb - 1) == 0 for (_, _, kb, _) in f.buckets)

    p_ref, _, _ = bal.make_bal_problem(d, batched=False)
    c_ref = compile_problem(p_ref, solver="schur", schur_family=bal.PT)
    v, v_ref = p.stacked_variables(), p_ref.stacked_variables()
    np.testing.assert_allclose(
        float(jax.jit(c.cost)(v)), float(jax.jit(c_ref.cost)(v_ref)),
        rtol=1e-12,
    )
    _, sys1 = jax.jit(c.assemble)(v)
    _, sys2 = jax.jit(c_ref.assemble)(v_ref)
    # Layout id orders differ (degree relabel) — compare through the damped
    # solve applied back to the variables.
    lam = jnp.asarray(1e-3, p.dtype)
    nv1 = c.apply(v, -c.ctx().linops.solve(sys1, lam))
    nv2 = c_ref.apply(v_ref, -c_ref.ctx().linops.solve(sys2, lam))
    for k in nv1:
        np.testing.assert_allclose(
            np.asarray(nv1[k]), np.asarray(nv2[k]), rtol=1e-7, atol=1e-10
        )
    res = nt.optimize(p, nt.Options(solver="schur", schur_family=bal.PT))
    res_ref = nt.optimize(
        p_ref, nt.Options(solver="schur", schur_family=bal.PT)
    )
    np.testing.assert_allclose(
        float(res.best_cost), float(res_ref.best_cost), rtol=1e-8
    )


def test_fused_all_fixed_landmark_extras():
    """Costs whose landmark is FIXED land in the extras region outside
    every obs-major run; their camera a_rr/b_r contributions must not be
    dropped by the direct obs-major assembly (which reduces the runs): the
    assembled system must match the per-cost generic formulation, compared
    through the damped step applied back to the variables."""
    import jax
    import jax.numpy as jnp
    from nllstpu.core.optimize import compile_problem

    d = bal.make_synthetic_bal(5, 40, obs_per_point=4, noise=1e-3)
    unfixed = {
        repr(bal.CAM): np.ones(5, dtype=bool),
        repr(bal.PT): np.arange(40) % 3 != 0,  # every third point fixed
    }

    def build(batched):
        p, cams, pts = bal.make_bal_problem(d, batched=batched)
        perturb_ba(p, pts, 0.01, seed=7)
        return p, compile_problem(
            p, unfixed=unfixed, solver="schur", schur_family=bal.PT
        )

    p1, c_ref = build(False)
    p2, c_f = build("cm")
    f = c_f.schur_info.fast[0]
    assert f is not None and f.obs_k is not None  # obs-major runs...
    info = c_f.schur_info
    assert int(np.asarray(c_f.batches[0].mask)[info.num_elim * f.obs_k:].sum())
    v1, v2 = p1.stacked_variables(), p2.stacked_variables()
    c1, sys_ref = jax.jit(c_ref.assemble)(v1)
    c2, sys_f = jax.jit(c_f.assemble)(v2)
    np.testing.assert_allclose(float(c2), float(c1), rtol=1e-12)
    # a_rr/b_r are camera-indexed and cameras keep their order.
    for name, a, b in zip(("a_rr", "b_r"), sys_f[:2], sys_ref[:2]):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-11, err_msg=name
        )
    lam = jnp.asarray(1e-3, p1.dtype)
    nv1 = c_ref.apply(v1, -c_ref.ctx().linops.solve(sys_ref, lam))
    nv2 = c_f.apply(v2, -c_f.ctx().linops.solve(sys_f, lam))
    for k in nv1:
        np.testing.assert_allclose(
            np.asarray(nv2[k]), np.asarray(nv1[k]), rtol=1e-8, atol=1e-11
        )


def test_realistic_bal_implicit():
    """Implicit (matrix-free) Schur on skewed degree distributions: the
    bucketed batch falls back to per-cost coupling blocks but must still
    converge to the direct backend's optimum."""
    d = bal.make_realistic_bal(ncameras=12, npoints=160, seed=3, noise=1e-3)

    def run(solver):
        p, cams, pts = bal.make_bal_problem(d)
        perturb_ba(p, pts, 0.01, seed=7)
        return nt.optimize(
            p, nt.Options(solver=solver, schur_family=bal.PT, max_iters=30)
        )

    r_d, r_i = run("schur"), run("schur_cg")
    np.testing.assert_allclose(
        float(r_i.best_cost), float(r_d.best_cost), rtol=1e-6
    )


def test_auto_schur_family_detection():
    """Plain ``optimize(p)`` on a BA-shaped problem must land on the Schur
    backend without the user naming the eliminated family: the bipartite
    small-dof dominant family (points) is auto-detected when the
    dense/sparse heuristic says "sparse"."""
    from nllstpu.core.optimize import compile_problem

    d = bal.make_synthetic_bal(8, 96, obs_per_point=5)
    p, cams, pts = bal.make_bal_problem(d)
    c = compile_problem(p, solver="auto")
    assert c.schur_info is not None
    assert c.schur_info.elim_family == repr(bal.PT)
    perturb_ba(p, pts, 0.01, seed=7)
    start = nt.cost(p)
    result = nt.optimize(p)  # default Options: solver="auto"
    assert result.best_cost < start * 1e-10
