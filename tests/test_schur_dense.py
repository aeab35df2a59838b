"""The XLA direct Schur path against the plain dense normal equations.

For each problem shape that once had a hand-kernel path of its own, the
Schur system (``solver="schur"``) must carry the same cost, gradient and
curvature as the dense assembly (``solver="dense"``) of the same problem,
and the damped step through the Schur solve must match the dense Cholesky
step.  Vectors are compared in a layout-independent order
(``chip_smoke.variable_order``), since the Schur layout puts the eliminated
family last.  Every case runs in f64 and in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import nllstpu as nt
from chip_smoke import variable_order
from nllstpu.core.iterators import DenseOps
from nllstpu.core.optimize import compile_problem
from nllstpu.models import bal
from nllstpu.models.ba import make_pinhole_ba, perturb_ba

LMK = nt.Euclidean(3)


def _pinhole(dtype, **kw):
    args = dict(ncameras=5, nlandmarks=30, prop_visible=0.7, noise=1e-3)
    args.update(kw)
    p, cams, lmks = make_pinhole_ba(dtype=dtype, batched="cm", **args)
    perturb_ba(p, lmks, 0.03, seed=2)
    return p, cams, lmks


def case_fixed_cameras(dtype):
    p, cams, lmks = _pinhole(dtype)
    return p, LMK, cams[2:] + lmks


def case_robust(dtype):
    """Huber tail engaged: large noise against a small kernel width."""
    p, _, lmks = make_pinhole_ba(
        ncameras=5, nlandmarks=30, prop_visible=0.7, noise=2e-2,
        robust_width=1e-2, dtype=dtype, batched="cm",
    )
    perturb_ba(p, lmks, 0.05, seed=4)
    return p, LMK, None


def case_bf16_w(dtype):
    """W stored in bfloat16 (``NLLSTPU_W_DTYPE=bf16``; f32 systems only —
    an f64 system keeps its W in f64)."""
    p, _, _ = _pinhole(dtype)
    return p, LMK, None


def _prior_residual_cm(params, v_cm):
    return v_cm - params.T


def case_priors(dtype):
    """BAL observations plus a point prior (eliminated family only) and a
    camera prior (reduced family only)."""
    data = bal.make_synthetic_bal(5, 40, obs_per_point=4, noise=1e-3)
    p, _, pts = bal.make_bal_problem(data, dtype=dtype)
    rng = np.random.default_rng(4)
    p.add_cost_batch(
        _prior_residual_cm,
        slots=[(bal.PT, np.arange(0, 40, 3, dtype=np.int32))],
        params=data["points"][::3] + rng.standard_normal((14, 3)) * 0.01,
        batched="cm",
    )
    p.add_cost_batch(
        _prior_residual_cm,
        slots=[(bal.CAM, np.arange(5, dtype=np.int32))],
        params=data["cameras"] * 1.001,
        batched="cm",
    )
    perturb_ba(p, pts, 0.01, seed=7)
    return p, bal.PT, None


def case_camera_skew(dtype):
    """One camera sees most points: the camera-major repack bails."""
    rng = np.random.default_rng(8)
    ncam, npt, opp = 16, 40, 2
    data = dict(bal.make_synthetic_bal(ncam, npt, obs_per_point=opp))
    prob = np.array([0.55] + [0.45 / (ncam - 1)] * (ncam - 1))
    for j in range(npt):
        data["cam_idx"][j * opp:(j + 1) * opp] = rng.choice(
            ncam, size=opp, replace=False, p=prob
        )
    zero = jnp.zeros((data["cam_idx"].shape[0], 2))
    data["observations"] = np.asarray(bal.snavely_residual_cm(
        zero, jnp.asarray(data["cameras"][data["cam_idx"]].T),
        jnp.asarray(data["points"][data["pt_idx"]].T),
    ).T)
    p, _, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pts, 0.01, seed=7)
    return p, bal.PT, None


def case_dl2(dtype):
    """2-D landmarks under 6-parameter affine cameras, hand cm Jacobian."""
    rng = np.random.default_rng(11)
    ncam, nlmk = 4, 20
    cam0 = rng.standard_normal((ncam, 6)) * 0.2 + np.array(
        [1.0, 0, 0, 1.0, 0, 0]
    )
    lmk0 = rng.standard_normal((nlmk, 2))

    def residual(meas, cam, lmk):
        m = meas.T
        r1 = cam[0] * lmk[0] + cam[1] * lmk[1] + cam[4] - m[0]
        r2 = cam[2] * lmk[0] + cam[3] * lmk[1] + cam[5] - m[1]
        return jnp.stack([r1, r2])

    def jacobian(meas, cam, lmk):
        r = residual(meas, cam, lmk)
        z = jnp.zeros(r.shape[-1:], r.dtype)
        o = jnp.ones(r.shape[-1:], r.dtype)
        j1 = jnp.stack([lmk[0], lmk[1], z, z, o, z, cam[0], cam[1]])
        j2 = jnp.stack([z, z, lmk[0], lmk[1], z, o, cam[2], cam[3]])
        return r, jnp.stack([j1, j2])

    ci, li, meas = [], [], []
    for lj in range(nlmk):
        for cj in range(ncam):
            a = cam0[cj]
            ci.append(cj)
            li.append(lj)
            meas.append(np.array([[a[0], a[1]], [a[2], a[3]]]) @ lmk0[lj]
                        + a[4:] + 0.01 * rng.standard_normal(2))
    p = nt.Problem(dtype=dtype)
    cams = [p.add_variable(nt.Euclidean(6), c) for c in cam0]
    lmks = [p.add_variable(nt.Euclidean(2), l) for l in lmk0]
    p.add_cost_batch(
        residual,
        [(nt.Euclidean(6), np.array([cams[c].index for c in ci])),
         (nt.Euclidean(2), np.array([lmks[l].index for l in li]))],
        params=np.array(meas), jacobian=jacobian, batched="cm",
    )
    return p, nt.Euclidean(2), None


def case_fixed_landmark_extras(dtype):
    """Every third point fixed: its costs sit outside the obs-major runs."""
    data = bal.make_synthetic_bal(5, 40, obs_per_point=4, noise=1e-3)
    p, _, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pts, 0.01, seed=7)
    unfixed = {
        repr(bal.CAM): np.ones(5, dtype=bool),
        repr(bal.PT): np.arange(40) % 3 != 0,
    }
    return p, bal.PT, unfixed


def case_bucketed_realistic(dtype):
    """Long-tailed track lengths: the bucketed obs-major layout."""
    d = bal.make_realistic_bal(ncameras=10, npoints=128, seed=5, noise=1e-3)
    p, _, pts = bal.make_bal_problem(d, dtype=dtype)
    perturb_ba(p, pts, 1e-3, seed=1)
    return p, bal.PT, None


def case_cm_bal(dtype):
    """BAL cm batch with the synthesized Snavely Jacobian."""
    data = bal.make_synthetic_bal(5, 40, obs_per_point=4, noise=1e-3)
    p, _, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pts, 0.01, seed=7)
    return p, bal.PT, None


def case_wide_snavely(dtype):
    """A wide reduced space: 120 nine-parameter cameras (1,080 dims)."""
    data = bal.make_synthetic_bal(120, 200, obs_per_point=3, noise=1e-3)
    p, _, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(p, pts, 0.01, seed=7)
    return p, bal.PT, None


def case_dogleg_newton(dtype):
    """Dogleg's undamped Newton leg (``solve0_quad_grad``); two fixed
    cameras fix the gauge so the undamped system is definite."""
    p, cams, lmks = _pinhole(dtype)
    return p, LMK, cams[2:] + lmks


CASES = {
    "priors": case_priors,
    "camera_skew": case_camera_skew,
    "fixed_cameras": case_fixed_cameras,
    "robust": case_robust,
    "dl2": case_dl2,
    "bf16_w": case_bf16_w,
    "fixed_landmark_extras": case_fixed_landmark_extras,
    "bucketed_realistic": case_bucketed_realistic,
    "cm_bal": case_cm_bal,
    "wide_snavely": case_wide_snavely,
    "dogleg_newton": case_dogleg_newton,
}

#: Relative tolerances (system: cost, gradient, curvature; step), each ~10x
#: above the largest error seen over the cases: f64 is round-off of one
#: system assembled and solved two ways; f32 adds f32 round-off, amplified
#: in the step by the damped system's conditioning; a bfloat16 W keeps 8
#: significant bits.
TOL = {"float64": (1e-12, 1e-10), "float32": (1e-5, 1e-4),
       "bf16_w": (1e-3, 5e-2)}


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_direct_schur_matches_dense(case, dtype, monkeypatch):
    monkeypatch.setenv("NLLSTPU_W_DTYPE", "bf16" if case == "bf16_w" else "auto")
    dt = jnp.dtype(dtype)
    p, fam, unfixed = CASES[case](dt)
    cs = compile_problem(p, unfixed, solver="schur", schur_family=fam)
    cd = compile_problem(p, unfixed, solver="dense")
    assert cs.schur_info is not None and not cs.schur_info.implicit
    v = p.stacked_variables()
    cost_s, sys_s = jax.jit(cs.assemble)(v)
    cost_d, sys_d = jax.jit(cd.assemble)(v)
    if case == "bf16_w":
        want = jnp.bfloat16 if dt == jnp.float32 else jnp.float64
        assert sys_s[4].dtype == want
    ops_s, ops_d = cs.schur_info.ops(), DenseOps(cd.layout.dof_total)
    ord_s, ord_d = variable_order(cs), variable_order(cd)
    assert ops_s.dim == len(ord_s) == len(ord_d) == cd.layout.dof_total
    tol_sys, tol_step = TOL[
        "bf16_w" if case == "bf16_w" and dtype == "float32" else dtype
    ]

    np.testing.assert_allclose(float(cost_s), float(cost_d), rtol=tol_sys)
    g_d = np.asarray(ops_d.grad(sys_d), np.float64)[ord_d]
    g_s = np.asarray(ops_s.grad(sys_s), np.float64)[ord_s]
    assert _rel(g_s, g_d) < tol_sys

    # xᵀHx for a random x covers every block: A_rr, W and H_ll.
    x = np.random.default_rng(0).standard_normal(len(ord_d))
    xs, xd = np.zeros_like(x), np.zeros_like(x)
    xs[ord_s], xd[ord_d] = x, x
    q_s = float(ops_s.quad(sys_s, jnp.asarray(xs, dt)))
    q_d = float(ops_d.quad(sys_d, jnp.asarray(xd, dt)))
    assert abs(q_s - q_d) / abs(q_d) < tol_sys

    if case == "dogleg_newton":
        step_s, ghg_s = ops_s.solve0_quad_grad(sys_s)
        step_d = ops_d.solve(sys_d, jnp.zeros((), dt))
        ghg_d = ops_d.quad(sys_d, ops_d.grad(sys_d))
        assert abs(float(ghg_s) - float(ghg_d)) / abs(float(ghg_d)) < tol_sys
    else:
        lam = 1e-3 * ops_d.diag_max(sys_d)
        step_s = ops_s.solve(sys_s, lam.astype(dt))
        step_d = ops_d.solve(sys_d, lam)
    x_s = np.asarray(step_s, np.float64)[ord_s]
    x_d = np.asarray(step_d, np.float64)[ord_d]
    assert np.all(np.isfinite(x_s))
    assert _rel(x_s, x_d) < tol_step
