"""BAL (Bundle Adjustment in the Large) problem family.

The reference's BA workload is a toy affine model (test/optimizeba.jl); the
BAL family is the real benchmark class named in BASELINE.json ("BAL
Ladybug-scale BA").  Cameras use the standard Snavely 9-parameter model
[angle-axis r, translation t, focal f, k1, k2] (a Euclidean chart, matching
Ceres/BAL conventions), points are 3-vectors, and the residual is the
radially-distorted reprojection error.

Loading: ``load_bal`` parses the BAL text format through the native C++
loader (nllstpu/native) when built, else a numpy fast path
(``np.fromfile(sep=' ')`` — C-speed tokenization).  ``make_bal_problem``
ingests everything through the bulk problem APIs, so building a million-
observation problem is a handful of array ops.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.manifolds import Euclidean
from ..core.problem import Problem
from ..core.robust import Huber

CAM = Euclidean(9)
PT = Euclidean(3)


def _rodrigues_rotate(w, x):
    """Rotate ``x`` by the angle-axis vector ``w`` (Rodrigues), smooth at
    w = 0 for jacfwd."""
    t2 = jnp.dot(w, w)
    small = t2 < 1e-14
    t2s = jnp.where(small, jnp.ones_like(t2), t2)
    theta = jnp.sqrt(t2s)
    cos_t = jnp.where(small, 1.0 - t2 / 2.0, jnp.cos(theta))
    sinc = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / theta)
    one_m_cos = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - cos_t) / t2s)
    return x * cos_t + jnp.cross(w, x) * sinc + w * (jnp.dot(w, x) * one_m_cos)


def snavely_residual(measurement, camera, point):
    """Snavely reprojection residual (BAL convention): P = R·X + t,
    p = −P.xy/P.z, distorted by 1 + k1·r² + k2·r⁴, scaled by f."""
    w, t = camera[:3], camera[3:6]
    f, k1, k2 = camera[6], camera[7], camera[8]
    p = _rodrigues_rotate(w, point) + t
    xp = -p[:2] / p[2]
    r2 = jnp.dot(xp, xp)
    distortion = 1.0 + r2 * (k1 + k2 * r2)
    return f * distortion * xp - measurement


def snavely_residual_cm(measurement, camera_cm, point_cm):
    """Components-major Snavely residual: ``camera_cm [9, B]``,
    ``point_cm [3, B]``, ``measurement [B, 2]`` → ``[2, B]``.  Every
    intermediate is a contiguous [B] vector; the
    Jacobian is synthesized by ``_auto_cm_jacobian`` (linearize + 12
    basis-tangent passes), so this single function gives real BAL
    problems the full dual-sorted assembly path."""
    w0, w1, w2 = camera_cm[0], camera_cm[1], camera_cm[2]
    t0, t1, t2 = camera_cm[3], camera_cm[4], camera_cm[5]
    f, k1, k2 = camera_cm[6], camera_cm[7], camera_cm[8]
    x0, x1, x2 = point_cm[0], point_cm[1], point_cm[2]
    # Rodrigues, smooth at w = 0 (same guarded series as _rodrigues_rotate).
    tt = w0 * w0 + w1 * w1 + w2 * w2
    small = tt < 1e-14
    tts = jnp.where(small, jnp.ones_like(tt), tt)
    theta = jnp.sqrt(tts)
    cos_t = jnp.where(small, 1.0 - tt / 2.0, jnp.cos(theta))
    sinc = jnp.where(small, 1.0 - tt / 6.0, jnp.sin(theta) / theta)
    omc = jnp.where(small, 0.5 - tt / 24.0, (1.0 - cos_t) / tts)
    wx = w1 * x2 - w2 * x1
    wy = w2 * x0 - w0 * x2
    wz = w0 * x1 - w1 * x0
    wdx = w0 * x0 + w1 * x1 + w2 * x2
    p0 = x0 * cos_t + wx * sinc + w0 * wdx * omc + t0
    p1 = x1 * cos_t + wy * sinc + w1 * wdx * omc + t1
    p2 = x2 * cos_t + wz * sinc + w2 * wdx * omc + t2
    inv = 1.0 / p2
    xp0 = -p0 * inv
    xp1 = -p1 * inv
    r2 = xp0 * xp0 + xp1 * xp1
    distortion = 1.0 + r2 * (k1 + k2 * r2)
    m = measurement.T
    return jnp.stack([f * distortion * xp0 - m[0],
                      f * distortion * xp1 - m[1]])


def snavely_jacobian_cm(measurement, camera_cm, point_cm):
    """Hand components-major Snavely residual + analytic Jacobian:
    returns ``(r [2, B], J [2, 12, B])`` (tangent columns: camera
    [w, t, f, k1, k2], then point).

    One pass instead of the 12 linear passes of the synthesized
    ``_auto_cm_jacobian`` (core/problem.py) — real-BAL assembly cost then
    matches the hand pinhole bench path.  Derivation: with Q = G·P where
    G = ∂res/∂xp = f·(D·I + 2(k1+2k2·r²)·xp·xpᵀ) and
    P = ∂xp/∂p = (1/p₂)·[[−1,0,−xp₀],[0,−1,−xp₁]], each residual row's
    gradient q gives  J_t = q,  J_X = a·q + s·(q×w) + c·(q·w)·w  (= q·R),
    J_w = s·(X×q) + c·(w·X)·q + c·(q·w)·X
          + [−s·(q·X) + A·(q·(w×X)) + B₂·(w·X)(q·w)]·w,
    with a = cosθ, s = sincθ, c = (1−cosθ)/θ², A = (a−s)/θ²,
    B₂ = (s−2c)/θ² (guarded series below θ² = 1e-14, matching the
    residual's branches).  Verified against the synthesized Jacobian in
    tests/test_bal.py."""
    w0, w1, w2 = camera_cm[0], camera_cm[1], camera_cm[2]
    t0, t1, t2 = camera_cm[3], camera_cm[4], camera_cm[5]
    f, k1, k2 = camera_cm[6], camera_cm[7], camera_cm[8]
    x0, x1, x2 = point_cm[0], point_cm[1], point_cm[2]
    tt = w0 * w0 + w1 * w1 + w2 * w2
    small = tt < 1e-14
    tts = jnp.where(small, jnp.ones_like(tt), tt)
    theta = jnp.sqrt(tts)
    a = jnp.where(small, 1.0 - tt / 2.0, jnp.cos(theta))
    s = jnp.where(small, 1.0 - tt / 6.0, jnp.sin(theta) / theta)
    c = jnp.where(small, 0.5 - tt / 24.0, (1.0 - a) / tts)
    # d(sinc)/d(θ²) = (a−s)/(2θ²); d(omc)/d(θ²) = (s−2c)/(2θ²).
    big_a = jnp.where(small, -1.0 / 3.0 + tt / 30.0, (a - s) / tts)
    big_b = jnp.where(small, -1.0 / 12.0 + tt / 180.0, (s - 2.0 * c) / tts)
    wx = w1 * x2 - w2 * x1
    wy = w2 * x0 - w0 * x2
    wz = w0 * x1 - w1 * x0
    wdx = w0 * x0 + w1 * x1 + w2 * x2
    p0 = x0 * a + wx * s + w0 * wdx * c + t0
    p1 = x1 * a + wy * s + w1 * wdx * c + t1
    p2 = x2 * a + wz * s + w2 * wdx * c + t2
    inv = 1.0 / p2
    xp0 = -p0 * inv
    xp1 = -p1 * inv
    r2 = xp0 * xp0 + xp1 * xp1
    dist = 1.0 + r2 * (k1 + k2 * r2)
    m = measurement.T
    res = jnp.stack([f * dist * xp0 - m[0], f * dist * xp1 - m[1]])
    # Q = G·P per residual row.
    dd2 = 2.0 * (k1 + 2.0 * k2 * r2)
    g00 = f * (dist + dd2 * xp0 * xp0)
    g01 = f * dd2 * xp0 * xp1
    g11 = f * (dist + dd2 * xp1 * xp1)
    q00 = -inv * g00
    q01 = -inv * g01
    q02 = -inv * (g00 * xp0 + g01 * xp1)
    q10 = -inv * g01
    q11 = -inv * g11
    q12 = -inv * (g01 * xp0 + g11 * xp1)

    def row(q0, q1, q2):
        qdw = q0 * w0 + q1 * w1 + q2 * w2
        qdx = q0 * x0 + q1 * x1 + q2 * x2
        qdwx = q0 * wx + q1 * wy + q2 * wz  # q·(w×X)
        # X×q
        xq0 = x1 * q2 - x2 * q1
        xq1 = x2 * q0 - x0 * q2
        xq2 = x0 * q1 - x1 * q0
        # q×w
        qw0 = q1 * w2 - q2 * w1
        qw1 = q2 * w0 - q0 * w2
        qw2 = q0 * w1 - q1 * w0
        coef = -s * qdx + big_a * qdwx + big_b * wdx * qdw
        jw = [
            s * xq0 + c * (wdx * q0 + qdw * x0) + coef * w0,
            s * xq1 + c * (wdx * q1 + qdw * x1) + coef * w1,
            s * xq2 + c * (wdx * q2 + qdw * x2) + coef * w2,
        ]
        jx = [
            a * q0 + s * qw0 + c * qdw * w0,
            a * q1 + s * qw1 + c * qdw * w1,
            a * q2 + s * qw2 + c * qdw * w2,
        ]
        return jw, jx

    jw0, jx0 = row(q00, q01, q02)
    jw1, jx1 = row(q10, q11, q12)
    row0 = jnp.stack(
        jw0
        + [q00, q01, q02, dist * xp0, f * r2 * xp0, f * r2 * r2 * xp0]
        + jx0,
        axis=0,
    )
    row1 = jnp.stack(
        jw1
        + [q10, q11, q12, dist * xp1, f * r2 * xp1, f * r2 * r2 * xp1]
        + jx1,
        axis=0,
    )
    return res, jnp.stack([row0, row1], axis=0)  # [2, 12, B]


def load_bal(path: str) -> dict:
    """Parse a BAL text file into arrays: cameras [C,9], points [P,3],
    cam_idx [K], pt_idx [K], observations [K,2]."""
    from ..utils import native

    parsed = native.parse_bal(path)
    if parsed is None:
        raw = np.fromfile(path, sep=" ")
        ncam, npt, nobs = int(raw[0]), int(raw[1]), int(raw[2])
        body = raw[3:]
        obs = body[: nobs * 4].reshape(nobs, 4)
        rest = body[nobs * 4 :]
        cameras = rest[: ncam * 9].reshape(ncam, 9)
        points = rest[ncam * 9 : ncam * 9 + npt * 3].reshape(npt, 3)
        parsed = dict(
            cameras=cameras,
            points=points,
            cam_idx=obs[:, 0].astype(np.int32),
            pt_idx=obs[:, 1].astype(np.int32),
            observations=obs[:, 2:4],
        )
    return parsed


def make_bal_problem(data: dict, dtype=None, robust_width=None,
                     batched="cm", hand_jacobian=True, kernel=None,
                     kernel_params=None) -> tuple:
    """Build a Problem from parsed BAL arrays; returns
    ``(problem, camera_handles, point_handles)`` — or, with an adaptive
    ``kernel``, ``(problem, camera_handles, point_handles, kernel_handle)``.

    ``batched="cm"`` (default) uses the components-major residual with the
    hand analytic Jacobian (``hand_jacobian=False`` falls back to the
    synthesized 12-pass cm Jacobian) — real BAL data then takes the
    dual-sorted assembly path; ``batched=False``
    keeps the per-cost vmapped formulation (the reference-shaped
    baseline).

    ``kernel`` overrides the robustifier (``robust_width`` builds a Huber).
    An :class:`~nllstpu.AdaptiveRobustifier` (e.g. ContaminatedGaussian,
    Barron) adds ONE shared kernel-parameter variable — initialized from
    ``kernel_params`` — jointly optimized with the cameras and points; the
    cm batch then rides the adaptive Schur fast path (single-reduction
    kernel blocks)."""
    from ..core.robust import AdaptiveRobustifier

    p = Problem(dtype=dtype)
    cameras = p.add_variables(CAM, data["cameras"])
    points = p.add_variables(PT, data["points"])
    if kernel is None:
        kernel = Huber(robust_width) if robust_width else None
    kh = None
    slots = [(CAM, data["cam_idx"]), (PT, data["pt_idx"])]
    if isinstance(kernel, AdaptiveRobustifier):
        if kernel_params is None:
            raise ValueError("adaptive kernel requires kernel_params")
        kh = p.add_variable(kernel.manifold, kernel_params)
        n = len(np.asarray(data["pt_idx"]))
        slots = [
            (kernel.manifold, np.full(n, kh.index, np.int32))
        ] + slots
    if batched == "cm":
        p.add_cost_batch(
            snavely_residual_cm,
            slots=slots,
            params=np.asarray(data["observations"]),
            kernel=kernel,
            batched="cm",
            # The hand Jacobian covers the NON-kernel slots — exactly the
            # adaptive contract (the kernel's blocks come from
            # rho_dkernel_cm), so it applies to both forms.
            jacobian=snavely_jacobian_cm if hand_jacobian else None,
        )
    else:
        p.add_cost_batch(
            snavely_residual,
            slots=slots,
            params=np.asarray(data["observations"]),
            kernel=kernel,
        )
    if kh is not None:
        return p, cameras, points, kh
    return p, cameras, points


def make_synthetic_bal(ncameras=16, npoints=256, obs_per_point=4, seed=1,
                       noise=0.0) -> dict:
    """Synthetic BAL-format data with measurements generated from ground
    truth (zero-cost optimum, the reference's test-fixture pattern)."""
    rng = np.random.default_rng(seed)
    cameras = np.zeros((ncameras, 9))
    for i in range(ncameras):
        ang = 2 * np.pi * i / ncameras
        # Small rotations around identity; camera centers on a ring.
        cameras[i, :3] = rng.standard_normal(3) * 0.05
        center = np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0])
        cameras[i, 3:6] = -center  # t = -R·C ≈ -C for small rotations
        cameras[i, 6] = 500.0 + rng.random() * 100
        cameras[i, 7:9] = rng.standard_normal(2) * 1e-7
    points = rng.standard_normal((npoints, 3)) * 0.5
    points[:, 2] += 10.0  # keep in front of all cameras

    cam_idx = np.empty(npoints * obs_per_point, dtype=np.int32)
    pt_idx = np.empty(npoints * obs_per_point, dtype=np.int32)
    for j in range(npoints):
        cams = rng.choice(ncameras, size=obs_per_point, replace=False)
        cam_idx[j * obs_per_point : (j + 1) * obs_per_point] = cams
        pt_idx[j * obs_per_point : (j + 1) * obs_per_point] = j

    # Vectorized ground-truth projection (numpy mirror of snavely_residual).
    w = cameras[cam_idx, :3]
    t = cameras[cam_idx, 3:6]
    x = points[pt_idx]
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    theta = np.where(theta < 1e-12, 1e-12, theta)
    axis = w / theta
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    p = (
        x * cos_t
        + np.cross(axis, x) * sin_t
        + axis * (np.sum(axis * x, axis=1, keepdims=True) * (1 - cos_t))
        + t
    )
    xp = -p[:, :2] / p[:, 2:3]
    r2 = np.sum(xp * xp, axis=1, keepdims=True)
    f = cameras[cam_idx, 6:7]
    k1 = cameras[cam_idx, 7:8]
    k2 = cameras[cam_idx, 8:9]
    obs = f * (1.0 + r2 * (k1 + k2 * r2)) * xp
    obs = obs + rng.standard_normal(obs.shape) * noise
    return dict(
        cameras=cameras,
        points=points,
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        observations=obs,
    )


def make_realistic_bal(ncameras=49, npoints=2048, seed=1, noise=0.0,
                       track_alpha=2.3, max_track=None, cam_skew=1.0) -> dict:
    """Synthetic BAL data with **realistic degree distributions** — the
    shapes that real BAL files (Ladybug/Trafalgar/Venice) exhibit and that
    ``make_synthetic_bal``'s uniform ``obs_per_point`` does not:

    * **long-tail track lengths**: per-point observation counts follow a
      discrete power law P(k) ∝ k^-``track_alpha`` on [2, ``max_track``]
      (real BAL means are ~4 obs/point with maxima 10-30x that), and
    * **skewed camera degrees**: each track anchors at a camera drawn from
      a lognormal(σ=``cam_skew``) popularity distribution and covers a
      contiguous camera window (trajectory-style co-visibility), so
      obs-per-camera spreads over an order of magnitude.

    Measurements are generated from ground truth (zero-cost optimum, the
    reference's fixture pattern, test/optimizeba.jl:29).  This is the
    regression fixture for the Schur fast paths' *skew* handling — the
    bucketed obs-major layout and the camera-repack-free fused assembly."""
    rng = np.random.default_rng(seed)
    if max_track is None:
        max_track = min(ncameras, 48)
    max_track = min(max_track, ncameras)

    # Discrete power-law track lengths via inverse-CDF sampling.
    ks = np.arange(2, max_track + 1)
    pk = ks.astype(np.float64) ** (-track_alpha)
    pk /= pk.sum()
    track_len = rng.choice(ks, size=npoints, p=pk)

    # Lognormal camera popularity; anchor camera per track.
    cam_w = rng.lognormal(mean=0.0, sigma=cam_skew, size=ncameras)
    cam_w /= cam_w.sum()
    anchor = rng.choice(ncameras, size=npoints, p=cam_w)

    # Contiguous camera window per track (mod ncameras): distinct cameras.
    pt_idx = np.repeat(np.arange(npoints, dtype=np.int32), track_len)
    within = np.concatenate([np.arange(k) for k in track_len])
    cam_idx = ((np.repeat(anchor, track_len) + within) % ncameras).astype(
        np.int32
    )

    # Geometry: ring cameras, central point cloud (same as
    # make_synthetic_bal — every camera sees every point, so visibility is
    # purely the sampled graph above).
    cameras = np.zeros((ncameras, 9))
    for i in range(ncameras):
        ang = 2 * np.pi * i / ncameras
        cameras[i, :3] = rng.standard_normal(3) * 0.05
        center = np.array([4 * np.cos(ang), 4 * np.sin(ang), 1.0])
        cameras[i, 3:6] = -center
        cameras[i, 6] = 500.0 + rng.random() * 100
        cameras[i, 7:9] = rng.standard_normal(2) * 1e-7
    points = rng.standard_normal((npoints, 3)) * 0.5
    points[:, 2] += 10.0

    w = cameras[cam_idx, :3]
    t = cameras[cam_idx, 3:6]
    x = points[pt_idx]
    theta = np.linalg.norm(w, axis=1, keepdims=True)
    theta = np.where(theta < 1e-12, 1e-12, theta)
    axis = w / theta
    cos_t = np.cos(theta)
    sin_t = np.sin(theta)
    p = (
        x * cos_t
        + np.cross(axis, x) * sin_t
        + axis * (np.sum(axis * x, axis=1, keepdims=True) * (1 - cos_t))
        + t
    )
    xp = -p[:, :2] / p[:, 2:3]
    r2 = np.sum(xp * xp, axis=1, keepdims=True)
    f = cameras[cam_idx, 6:7]
    k1 = cameras[cam_idx, 7:8]
    k2 = cameras[cam_idx, 8:9]
    obs = f * (1.0 + r2 * (k1 + k2 * r2)) * xp
    obs = obs + rng.standard_normal(obs.shape) * noise
    return dict(
        cameras=cameras,
        points=points,
        cam_idx=cam_idx,
        pt_idx=pt_idx,
        observations=obs,
    )


def write_bal(path: str, data: dict):
    """Write arrays back to the BAL text format (for loader round-trip
    tests and interchange)."""
    ncam = data["cameras"].shape[0]
    npt = data["points"].shape[0]
    nobs = data["cam_idx"].shape[0]
    with open(path, "w") as fh:
        fh.write(f"{ncam} {npt} {nobs}\n")
        for ci, pi, (ox, oy) in zip(
            data["cam_idx"], data["pt_idx"], data["observations"]
        ):
            fh.write(f"{ci} {pi} {ox:.17g} {oy:.17g}\n")
        for cam in data["cameras"]:
            fh.write("\n".join(f"{v:.17g}" for v in cam) + "\n")
        for pt in data["points"]:
            fh.write("\n".join(f"{v:.17g}" for v in pt) + "\n")
