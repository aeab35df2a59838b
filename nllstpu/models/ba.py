"""Synthetic bundle-adjustment problem builders.

``make_affine_ba`` mirrors the reference's BA workload
(test/optimizeba.jl:3-47): cameras are 6-vector affine projections, landmarks
3-vectors, measurements generated from ground truth (so the global optimum has
exactly zero cost), with a banded visibility pattern controlled by
``prop_visible``.

``make_pinhole_ba`` is the framework-native "real" BA family the reference
leaves to users: SE(3) camera poses with a pinhole projection — exercising the
SO(3)/SE(3) manifolds — for benchmarking at BAL-like scales.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..core.manifolds import SE3, Euclidean
from ..core.problem import Problem
from ..core.robust import Huber


def affine_project(measurement, pose, point):
    """Residual of the affine two-row projection
    (test/optimizeba.jl:4): [pose[0:3]·X, pose[3:6]·X] − measurement."""
    return jnp.stack([pose[:3] @ point, pose[3:] @ point]) - measurement


def _banded_visibility(ncameras, nlandmarks, prop_visible, rng=None):
    """The reference's deterministic banded visibility mask
    (test/optimizeba.jl:22-23): distance of camera index from a landmark-
    dependent center, thresholded to the requested density."""
    cams = np.arange(1, ncameras + 1, dtype=np.float64)[:, None]
    centers = np.linspace(2, ncameras - 1, nlandmarks)[None, :]
    dist = np.abs(cams - centers)
    thresh = np.sort(dist.ravel())[
        int(np.ceil(dist.size * prop_visible)) - 1
    ]
    return dist <= thresh


def make_affine_ba(ncameras=3, nlandmarks=5, prop_visible=1.0, seed=1):
    """Ground-truth-consistent affine BA problem; returns
    ``(problem, camera_handles, landmark_handles)``."""
    rng = np.random.default_rng(seed)
    p = Problem()
    cam_man, lmk_man = Euclidean(6), Euclidean(3)
    cam_offset = np.array([1.0, 0, 0, 0, 1.0, 0])
    cameras = [
        p.add_variable(cam_man, rng.standard_normal(6) + cam_offset)
        for _ in range(ncameras)
    ]
    lmk_offset = np.array([-0.5, -0.5, 10.0])
    landmarks = [
        p.add_variable(lmk_man, rng.random(3) + lmk_offset)
        for _ in range(nlandmarks)
    ]
    cam_values = [p.get_value(c) for c in cameras]
    lmk_values = [p.get_value(l) for l in landmarks]
    vis = _banded_visibility(ncameras, nlandmarks, prop_visible)
    for ci in range(ncameras):
        pose = cam_values[ci]
        for li in range(nlandmarks):
            if vis[ci, li]:
                point = lmk_values[li]
                meas = np.array([pose[:3] @ point, pose[3:] @ point])
                p.add_cost(
                    affine_project, (cameras[ci], landmarks[li]), params=meas
                )
    return p, cameras, landmarks


def perturb_ba(problem, handles, scale, seed=2):
    """Add Gaussian noise to Euclidean-storage variables, vectorized per
    family (reference perturb_ba_problem, test/optimizeba.jl:38-47).  Only
    meaningful for manifolds whose storage is unconstrained (don't perturb
    SE(3) poses this way — use tangent noise + retract instead)."""
    rng = np.random.default_rng(seed)
    by_fam = {}
    for h in handles:
        by_fam.setdefault(h.family, []).append(h.index)
    for fam_name_, idxs in by_fam.items():
        fam = problem._families[fam_name_]
        idxs = np.asarray(idxs)
        noise = rng.standard_normal((len(idxs),) + fam.manifold.shape) * scale
        fam.values[idxs] = fam.values[idxs] + noise
    problem._dirty = True


def pinhole_project(measurement, pose, point):
    """Pinhole reprojection residual for an SE(3) camera: transform the world
    point into the camera frame (world-to-camera convention: X_c = Rᵀ(X − t))
    and project to the normalized image plane."""
    r = pose[:, :3]
    t = pose[:, 3]
    xc = r.T @ (point - t)
    return xc[:2] / xc[2] - measurement


def pinhole_project_jacobian(measurement, pose, point):
    """Hand Jacobian of :func:`pinhole_project` in SE(3)/R³ tangent
    coordinates (columns: camera [w, v] then point), verified against the
    autodiff path in tests.  With the right-multiplied retraction
    R → R·exp([w]×), t → t + R·v:

        X_c = exp(−[w]×)·Rᵀ(X − t − R v)  ⇒  ∂X_c/∂w = [X_c]×,
        ∂X_c/∂v = −I,  ∂X_c/∂X = Rᵀ,
        ∂π/∂X_c = [[1/z, 0, −x/z²], [0, 1/z, −y/z²]].
    """
    r = pose[:, :3]
    t = pose[:, 3]
    xc = r.T @ (point - t)
    x, y, z = xc[0], xc[1], xc[2]
    inv_z = 1.0 / z
    res = xc[:2] * inv_z - measurement
    # dpi: [2, 3]
    zero = jnp.zeros_like(z)
    dpi = jnp.array(
        [[inv_z, zero, -x * inv_z * inv_z], [zero, inv_z, -y * inv_z * inv_z]]
    )
    skew_xc = jnp.array(
        [[zero, -z, y], [z, zero, -x], [-y, x, zero]]
    )
    j_w = dpi @ skew_xc  # [2, 3]
    j_v = -dpi  # [2, 3]
    j_pt = dpi @ r.T  # [2, 3]
    return res, jnp.concatenate([j_w, j_v, j_pt], axis=1)


def pinhole_project_batched(measurement, pose, point):
    """Whole-batch pinhole residual: scalar-expanded [B]-major math (no
    per-cost vmap) — the batched form for the hot path."""
    r = pose[:, :, :3]  # [B, 3, 3]
    t = pose[:, :, 3]
    d = point - t  # [B, 3]
    # X_c = Rᵀ d, expanded by columns of R.
    xc0 = r[:, 0, 0] * d[:, 0] + r[:, 1, 0] * d[:, 1] + r[:, 2, 0] * d[:, 2]
    xc1 = r[:, 0, 1] * d[:, 0] + r[:, 1, 1] * d[:, 1] + r[:, 2, 1] * d[:, 2]
    xc2 = r[:, 0, 2] * d[:, 0] + r[:, 1, 2] * d[:, 1] + r[:, 2, 2] * d[:, 2]
    inv_z = 1.0 / xc2
    return jnp.stack(
        [xc0 * inv_z - measurement[:, 0], xc1 * inv_z - measurement[:, 1]],
        axis=-1,
    )


def pinhole_project_jacobian_batched(measurement, pose, point):
    """Whole-batch analytic Jacobian (see :func:`pinhole_project_jacobian`),
    scalar-expanded over [B]."""
    r = pose[:, :, :3]
    t = pose[:, :, 3]
    d = point - t
    xc0 = r[:, 0, 0] * d[:, 0] + r[:, 1, 0] * d[:, 1] + r[:, 2, 0] * d[:, 2]
    xc1 = r[:, 0, 1] * d[:, 0] + r[:, 1, 1] * d[:, 1] + r[:, 2, 1] * d[:, 2]
    xc2 = r[:, 0, 2] * d[:, 0] + r[:, 1, 2] * d[:, 1] + r[:, 2, 2] * d[:, 2]
    inv_z = 1.0 / xc2
    u = xc0 * inv_z
    v = xc1 * inv_z
    res = jnp.stack([u - measurement[:, 0], v - measurement[:, 1]], axis=-1)
    # dπ rows: dπ0 = inv_z·(1, 0, −u), dπ1 = inv_z·(0, 1, −v);
    # dX_c/dw = skew(X_c) = [[0,−z,y],[z,0,−x],[−y,x,0]] with (x,y,z)=X_c.
    # J_w = dπ @ skew, expanded (derivation checked against autodiff):
    zero = jnp.zeros_like(u)
    jw0 = jnp.stack([u * v, -(1.0 + u * u), xc1 * inv_z], axis=-1)
    jw1 = jnp.stack([1.0 + v * v, -u * v, -xc0 * inv_z], axis=-1)
    # J_v = -dπ
    jv0 = jnp.stack([-inv_z, zero, u * inv_z], axis=-1)
    jv1 = jnp.stack([zero, -inv_z, v * inv_z], axis=-1)
    # J_pt = dπ · Rᵀ: row i = dπ_i as row vector times Rᵀ = (R @ dπ_iᵀ)ᵀ
    jp00 = (r[:, 0, 0] - r[:, 0, 2] * u) * inv_z
    jp01 = (r[:, 1, 0] - r[:, 1, 2] * u) * inv_z
    jp02 = (r[:, 2, 0] - r[:, 2, 2] * u) * inv_z
    jp10 = (r[:, 0, 1] - r[:, 0, 2] * v) * inv_z
    jp11 = (r[:, 1, 1] - r[:, 1, 2] * v) * inv_z
    jp12 = (r[:, 2, 1] - r[:, 2, 2] * v) * inv_z
    row0 = jnp.concatenate(
        [jw0, jv0, jnp.stack([jp00, jp01, jp02], axis=-1)], axis=-1
    )
    row1 = jnp.concatenate(
        [jw1, jv1, jnp.stack([jp10, jp11, jp12], axis=-1)], axis=-1
    )
    return res, jnp.stack([row0, row1], axis=1)  # [B, 2, 9]


def pinhole_project_cm(measurement, pose_cm, point_cm):
    """Components-major pinhole residual: ``pose_cm [12, B]`` (row-major
    [3,4] flattened), ``point_cm [3, B]``; returns ``[2, B]``.  Every
    intermediate is a contiguous [B] vector."""
    r00, r01, r02, t0 = pose_cm[0], pose_cm[1], pose_cm[2], pose_cm[3]
    r10, r11, r12, t1 = pose_cm[4], pose_cm[5], pose_cm[6], pose_cm[7]
    r20, r21, r22, t2 = pose_cm[8], pose_cm[9], pose_cm[10], pose_cm[11]
    dx = point_cm[0] - t0
    dy = point_cm[1] - t1
    dz = point_cm[2] - t2
    xc0 = r00 * dx + r10 * dy + r20 * dz
    xc1 = r01 * dx + r11 * dy + r21 * dz
    xc2 = r02 * dx + r12 * dy + r22 * dz
    inv = 1.0 / xc2
    m = measurement.T
    return jnp.stack([xc0 * inv - m[0], xc1 * inv - m[1]], axis=0)


def pinhole_project_jacobian_cm(measurement, pose_cm, point_cm):
    """Components-major residual + analytic Jacobian: returns
    ``(r [2, B], J [2, 9, B])`` (tangent columns: camera [w, v], point)."""
    r00, r01, r02, t0 = pose_cm[0], pose_cm[1], pose_cm[2], pose_cm[3]
    r10, r11, r12, t1 = pose_cm[4], pose_cm[5], pose_cm[6], pose_cm[7]
    r20, r21, r22, t2 = pose_cm[8], pose_cm[9], pose_cm[10], pose_cm[11]
    dx = point_cm[0] - t0
    dy = point_cm[1] - t1
    dz = point_cm[2] - t2
    xc0 = r00 * dx + r10 * dy + r20 * dz
    xc1 = r01 * dx + r11 * dy + r21 * dz
    xc2 = r02 * dx + r12 * dy + r22 * dz
    inv = 1.0 / xc2
    u = xc0 * inv
    v = xc1 * inv
    m = measurement.T
    res = jnp.stack([u - m[0], v - m[1]], axis=0)
    zero = jnp.zeros_like(u)
    row0 = jnp.stack(
        [
            u * v, -(1.0 + u * u), xc1 * inv,  # d/dw
            -inv, zero, u * inv,  # d/dv
            (r00 - r02 * u) * inv, (r10 - r12 * u) * inv, (r20 - r22 * u) * inv,
        ],
        axis=0,
    )
    row1 = jnp.stack(
        [
            1.0 + v * v, -u * v, -xc0 * inv,
            zero, -inv, v * inv,
            (r01 - r02 * v) * inv, (r11 - r12 * v) * inv, (r21 - r22 * v) * inv,
        ],
        axis=0,
    )
    return res, jnp.stack([row0, row1], axis=0)  # [2, 9, B]


def make_pinhole_ba(ncameras=8, nlandmarks=64, prop_visible=1.0, seed=1,
                    noise=0.0, robust_width=None, dtype=None,
                    hand_jacobian=False, batched=False):
    """SE(3)+pinhole BA with ground-truth-generated measurements.  Cameras
    sit on a ring of radius 2 looking at the origin; landmarks fill a unit
    cube around the origin.  Returns ``(problem, cameras, landmarks)``."""
    from .. import config

    rng = np.random.default_rng(seed)
    p = Problem(dtype=dtype or config.default_dtype)
    cam_man, lmk_man = SE3(), Euclidean(3)

    def look_at(eye):
        z = -eye / np.linalg.norm(eye)  # camera z looks at origin
        up = np.array([0.0, 0.0, 1.0])
        x = np.cross(up, z)
        if np.linalg.norm(x) < 1e-6:
            x = np.array([1.0, 0.0, 0.0])
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        r = np.stack([x, y, z], axis=1)
        return np.concatenate([r, eye[:, None]], axis=1)

    poses = np.stack(
        [
            look_at(
                np.array(
                    [
                        2 * np.cos(2 * np.pi * i / ncameras),
                        2 * np.sin(2 * np.pi * i / ncameras),
                        0.5,
                    ]
                )
            )
            for i in range(ncameras)
        ]
    )  # [C, 3, 4]
    points = rng.random((nlandmarks, 3)) - 0.5
    cameras = p.add_variables(cam_man, poses)
    landmarks = p.add_variables(lmk_man, points)

    # Fully-vectorized measurement generation + bulk cost ingestion.
    vis = _banded_visibility(ncameras, nlandmarks, prop_visible)
    ci, li = np.nonzero(vis)
    r = poses[ci, :, :3]  # [K, 3, 3]
    t = poses[ci, :, 3]  # [K, 3]
    xc = np.einsum("kij,ki->kj", r, points[li] - t)  # R^T (X - t)
    meas = xc[:, :2] / xc[:, 2:3] + rng.standard_normal((len(ci), 2)) * noise
    kernel = Huber(robust_width) if robust_width else None
    if batched == "cm":
        p.add_cost_batch(
            pinhole_project_cm,
            slots=[(cam_man, ci), (lmk_man, li)],
            params=meas,
            kernel=kernel,
            jacobian=pinhole_project_jacobian_cm,
            batched="cm",
        )
    elif batched:
        p.add_cost_batch(
            pinhole_project_batched,
            slots=[(cam_man, ci), (lmk_man, li)],
            params=meas,
            kernel=kernel,
            jacobian=pinhole_project_jacobian_batched,
            batched=True,
        )
    else:
        p.add_cost_batch(
            pinhole_project,
            slots=[(cam_man, ci), (lmk_man, li)],
            params=meas,
            kernel=kernel,
            jacobian=pinhole_project_jacobian if hand_jacobian else None,
        )
    return p, cameras, landmarks
