"""SE(3) pose-graph optimization family.

A problem class beyond the reference's test suite but squarely inside its
capability claim (arbitrary residual blocks over manifold variables): poses
on SE(3) connected by relative-transform measurements (odometry + loop
closures).  The variable-cost graph is sparse but NOT bipartite, so this is
the showcase for the matrix-free PCG backend (``solver="cg"``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..core.manifolds import SE3, so3_log
from ..core.problem import Problem

POSE = SE3()


def relative_pose_residual(measurement, pose_i, pose_j):
    """6-vector residual of a relative SE(3) measurement Z = (R_z | t_z):
    [log(R_zᵀ R_iᵀ R_j), R_iᵀ(t_j − t_i) − t_z].

    The rotation products run at full precision: reduced-precision
    (bf16) matmuls put ~1e-2 of rounding into the error rotation, which both
    floors the achievable cost and lands the log on its identity
    singularity."""
    hp = jax.lax.Precision.HIGHEST
    r_z, t_z = measurement[:, :3], measurement[:, 3]
    r_i, t_i = pose_i[:, :3], pose_i[:, 3]
    r_j, t_j = pose_j[:, :3], pose_j[:, 3]
    e_rot = so3_log(
        jnp.matmul(r_z.T, jnp.matmul(r_i.T, r_j, precision=hp), precision=hp)
    )
    e_t = jnp.matmul(r_i.T, t_j - t_i, precision=hp) - t_z
    return jnp.concatenate([e_rot, e_t])


def _np_se3(r, t):
    return np.concatenate([r, t[:, None]], axis=1)


def _np_so3_exp(w):
    """Host-side Rodrigues (problem construction must not dispatch thousands
    of tiny device ops)."""
    theta = np.linalg.norm(w)
    k = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]]
    )
    if theta < 1e-12:
        return np.eye(3) + k
    a = np.sin(theta) / theta
    b = (1.0 - np.cos(theta)) / (theta * theta)
    return np.eye(3) + a * k + b * (k @ k)


def make_pose_graph(n_poses=20, n_loops=5, noise=0.0, perturb=0.05, seed=1,
                    dtype=None):
    """Ground-truth poses on a circle, odometry edges between consecutive
    poses, ``n_loops`` random loop closures; measurements generated from
    ground truth (+optional noise), initial values perturbed in the tangent
    space.  Returns ``(problem, pose_handles, ground_truth [n,3,4])``;
    ``dtype`` sets the problem precision (f32 for production on the GPU)."""
    rng = np.random.default_rng(seed)

    def rotz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    truth = []
    for i in range(n_poses):
        ang = 2 * np.pi * i / n_poses
        r = rotz(ang)
        t = np.array([np.cos(ang), np.sin(ang), 0.1 * np.sin(3 * ang)])
        truth.append(_np_se3(r, t))
    truth = np.stack(truth)

    edges = [(i, i + 1) for i in range(n_poses - 1)] + [(n_poses - 1, 0)]
    for _ in range(n_loops):
        i, j = rng.choice(n_poses, size=2, replace=False)
        edges.append((int(i), int(j)))

    meas = []
    for i, j in edges:
        r_i, t_i = truth[i][:, :3], truth[i][:, 3]
        r_j, t_j = truth[j][:, :3], truth[j][:, 3]
        r_z = r_i.T @ r_j
        t_z = r_i.T @ (t_j - t_i)
        if noise:
            r_z = r_z @ _np_so3_exp(rng.standard_normal(3) * noise)
            t_z = t_z + rng.standard_normal(3) * noise
        meas.append(_np_se3(r_z, t_z))
    meas = np.stack(meas)

    # Perturb initial values in the tangent space (keeps them on-manifold).
    init = truth.copy()
    for i in range(1, n_poses):
        w = rng.standard_normal(3) * perturb
        v = rng.standard_normal(3) * perturb
        r = init[i][:, :3] @ _np_so3_exp(w)
        t = init[i][:, 3] + init[i][:, :3] @ v
        init[i] = _np_se3(r, t)

    p = Problem(dtype=dtype)
    poses = p.add_variables(POSE, init)
    ei = np.array([e[0] for e in edges], dtype=np.int32)
    ej = np.array([e[1] for e in edges], dtype=np.int32)
    p.add_cost_batch(
        relative_pose_residual,
        slots=[(POSE, ei), (POSE, ej)],
        params=meas,
    )
    return p, poses, truth
