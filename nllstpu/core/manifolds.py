"""Variable-block manifolds: tangent-space dimension + retraction.

Reference parity: NLLSsolver.jl expresses variable blocks through two traits,
``nvars(var)`` (intrinsic DoF) and ``update(var, updatevec, start)`` (the
tangent-space "boxplus"); see /root/reference/src/variable.jl and
src/docstrings.jl:5-57.  In this framework a *manifold* object carries both:
``dof`` (static tangent dimension) and ``retract(x, delta)`` (the update).
Retractions are pure jax functions so that Jacobians of residuals are obtained
by ``jax.jacfwd`` of ``residual ∘ retract`` at the zero tangent — the JAX
equivalent of the reference pushing ForwardDiff duals through ``update``
(src/autodiff.jl:57-61).

All variables of one manifold family are stored stacked as an array of shape
``[n, *manifold.shape]`` and retracted with a single ``vmap`` — the batched
replacement for the reference's per-instance dispatch.

Invariant every manifold must satisfy: ``retract(x, 0) == x`` (bitwise where
possible), because fixed variables receive an exactly-zero tangent update.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class Manifold:
    """Base class.  Subclasses define ``dof``, ``shape`` and ``retract``.

    Manifold instances are hashable trace-time constants (no array state) and
    double as the grouping key for variable families.
    """

    @property
    def dof(self) -> int:
        raise NotImplementedError

    @property
    def shape(self) -> tuple:
        raise NotImplementedError

    def retract(self, x, delta):
        """Return ``x ⊞ delta`` where ``delta`` has shape ``[dof]``."""
        raise NotImplementedError

    def retract_cm(self, x_cm, delta_cm):
        """Components-major batched retract: ``x_cm [ambient, B]``,
        ``delta_cm [dof, B]`` → ``[ambient, B]``.  Used by the synthesized
        components-major Jacobian (``Problem.add_cost_batch(batched='cm')``
        without a hand Jacobian): the autodiff tangent pushes through this
        — exactly the reference's duals-through-``update`` contract
        (src/autodiff.jl:57-61), vectorized.  The default vmaps the scalar
        retract over the batch axis (correct everywhere; batch-minor vmap
        is not the fast layout, so manifolds with cm-native math should
        override — Euclidean does)."""
        import jax

        amb = self.ambient

        def one(x, d):
            return self.retract(x.reshape(self.shape), d).reshape(amb)

        return jax.vmap(one, in_axes=(-1, -1), out_axes=-1)(x_cm, delta_cm)

    @property
    def ambient(self) -> int:
        """Number of scalars in the stored representation."""
        size = 1
        for s in self.shape:
            size *= s
        return size


@dataclasses.dataclass(frozen=True)
class Euclidean(Manifold):
    """Fixed-length Euclidean vector (reference ``EuclideanVector{N}``,
    src/variable.jl:7-10).  ``n == 0`` is not allowed."""

    n: int

    @property
    def dof(self):
        return self.n

    @property
    def shape(self):
        return (self.n,)

    def retract(self, x, delta):
        return x + delta

    def retract_cm(self, x_cm, delta_cm):
        return x_cm + delta_cm


@dataclasses.dataclass(frozen=True)
class Scalar(Manifold):
    """Scalar variable (reference ``Number``, src/variable.jl:3-5). Stored as
    shape-() array."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, x, delta):
        return x + delta[0]


def _positive_scale(val, delta):
    """max(val, tiny) * exp(delta) — reference src/variable.jl:22.  The
    result is floored at the smallest normal so XLA's flush-to-zero of
    subnormals cannot collapse the value to 0 and break positivity."""
    tiny = jnp.finfo(jnp.result_type(val, float)).tiny
    return jnp.maximum(jnp.where(val > 0, val, tiny) * jnp.exp(delta), tiny)


def _zero_to_one_update(val, delta):
    """Reference src/variable.jl:29-32: v' = v·eᵈ / (1 + v·eᵈ − v), clamped
    to 1 when v·eᵈ overflows."""
    scaled = _positive_scale(val, delta)
    out = scaled / (1 + (scaled - val))
    return jnp.where(jnp.isinf(scaled), jnp.ones_like(out), out)


@dataclasses.dataclass(frozen=True)
class ZeroToInf(Manifold):
    """Strictly-positive scalar with multiplicative-exponential update
    (reference ``ZeroToInfScalar``, src/variable.jl:17-22)."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, x, delta):
        return _positive_scale(x, delta[0])


@dataclasses.dataclass(frozen=True)
class ZeroToOne(Manifold):
    """Scalar constrained to (0, 1) (reference ``ZeroToOneScalar``,
    src/variable.jl:24-32)."""

    @property
    def dof(self):
        return 1

    @property
    def shape(self):
        return ()

    def retract(self, x, delta):
        return _zero_to_one_update(x, delta[0])


def _skew(w):
    wx, wy, wz = w[0], w[1], w[2]
    z = jnp.zeros_like(wx)
    return jnp.array([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def so3_exp(w):
    """Rodrigues' formula, smooth (Taylor-guarded) at w = 0 so that jacfwd at
    the zero tangent is exact."""
    t2 = jnp.dot(w, w)
    small = t2 < 1e-12
    t2s = jnp.where(small, jnp.ones_like(t2), t2)
    theta = jnp.sqrt(t2s)
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / t2s)
    k = _skew(w)
    return jnp.eye(3, dtype=w.dtype) + a * k + b * (k @ k)


def so3_log(r):
    """Axis-angle vector of a rotation matrix (inverse of :func:`so3_exp`),
    smooth near the identity.  Accurate for rotation angles below ~π−1e-3
    (pose-graph residuals live near the identity).

    θ comes from ``atan2(|vee|/2, (tr−1)/2)`` rather than ``arccos``:
    arccos has an infinite derivative at its clipped endpoint c = 1, so
    ``jacfwd`` of an arccos-based log NaNs for exact-identity rotations —
    which reduced-precision matmuls in user residuals (bf16, TF32) produce
    routinely (trace rounds to exactly 3).  atan2 is smooth there, and the
    θ/(2 sin θ) factor is expressed via |vee| = 2 sin θ with a Taylor
    guard so the whole map differentiates cleanly at the identity."""
    trace = r[0, 0] + r[1, 1] + r[2, 2]
    vee = jnp.stack(
        [r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]
    )
    s2 = jnp.dot(vee, vee)  # (2 sin θ)²
    small = s2 < 1e-12
    s = jnp.sqrt(jnp.where(small, jnp.ones_like(s2), s2))  # 2 sin θ
    theta = jnp.arctan2(
        jnp.where(small, jnp.zeros_like(s), s), trace - 1.0
    )
    # θ / (2 sin θ), Taylor-guarded at 0 (θ² ≈ s²/4 to leading order).
    factor = jnp.where(small, 0.5 + s2 / 48.0, theta / s)
    return factor * vee


@dataclasses.dataclass(frozen=True)
class SO3(Manifold):
    """Rotation stored as a 3x3 matrix with 3 intrinsic DoF; retraction is the
    right-multiplied exponential map R · exp([w]×).  The reference has no
    built-in rotation manifold (README.md:9 leaves it to users); this is the
    framework-native equivalent for real bundle-adjustment models."""

    @property
    def dof(self):
        return 3

    @property
    def shape(self):
        return (3, 3)

    def retract(self, x, delta):
        return x @ so3_exp(delta)


@dataclasses.dataclass(frozen=True)
class SE3(Manifold):
    """Rigid transform stored as a 3x4 matrix [R | t] with 6 DoF
    (rotation tangent first, translation second):
    [R|t] ⊞ (w, v) = [R·exp([w]×) | t + R·v]."""

    @property
    def dof(self):
        return 6

    @property
    def shape(self):
        return (3, 4)

    def retract(self, x, delta):
        r = x[:, :3]
        t = x[:, 3]
        r_new = r @ so3_exp(delta[:3])
        t_new = t + r @ delta[3:]
        return jnp.concatenate([r_new, t_new[:, None]], axis=1)


@dataclasses.dataclass(frozen=True)
class ContaminatedGaussianManifold(Manifold):
    """Parameter manifold of the adaptive two-component Gaussian-mixture
    robustifier (reference ``ContaminatedGaussian``,
    src/robustadaptive.jl:3-23).  Storage is ``[inv_sigma1, inv_sigma2, w]``;
    the two inverse sigmas live on ZeroToInf, the weight on ZeroToOne, and the
    retraction re-sorts so the first component stays the narrowest (largest
    inverse sigma) exactly as the reference constructor does
    (src/robustadaptive.jl:14) — note the reference does *not* swap the weight
    when it swaps the sigmas, and we replicate that."""

    @property
    def dof(self):
        return 3

    @property
    def shape(self):
        return (3,)

    def retract(self, x, delta):
        is1 = _positive_scale(x[0], delta[0])
        is2 = _positive_scale(x[1], delta[1])
        w = _zero_to_one_update(x[2], delta[2])
        hi = jnp.maximum(is1, is2)
        lo = jnp.minimum(is1, is2)
        return jnp.stack([hi, lo, w])


@dataclasses.dataclass(frozen=True)
class BarronManifold(Manifold):
    """Parameter manifold of the adaptive Barron general robust kernel:
    storage ``[alpha, c]`` with shape α ∈ (0, 2) (via the ZeroToOne update
    scaled by 2 — the range where the kernel's partition function is finite)
    and scale c ∈ (0, ∞)."""

    @property
    def dof(self):
        return 2

    @property
    def shape(self):
        return (2,)

    def retract(self, x, delta):
        t = _zero_to_one_update(x[0] * 0.5, delta[0])
        c = _positive_scale(x[1], delta[1])
        return jnp.stack([2.0 * t, c])


def batch_retract(manifold: Manifold, xs, deltas):
    """Retract a stacked family ``xs: [n, *shape]`` by ``deltas: [n, dof]``."""
    return jax.vmap(manifold.retract)(xs, deltas)
