"""Robust kernels ρ(s) applied to squared residual norms, plus derivatives.

Reference parity: src/robust.jl (NoRobust, Scaled, Huber/Huber2o,
Geman-McClure) and src/robustadaptive.jl (ContaminatedGaussian adaptive
kernel).  Each kernel provides ``rho(s)`` (the reference's ``robustify``) and
``rho_dc(s) -> (ρ, ρ′, ρ″)`` (``robustifydcost``); analytic derivatives follow
the reference's closed forms, and the generic fallback differentiates ``rho``
with ``jax.grad`` — the JAX analogue of the ForwardDiff fallback
(src/robust.jl:14, src/autodiff.jl:163).

Adaptive kernels additionally expose their parameter manifold and
``rho_dkernel`` — the value/gradient/Hessian of ρ with respect to
``[kernel tangent..., s]`` evaluated at the zero tangent, matching
``autorobustifydkernel`` (src/autodiff.jl:164-165: the Hessian of
``robustify(update(kernel, x), s + x[end])`` at x = 0).

All functions are pure and scalar-in/scalar-out so they can be vmapped over
residual batches and fused by XLA into the surrounding cost computation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .manifolds import ContaminatedGaussianManifold


def auto_rho_dc(rho_fn, s):
    """(ρ, ρ′, ρ″) of a scalar kernel via forward-mode autodiff."""
    d1_fn = jax.grad(rho_fn)
    rho = rho_fn(s)
    d1 = d1_fn(s)
    d2 = jax.grad(d1_fn)(s)
    return rho, d1, d2


@dataclasses.dataclass(frozen=True)
class Robustifier:
    """Fixed (non-adaptive) robust kernel.  Fields are Python floats treated
    as trace-time constants, so a kernel instance doubles as part of the
    cost-batch grouping key."""

    def rho(self, s):
        raise NotImplementedError

    def rho_dc(self, s):
        return auto_rho_dc(self.rho, s)


@dataclasses.dataclass(frozen=True)
class NoRobust(Robustifier):
    """Identity kernel (src/robust.jl:7-12)."""

    def rho(self, s):
        return s

    def rho_dc(self, s):
        one = jnp.ones_like(s)
        return s, one, jnp.zeros_like(s)


@dataclasses.dataclass(frozen=True)
class Scaled(Robustifier):
    """Constant multiple of an inner kernel (src/robust.jl:22-31).  The
    reference's ``Scaled{T,R}`` wraps *any* robustifier including adaptive
    ones; constructing ``Scaled(adaptive_kernel, h)`` here returns a
    :class:`ScaledAdaptive` so the result keeps behaving as an adaptive
    kernel (parameters stay a jointly-optimized variable)."""

    robust: Robustifier
    height: float

    def __new__(cls, robust=None, height=None):
        if cls is Scaled and isinstance(robust, AdaptiveRobustifier):
            return ScaledAdaptive(robust, height)
        return super().__new__(cls)

    def rho(self, s):
        return self.robust.rho(s) * self.height

    def rho_dc(self, s):
        c, d1, d2 = self.robust.rho_dc(s)
        return c * self.height, d1 * self.height, d2 * self.height


@dataclasses.dataclass(frozen=True)
class Huber(Robustifier):
    """Huber kernel: quadratic below ``width``², linear above
    (src/robust.jl:40-55).  ``second_order=True`` gives the reference's
    ``Huber2oKernel`` which also reports the (negative) second derivative in
    the linear regime; plain ``HuberKernel`` reports ρ″ = 0 there."""

    width: float
    second_order: bool = False

    def rho(self, s):
        wsq = self.width * self.width
        # sqrt argument guarded so the unused branch never produces a NaN
        # that would poison jnp.where gradients.
        safe = jnp.sqrt(jnp.maximum(s, wsq))
        return jnp.where(s < wsq, s, safe * (2 * self.width) - wsq)

    def rho_dc(self, s):
        wsq = self.width * self.width
        sqrt_s = jnp.sqrt(jnp.maximum(s, wsq))
        in_quad = s < wsq
        rho = jnp.where(in_quad, s, sqrt_s * (2 * self.width) - wsq)
        d1 = jnp.where(in_quad, jnp.ones_like(s), self.width / sqrt_s)
        if self.second_order:
            d2 = jnp.where(
                in_quad,
                jnp.zeros_like(s),
                (-0.5 * self.width) / (jnp.maximum(s, wsq) * sqrt_s),
            )
        else:
            d2 = jnp.zeros_like(s)
        return rho, d1, d2


def Huber2o(width: float) -> Huber:
    """Reference ``Huber2oKernel`` (src/robust.jl:46)."""
    return Huber(width, second_order=True)


@dataclasses.dataclass(frozen=True)
class GemanMcclure(Robustifier):
    """Geman-McClure kernel (src/robust.jl:63-77)."""

    width: float

    def rho(self, s):
        wsq = self.width * self.width
        return s * wsq / (s + wsq)

    def rho_dc(self, s):
        wsq = self.width * self.width
        r = 1.0 / (s + wsq)
        w = wsq * r
        w2 = w * w
        return s * w, w2, -2 * w2 * r


@dataclasses.dataclass(frozen=True)
class Cauchy(Robustifier):
    """Cauchy/Lorentzian kernel: ρ(s) = c²·log(1 + s/c²).  Not in the
    reference's built-ins but standard in Ceres-class solvers."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        return csq * jnp.log1p(s / csq)

    def rho_dc(self, s):
        csq = self.width * self.width
        inv = 1.0 / (1.0 + s / csq)
        return csq * jnp.log1p(s / csq), inv, -(inv * inv) / csq


@dataclasses.dataclass(frozen=True)
class Welsch(Robustifier):
    """Welsch kernel: ρ(s) = c²·(1 − exp(−s/c²))."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        return csq * (1.0 - jnp.exp(-s / csq))

    def rho_dc(self, s):
        csq = self.width * self.width
        e = jnp.exp(-s / csq)
        return csq * (1.0 - e), e, -e / csq


@dataclasses.dataclass(frozen=True)
class Tukey(Robustifier):
    """Tukey biweight kernel: fully redescending (zero influence beyond
    ``width``)."""

    width: float

    def rho(self, s):
        csq = self.width * self.width
        u = jnp.minimum(s / csq, 1.0)
        return (csq / 3.0) * (1.0 - (1.0 - u) ** 3)


# ---------------------------------------------------------------------------
# Adaptive kernels: the kernel parameters are themselves an optimized variable
# (reference AbstractAdaptiveRobustifier, src/NLLSsolver.jl:25).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AdaptiveRobustifier:
    """Adaptive kernel: ``rho`` takes the stored kernel parameters as the
    first argument; ``manifold`` describes their tangent space."""

    @property
    def manifold(self):
        raise NotImplementedError

    def rho(self, kparams, s):
        raise NotImplementedError

    def rho_dc(self, kparams, s):
        rho_s = lambda s_: self.rho(kparams, s_)
        return auto_rho_dc(rho_s, s)

    def rho_dkernel(self, kparams, s):
        """Value, gradient and Hessian of ρ w.r.t. ``[kernel tangent, s]``
        (length dof+1) at the zero tangent — ``autorobustifydkernel``
        semantics (src/autodiff.jl:164-165)."""
        man = self.manifold
        k = man.dof

        def f(z):
            return self.rho(man.retract(kparams, z[:k]), s + z[k])

        z0 = jnp.zeros(k + 1, dtype=jnp.result_type(s, float))
        val = f(z0)
        grad = jax.grad(f)(z0)
        hess = jax.jacfwd(jax.grad(f))(z0)
        return val, grad, hess

    def rho_dkernel_cm(self, kparams_cm, s):
        """Components-major batched :meth:`rho_dkernel`:
        ``kparams_cm [ambient, B]``, ``s [B]`` → ``(ρ [B],
        dgrad [dof+1, B], dhess [dof+1, dof+1, B])``.  Every cost's
        derivative rides one shared basis tangent broadcast over the lane
        axis (forward-over-forward; (dof+1)² elementwise passes), so the
        whole batch stays in the lane-optimal cm layout — the engine's
        fast paths for ``batched='cm'`` adaptive costs are built on this.
        Works for any subclass whose ``rho`` is elementwise in ``s`` (all
        built-ins are)."""
        man = self.manifold
        k = man.dof
        b = s.shape[-1]

        def f(z):
            t = jnp.broadcast_to(z[:k, None], (k, b))
            return self.rho(man.retract_cm(kparams_cm, t), s + z[k])

        z0 = jnp.zeros(k + 1, dtype=s.dtype)
        val = f(z0)
        dgrad = jax.jacfwd(f)(z0)  # [B, k+1]
        dhess = jax.jacfwd(jax.jacfwd(f))(z0)  # [B, k+1, k+1]
        return val, dgrad.T, jnp.moveaxis(dhess, 0, -1)


@dataclasses.dataclass(frozen=True)
class ScaledAdaptive(AdaptiveRobustifier):
    """Constant multiple of an adaptive kernel — what ``Scaled(adaptive, h)``
    constructs (reference ``Scaled{T,R}`` over an
    ``AbstractAdaptiveRobustifier``, src/robust.jl:22-31).  ρ and all its
    derivatives (w.r.t. both s and the kernel tangent) scale linearly by
    ``height``."""

    robust: AdaptiveRobustifier
    height: float

    @property
    def manifold(self):
        return self.robust.manifold

    def rho(self, kparams, s):
        return self.robust.rho(kparams, s) * self.height

    def rho_dc(self, kparams, s):
        c, d1, d2 = self.robust.rho_dc(kparams, s)
        return c * self.height, d1 * self.height, d2 * self.height

    def rho_dkernel(self, kparams, s):
        v, g, h = self.robust.rho_dkernel(kparams, s)
        return v * self.height, g * self.height, h * self.height


@dataclasses.dataclass(frozen=True)
class ContaminatedGaussian(AdaptiveRobustifier):
    """Two-component Gaussian-mixture adaptive kernel
    (src/robustadaptive.jl:3-33).  Stored parameters are
    ``[inv_sigma1, inv_sigma2, w]`` with inv_sigma1 >= inv_sigma2 (first
    component narrowest)."""

    @property
    def manifold(self):
        return ContaminatedGaussianManifold()

    @staticmethod
    def make_params(sigma1: float, sigma2: float, w: float, dtype=None):
        """Build the stored parameter vector from sigmas + weight, applying
        the constructor's narrowest-first ordering
        (src/robustadaptive.jl:12-20)."""
        is1, is2 = 1.0 / sigma1, 1.0 / sigma2
        if is1 < is2:
            is1, is2 = is2, is1
        return jnp.array([is1, is2, w], dtype=dtype)

    @staticmethod
    def sigmas_weight(kparams):
        """Recover ``(sigma1, sigma2, w)`` — reference ``params``
        (src/robustadaptive.jl:23)."""
        return jnp.stack([1.0 / kparams[0], 1.0 / kparams[1], kparams[2]])

    def rho(self, kparams, s):
        is1, is2, w = kparams[0], kparams[1], kparams[2]
        s1sq = is1 * is1
        s2sq = is2 * is2
        half_d = 0.5 * (s2sq - s1sq)  # <= 0 given the ordering invariant
        half_s2sq = 0.5 * s2sq
        return s * half_s2sq - jnp.log(
            w * is1 * jnp.exp(s * half_d) + (1 - w) * is2
        )

    def rho_dc(self, kparams, s):
        """Analytic (ρ, ρ′, ρ″) w.r.t. s (src/robustadaptive.jl:26-33)."""
        is1, is2, w = kparams[0], kparams[1], kparams[2]
        s1sq = is1 * is1
        s2sq = is2 * is2
        half_d = 0.5 * (s2sq - s1sq)
        half_s2sq = 0.5 * s2sq
        c = s * half_s2sq
        e = w * is1 * jnp.exp(s * half_d)
        t = (1 - w) * is2
        den = 1.0 / (e + t)
        e2 = e * half_d
        return (
            c + jnp.log(den),
            half_s2sq - e2 * den,
            -e2 * half_d * t * den * den,
        )


def _barron_core(x2, alpha, eps=1e-5):
    """Barron's practical smooth form of the general robust loss
    ρ(x, α) with x² given (scale already applied); continuous in α with
    epsilon-guarded limits at α → 0 and α → 2 (Barron, "A General and
    Adaptive Robust Loss Function", CVPR 2019 — public method, reimplemented
    here in JAX)."""
    b = jnp.abs(2.0 - alpha) + eps
    d = jnp.where(alpha >= 0, alpha + eps, alpha - eps)
    return (b / d) * (jnp.power(x2 / b + 1.0, 0.5 * d) - 1.0)


def _barron_log_partition_table(n_alpha=129, x_max=60.0, n_x=16001):
    """log Z(α) = log ∫ exp(−ρ(x², α)) dx over α ∈ [0, 2], tabulated once at
    import with vectorized numpy trapezoid integration at n_x=16001 nodes
    (accuracy depends on the node count — use a higher-order rule if n_x is
    ever reduced; Barron uses a spline of the same quantity)."""
    import numpy as np

    alphas = np.linspace(0.0, 2.0, n_alpha)
    xs = np.linspace(-x_max, x_max, n_x)
    x2 = xs * xs
    eps = 1e-5
    b = np.abs(2.0 - alphas)[:, None] + eps
    d = np.where(alphas >= 0, alphas + eps, alphas - eps)[:, None]
    rho = (b / d) * (np.power(x2[None, :] / b + 1.0, 0.5 * d) - 1.0)
    dens = np.exp(-rho)
    z = np.trapezoid(dens, xs, axis=1)
    return alphas, np.log(z)


_BARRON_ALPHAS, _BARRON_LOGZ = _barron_log_partition_table()


@dataclasses.dataclass(frozen=True)
class Barron(AdaptiveRobustifier):
    """Adaptive Barron general robust kernel with parameters
    ``[alpha, c]`` optimized as a variable.  ``rho`` is scaled so that
    ½·ρ equals the negative log-likelihood of Barron's probability model
    (data term + log c·Z(α) partition), which is what makes joint
    optimization of (α, c) well-posed — without the partition term the
    optimizer would drive c → ∞.

    The reference ships only the ContaminatedGaussian adaptive kernel; this
    is the Barron-style adaptive robustifier named in the project north star
    (BASELINE.json)."""

    @property
    def manifold(self):
        from .manifolds import BarronManifold

        return BarronManifold()

    @staticmethod
    def make_params(alpha: float = 1.0, c: float = 1.0, dtype=None):
        if not (0.0 < alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        return jnp.array([alpha, c], dtype=dtype)

    def rho(self, kparams, s):
        alpha, c = kparams[0], kparams[1]
        x2 = s / (c * c)
        logz = jnp.interp(alpha, jnp.asarray(_BARRON_ALPHAS), jnp.asarray(_BARRON_LOGZ))
        return 2.0 * _barron_core(x2, alpha) + 2.0 * (jnp.log(c) + logz)


def em_fit(kparams, squared_errors, max_iters: int = 10, rtol: float = 1e-6):
    """Expectation-Maximization fit of ContaminatedGaussian parameters to a
    batch of squared errors — reference ``optimize(kernel, squarederrors)``
    (src/robustadaptive.jl:48-73).  Fully jittable: the E-step is vectorized
    over the error batch and the outer alternation is a ``lax.while_loop``
    with the reference's rtol-1e-6 convergence test.

    Returns the new stored parameter vector ``[inv_s1, inv_s2, w]``.
    """
    squared_errors = jnp.asarray(squared_errors)
    n = squared_errors.shape[0]
    total = jnp.sum(squared_errors)
    init_sw = ContaminatedGaussian.sigmas_weight(kparams)

    def one_round(sw):
        sigma1, sigma2, w = sw[0], sw[1], sw[2]
        is1, is2 = 1.0 / sigma1, 1.0 / sigma2
        s1sq, s2sq = is1 * is1, is2 * is2
        wratio = ((1 - w) * is2) / (is1 * w)
        half_diff = 0.5 * (s1sq - s2sq)  # >= 0
        # E-step: responsibility of the narrow component per error.
        resp = 1.0 / (1.0 + wratio * jnp.exp(half_diff * squared_errors))
        weighted = jnp.sum(resp * squared_errors)
        total_weight = jnp.sum(resp)
        # M-step.
        new_sigma1 = jnp.sqrt(weighted / total_weight)
        new_sigma2 = jnp.sqrt((total - weighted) / (n - total_weight))
        new_w = total_weight / n
        return jnp.stack([new_sigma1, new_sigma2, new_w])

    def cond(state):
        it, sw, converged = state
        return (it < max_iters) & ~converged

    def body(state):
        it, sw, _ = state
        new_sw = one_round(sw)
        converged = jnp.all(
            jnp.abs(new_sw - sw) <= rtol * jnp.maximum(jnp.abs(new_sw), jnp.abs(sw))
        )
        return it + 1, new_sw, converged

    _, sw, _ = jax.lax.while_loop(cond, body, (0, init_sw, jnp.array(False)))
    # Rebuild stored params with the narrowest-first ordering.
    is1, is2 = 1.0 / sw[0], 1.0 / sw[1]
    hi = jnp.maximum(is1, is2)
    lo = jnp.minimum(is1, is2)
    return jnp.stack([hi, lo, sw[2]])
