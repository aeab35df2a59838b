"""Per-iteration step algorithms: Newton, Levenberg-Marquardt, dogleg and
gradient descent.

Reference parity: src/iterators.jl — each ``iterate!`` becomes a pure
function of (H, g, variables, best cost, iterator scalars) whose inner
accept/reject retry loops are ``lax.while_loop``s, so a whole optimization
compiles to one XLA computation with no host round-trips (SURVEY.md §7
"hard parts" (a)).

Conventions: ``a`` is the (undamped) Hessian H, ``b`` the gradient g = Jᵀr.
The solved Newton direction is negated before use, exactly as the reference's
``negate!(solve!(...))`` (src/iterators.jl:19), and ``x`` always denotes the
*applied* step.  Iterator scalar state is carried in a single dict
``{"lm_lambda", "tr", "gd_step"}`` regardless of the active iterator so the
optimizer loop state has one static pytree structure.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import jax
import jax.numpy as jnp

from . import structs
from .linearsolver import cholesky_solve


@dataclasses.dataclass(frozen=True)
class DenseOps:
    """Linear-system operations over a dense ``sys = (H, g)`` pair.  The
    same protocol is implemented by :class:`nllstpu.ops.schur.SchurOps` for
    the landmark-eliminated system, so every iterator works unchanged on
    either backend."""

    dim: int

    def solve(self, sys, lam):
        """x with (H + λI) x = g."""
        a, b = sys
        eye = jnp.eye(self.dim, dtype=a.dtype)
        return cholesky_solve(a + lam * eye, b)

    def grad(self, sys):
        return sys[1]

    def quad(self, sys, x):
        """xᵀHx (undamped) — the reference's ``fast_bAb``
        (src/utils.jl:71-106)."""
        return x @ (sys[0] @ x)

    def diag_max(self, sys):
        return jnp.max(jnp.abs(jnp.diagonal(sys[0])))


@dataclasses.dataclass(frozen=True)
class IterCtx:
    """Closures the iterators need: full-cost evaluation, linear-system ops
    and manifold step application."""

    cost: Callable  # vars -> scalar
    apply: Callable  # (vars, x) -> vars
    dtype: object
    dim: int
    linops: Any = None  # linear-system ops (defaults to DenseOps(dim))

    def ops(self):
        return self.linops if self.linops is not None else DenseOps(self.dim)


def init_data(dtype, opts=None):
    """Initial iterator scalars (reference ``reset!`` values:
    λ = 0 src/iterators.jl:129, trust radius = 0 line 40, step size = 1
    line 184; overridable via Options — the reference's ``iteratordata``)."""
    lam = getattr(opts, "init_lm_lambda", 0.0) if opts is not None else 0.0
    tr = getattr(opts, "init_trust_radius", 0.0) if opts is not None else 0.0
    gd = getattr(opts, "init_gd_step", 1.0) if opts is not None else 1.0
    return {
        "lm_lambda": jnp.asarray(lam, dtype=dtype),
        "tr": jnp.asarray(tr, dtype=dtype),
        "gd_step": jnp.asarray(gd, dtype=dtype),
    }


def iterate(name: str, ctx: IterCtx, sys, variables, bestcost, data, opts):
    """Dispatch one outer iteration.  ``sys`` is the assembled linear system
    (a pytree understood by ``ctx.ops()``).  Returns
    ``(new_vars, new_cost, applied_step, new_data, n_solves, n_cost_evals)``.
    """
    if name == structs.NEWTON:
        return _newton(ctx, sys, variables, bestcost, data, opts)
    if name == structs.LEVENBERG_MARQUARDT:
        return _levmar(ctx, sys, variables, bestcost, data, opts)
    if name == structs.DOGLEG:
        return _dogleg(ctx, sys, variables, bestcost, data, opts)
    if name == structs.GRADIENT_DESCENT:
        return _gradient_descent(ctx, sys, variables, bestcost, data, opts)
    raise ValueError(f"unknown iterator {name!r}")


def _newton(ctx, sys, variables, bestcost, data, opts):
    """Undamped Newton step (src/iterators.jl:16-27)."""
    ops = ctx.ops()
    x = -ops.solve(sys, jnp.zeros((), dtype=ctx.dtype))
    nv = ctx.apply(variables, x)
    c = ctx.cost(nv)
    one = jnp.int32(1)
    return nv, c, x, data, one, one


def _levmar(ctx, sys, variables, bestcost, data, opts):
    """Levenberg-Marquardt with the reference's damping schedule
    (src/iterators.jl:139-172): λ starts at 1e-6·max|diag H|, the inner loop
    multiplies λ by µ (doubling µ each failure), and on acceptance λ is scaled
    by ``ρ < 0.983 ? 1 − (2ρ−1)³ : 0.1`` where ρ is the step quality measured
    against the quadratic model of the *undamped* system."""
    dtype = ctx.dtype
    ops = ctx.ops()
    g = ops.grad(sys)
    lam = data["lm_lambda"]
    lam = jnp.where(lam == 0, ops.diag_max(sys) * dtype.type(1e-6), lam)

    def body(st):
        lam, mu, _, _, _, _, ns, nc = st
        x = -ops.solve(sys, lam)
        nv = ctx.apply(variables, x)
        c = ctx.cost(nv)
        # A non-finite trial cost is a FAILED trial (reject, escalate λ,
        # retry), not an improvement: the reference's ``while cost >
        # bestcost`` exits on NaN and dies with a NaN optimizer state
        # (src/iterators.jl:160) — as when an early LM step overflows the
        # Snavely distortion polynomial.
        # λ-escalation shrinks the step until it is valid; a cost that is
        # NaN even at zero step still terminates via the small-step exit +
        # the NaN termination bit.
        maxstep = jnp.max(jnp.abs(x))
        # A NaN step means the SYSTEM carries NaN (λ-damping cannot fix
        # H + λI when H is NaN) — exit and let the NaN termination bits
        # fire; an inf step (near-singular H at tiny λ) stays retryable.
        accept = (
            ((~(c > bestcost)) & jnp.isfinite(c))
            | (maxstep < opts.dstep)
            | jnp.isnan(maxstep)
        )
        return (
            jnp.where(accept, lam, lam * mu),
            jnp.where(accept, mu, mu * 2),
            x,
            nv,
            c,
            accept,
            ns + 1,
            nc + 1,
        )

    def cond(st):
        return ~st[5]

    init = (
        lam,
        jnp.asarray(2.0, dtype),
        jnp.zeros(ctx.dim, dtype=dtype),
        variables,
        jnp.asarray(bestcost, dtype),
        jnp.asarray(False),
        jnp.int32(0),
        jnp.int32(0),
    )
    lam_f, _, x, nv, c, _, ns, nc = jax.lax.while_loop(cond, body, init)

    # Step quality against the undamped quadratic model.  For the damped
    # solve x = −(H+λI)⁻¹g, the model decrease 0.5·xᵀHx + gᵀx collapses to
    # 0.5·(gᵀx − λ|x|²): xᵀ(H+λI)x = −gᵀx.  Identical to evaluating
    # ``ops.quad`` (up to solve accuracy) but streams nothing — the direct
    # Schur backend's quad re-reads the dense W coupling every iteration.
    quality = (c - bestcost) / (0.5 * (g @ x - lam_f * (x @ x)))
    lam_new = lam_f * jnp.where(
        quality < 0.983, 1 - (2 * quality - 1) ** 3, jnp.asarray(0.1, dtype)
    )
    data = dict(data, lm_lambda=lam_new)
    return nv, c, x, data, ns, nc


def _dogleg(ctx, sys, variables, bestcost, data, opts):
    """Dogleg trust region (src/iterators.jl:47-115): Cauchy leg, full Newton
    leg, or the trust-circle intersection of the Cauchy→Newton segment, with
    the reference's ×3 / ×0.5 radius updates at quality 0.375 / 0.125."""
    dtype = ctx.dtype
    ops = ctx.ops()
    b = ops.grad(sys)
    tiny = jnp.finfo(dtype).tiny
    tr = data["tr"]
    gnorm2 = b @ b
    # Newton leg + Cauchy curvature gᵀHg: backends that can fuse the two
    # (direct Schur shares the dense-W stream) expose solve0_quad_grad;
    # others pay a separate quad pass.
    if hasattr(ops, "solve0_quad_grad"):
        xsol, ghg = ops.solve0_quad_grad(sys)
    else:
        xsol = ops.solve(sys, jnp.zeros((), dtype=dtype))
        ghg = ops.quad(sys, b)
    coef = gnorm2 / (ghg + tiny)  # the reference's `a`
    cauchy = -coef * b
    alpha2 = coef * coef * gnorm2
    alpha = jnp.sqrt(alpha2)
    tr = jnp.where(tr == 0, alpha, tr)  # first step: Cauchy point
    xn = -xsol  # Newton leg
    beta = jnp.sqrt(xn @ xn)

    def body(st):
        tr, _, _, c_prev, _, nc = st
        first_leg = ~(alpha < tr)
        # Leg 1: truncated Cauchy step.
        x1 = (tr / alpha) * cauchy
        lin1 = tr * (2 * alpha - tr) / (2 * coef)
        # Leg 2a: full Newton step.
        use_full = beta <= tr
        # Leg 2b: intersection of Cauchy→Newton with the trust circle.
        d = xn - cauchy
        sq_leg = d @ d
        cdot = cauchy @ d
        trsq = tr * tr - alpha2
        root = jnp.sqrt(jnp.maximum(cdot * cdot + sq_leg * trsq, 0))
        stp = jnp.where(
            cdot <= 0, (-cdot + root) / (sq_leg + tiny), trsq / (cdot + root + tiny)
        )
        x3 = d * stp + cauchy
        lin3 = 0.5 * (coef * (1 - stp) ** 2 * gnorm2) + stp * (2 - stp) * c_prev
        x = jnp.where(first_leg, x1, jnp.where(use_full, xn, x3))
        lin = jnp.where(first_leg, lin1, jnp.where(use_full, c_prev, lin3))
        nv = ctx.apply(variables, x)
        c = ctx.cost(nv)
        # Trust-region update.
        mu = (bestcost - c) / lin
        xnorm = jnp.sqrt(x @ x)
        tr2 = jnp.where(
            mu > 0.375,
            jnp.maximum(tr, 3 * xnorm),
            jnp.where(mu < 0.125, tr * 0.5, tr),
        )
        # Non-finite trial: reject and force a radius shrink (NaN mu fails
        # every comparison above and would otherwise keep tr unchanged —
        # an infinite retry loop); see the LM note.
        finite = jnp.isfinite(c)
        tr2 = jnp.where(finite, tr2, tr * 0.5)
        maxstep = jnp.max(jnp.abs(x))
        done = (
            ((~(c > bestcost)) & finite)
            | (maxstep < opts.dstep)
            | jnp.isnan(maxstep)
        )
        return (tr2, x, nv, c, done, nc + 1)

    def cond(st):
        return ~st[4]

    init = (
        tr,
        jnp.zeros(ctx.dim, dtype=dtype),
        variables,
        jnp.asarray(bestcost, dtype),
        jnp.asarray(False),
        jnp.int32(0),
    )
    tr_f, x, nv, c, _, nc = jax.lax.while_loop(cond, body, init)
    data = dict(data, tr=tr_f)
    return nv, c, x, data, jnp.int32(1), nc


def _gradient_descent(ctx, sys, variables, bestcost, data, opts):
    """Gradient descent with the reference's quadratic-fit line search
    (src/iterators.jl:186-208)."""
    b = ctx.ops().grad(sys)
    ss = data["gd_step"]
    x = -b * ss
    nv = ctx.apply(variables, x)
    c = ctx.cost(nv)

    def body(st):
        ss, x, _, c, nc = st
        coststep = x @ b
        costdiff = bestcost + coststep - c
        ss2 = ss * 0.5 * coststep / costdiff
        x2 = -b * ss2
        nv2 = ctx.apply(variables, x2)
        c2 = ctx.cost(nv2)
        return (ss2, x2, nv2, c2, nc + 1)

    def cond(st):
        return st[3] > bestcost

    ss_f, x, nv, c, nc = jax.lax.while_loop(cond, body, (ss, x, nv, c, jnp.int32(1)))
    data = dict(data, gd_step=ss_f * 2)
    return nv, c, x, data, jnp.int32(0), nc


# ---------------------------------------------------------------------------
# Host-stepped iterators (per-phase timing for the stepped driver)
# ---------------------------------------------------------------------------


def make_stepped(name: str, ctx: IterCtx, opts):
    """Host-stepped variant of :func:`iterate` for the stepped driver: the
    accept/reject retry loop runs in Python with separately jitted solve and
    apply+cost kernels, so wall time is attributable to the reference's
    ``timesolver``/``timecost`` phases (src/structs.jl:44-46; the reference
    times exactly these two blocks inside ``iterate!``,
    src/iterators.jl:19,24,149-157).  The jitted driver keeps the fused
    :func:`iterate` while-loop machines instead — one XLA program, but no
    per-phase attribution.

    Returns a callable ``(sys, variables, bestcost, itdata) ->
    (new_vars, cost, step, itdata, n_solves, n_cost_evals, t_solve, t_cost)``.
    The host needs the step and the trial cost anyway, so each phase ends
    in their device-to-host copy, which also bounds its timer.  Small
    host-side vector math (leg selection, step quality)
    runs in numpy; its cost is negligible next to a solve and keeps the
    dispatch count per trial at two.
    """
    ops = ctx.ops()
    dtype = ctx.dtype

    solve_j = jax.jit(lambda sys, lam: -ops.solve(sys, lam))
    grad_j = jax.jit(ops.grad)
    diag_max_j = jax.jit(ops.diag_max)

    def _apply_cost(variables, x):
        nv = ctx.apply(variables, jnp.asarray(x, dtype=dtype))
        return nv, ctx.cost(nv)

    apply_cost_j = jax.jit(_apply_cost)

    if name == structs.NEWTON:

        def newton(sys, variables, bestcost, itdata):
            t0 = time.perf_counter()
            x = np.asarray(solve_j(sys, jnp.zeros((), dtype=dtype)))
            t_solve = time.perf_counter() - t0
            t0 = time.perf_counter()
            nv, c = apply_cost_j(variables, x)
            c = float(c)
            t_cost = time.perf_counter() - t0
            return nv, c, x, itdata, 1, 1, t_solve, t_cost

        return newton

    if name == structs.LEVENBERG_MARQUARDT:

        def levmar(sys, variables, bestcost, itdata):
            t_solve = t_cost = 0.0
            bestf = float(bestcost)
            t0 = time.perf_counter()
            g = np.asarray(grad_j(sys))
            lam = float(itdata["lm_lambda"])
            if lam == 0.0:
                lam = float(diag_max_j(sys)) * 1e-6
            t_solve += time.perf_counter() - t0
            mu = 2.0
            ns = nc = 0
            while True:
                t0 = time.perf_counter()
                x = np.asarray(solve_j(sys, jnp.asarray(lam, dtype=dtype)))
                t_solve += time.perf_counter() - t0
                ns += 1
                t0 = time.perf_counter()
                nv, c = apply_cost_j(variables, x)
                c = float(c)
                t_cost += time.perf_counter() - t0
                nc += 1
                maxstep = float(np.max(np.abs(x)))
                if (
                    ((not (c > bestf)) and np.isfinite(c))
                    or maxstep < opts.dstep
                    or np.isnan(maxstep)
                ):
                    break
                lam *= mu
                mu *= 2.0
            # Step quality via the damped-solve identity (see _levmar).
            quality = (c - bestf) / (
                0.5 * (float(g @ x) - lam * float(x @ x))
            )
            lam_new = lam * (
                (1 - (2 * quality - 1) ** 3) if quality < 0.983 else 0.1
            )
            itdata = dict(itdata, lm_lambda=jnp.asarray(lam_new, dtype=dtype))
            return nv, c, x, itdata, ns, nc, t_solve, t_cost

        return levmar

    if name == structs.DOGLEG:
        # Jit the Newton-leg kernels ONCE: a bound method is a fresh object
        # per attribute access, so jitting inside the loop would retrace
        # every iteration.
        if hasattr(ops, "solve0_quad_grad"):
            newton_leg_j = jax.jit(ops.solve0_quad_grad)
        else:
            quad_j = jax.jit(ops.quad)
            newton_leg_j = None

        def dogleg(sys, variables, bestcost, itdata):
            t_cost = 0.0
            bestf = float(bestcost)
            tiny = float(jnp.finfo(dtype).tiny)
            t0 = time.perf_counter()
            b = np.asarray(grad_j(sys))
            if newton_leg_j is not None:
                xsol, ghg = newton_leg_j(sys)
                xn = -np.asarray(xsol)
                ghg = float(ghg)
            else:
                xn = np.asarray(solve_j(sys, jnp.zeros((), dtype=dtype)))
                ghg = float(quad_j(sys, jnp.asarray(b)))
            t_solve = time.perf_counter() - t0
            gnorm2 = float(b @ b)
            coef = gnorm2 / (ghg + tiny)
            cauchy = -coef * b
            alpha2 = coef * coef * gnorm2
            alpha = float(np.sqrt(alpha2))
            tr = float(itdata["tr"])
            if tr == 0.0:
                tr = alpha  # first step: Cauchy point
            beta = float(np.sqrt(xn @ xn))
            c_prev = bestf
            nc = 0
            while True:
                if not (alpha < tr):
                    x = (tr / alpha) * cauchy
                    lin = tr * (2 * alpha - tr) / (2 * coef)
                elif beta <= tr:
                    x = xn
                    lin = c_prev
                else:
                    d = xn - cauchy
                    sq_leg = float(d @ d)
                    cdot = float(cauchy @ d)
                    trsq = tr * tr - alpha2
                    root = float(
                        np.sqrt(max(cdot * cdot + sq_leg * trsq, 0.0))
                    )
                    stp = (
                        (-cdot + root) / (sq_leg + tiny)
                        if cdot <= 0
                        else trsq / (cdot + root + tiny)
                    )
                    x = d * stp + cauchy
                    lin = 0.5 * (
                        coef * (1 - stp) ** 2 * gnorm2
                    ) + stp * (2 - stp) * c_prev
                t0 = time.perf_counter()
                nv, c = apply_cost_j(variables, x)
                c = float(c)
                t_cost += time.perf_counter() - t0
                nc += 1
                mu = (bestf - c) / lin if lin else 0.0
                xnorm = float(np.sqrt(x @ x))
                if mu > 0.375:
                    tr = max(tr, 3 * xnorm)
                elif mu < 0.125 or not np.isfinite(c):
                    tr = tr * 0.5
                maxstep = float(np.max(np.abs(x)))
                if (
                    ((not (c > bestf)) and np.isfinite(c))
                    or maxstep < opts.dstep
                    or np.isnan(maxstep)
                ):
                    break
                c_prev = c
            itdata = dict(itdata, tr=jnp.asarray(tr, dtype=dtype))
            return nv, c, x, itdata, 1, nc, t_solve, t_cost

        return dogleg

    if name == structs.GRADIENT_DESCENT:

        def gradient_descent(sys, variables, bestcost, itdata):
            bestf = float(bestcost)
            t0 = time.perf_counter()
            b = np.asarray(grad_j(sys))
            t_solve = time.perf_counter() - t0
            ss = float(itdata["gd_step"])
            x = -b * ss
            t0 = time.perf_counter()
            nv, c = apply_cost_j(variables, x)
            c = float(c)
            t_cost = time.perf_counter() - t0
            nc = 1
            while c > bestf:
                coststep = float(x @ b)
                costdiff = bestf + coststep - c
                ss = ss * 0.5 * coststep / costdiff
                x = -b * ss
                t0 = time.perf_counter()
                nv, c = apply_cost_j(variables, x)
                c = float(c)
                t_cost += time.perf_counter() - t0
                nc += 1
            itdata = dict(itdata, gd_step=jnp.asarray(ss * 2, dtype=dtype))
            return nv, c, x, itdata, 0, nc, t_solve, t_cost

        return gradient_descent

    raise ValueError(f"unknown iterator {name!r}")
