"""Options, result and termination-flag definitions.

Reference parity: src/structs.jl (``NLLSOptions``, ``NLLSResult``, the
termination bitmask decoded by the pretty-printer) and the termination logic
in src/optimize.jl:149-165.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

NEWTON = "newton"
LEVENBERG_MARQUARDT = "levenberg_marquardt"
DOGLEG = "dogleg"
GRADIENT_DESCENT = "gradient_descent"

ITERATORS = (NEWTON, LEVENBERG_MARQUARDT, DOGLEG, GRADIENT_DESCENT)

# Termination bits (src/optimize.jl:151-161).
TERM_COST_INF = 1 << 0
TERM_COST_NAN = 1 << 1
TERM_RELDCOST = 1 << 2
TERM_ABSDCOST = 1 << 3
TERM_STEP_INF = 1 << 4
TERM_STEP_NAN = 1 << 5
TERM_SMALL_STEP = 1 << 6
TERM_MAX_FAILS = 1 << 7
TERM_MAX_ITERS = 1 << 8
TERM_MAX_TIME = 1 << 9
TERM_USER_SHIFT = 16

_TERM_MESSAGES = (
    (TERM_COST_INF, "Cost is infinite."),
    (TERM_COST_NAN, "Cost is NaN."),
    (TERM_RELDCOST, "Relative decrease in cost below threshold."),
    (TERM_ABSDCOST, "Absolute decrease in cost below threshold."),
    (TERM_STEP_INF, "Step contains an infinite value."),
    (TERM_STEP_NAN, "Step contains a NaN."),
    (TERM_SMALL_STEP, "Step size below threshold."),
    (TERM_MAX_FAILS, "Too many consecutive iterations increasing the cost."),
    (TERM_MAX_ITERS, "Maximum number of outer iterations reached."),
    (TERM_MAX_TIME, "Maximum allowed computation time exceeded."),
)


@dataclasses.dataclass(frozen=True)
class Options:
    """Solver options (reference ``NLLSOptions``, src/structs.jl:22-35).

    ``solver`` selects the linear-system backend: ``"dense"`` (full dense
    normal equations), ``"schur"`` (landmark-eliminated reduced system; needs
    ``schur_family``), ``"auto"`` (the reference's dense/sparse heuristic,
    plus bipartite-family detection that auto-selects Schur for BA-shaped
    problems), ``"schur_cg"``, or ``"cg"``.

    ``max_time`` is ALWAYS enforced (reference src/optimize.jl:160-163):
    the stepped driver checks the clock every iteration; the fully-jitted
    driver runs host-resumable chunks and checks between chunks (a run
    that converges inside its first chunk pays nothing).
    ``jit_max_time=True`` upgrades the jitted driver to per-iteration
    precision via an ordered ``io_callback`` host-clock read (one host
    callback per iteration).

    ``store_trajectory``: ``True`` records the full reference-fidelity
    :class:`CostTrajectory` (per-iteration costs, wall times and step
    vectors) on the stepped driver; ``"jit"`` records costs + step norms
    (+ times when combined with ``jit_max_time``) from INSIDE the
    fully-jitted loop at full speed; ``"jit_full"`` additionally records
    the FULL per-iteration step vectors through a [max_iters, dim]
    in-loop buffer (reference ``CostTrajectory.trajectory``,
    src/callbacks.jl:85-107) — opt-in because the buffer scales with
    max_iters × total dof.
    """

    rel_dcost: float = 1e-15
    abs_dcost: float = 1e-15
    dstep: float = 1e-15
    max_fails: int = 3
    max_iters: int = 100
    max_time: float = 30.0
    jit_max_time: bool = False
    # Per-iteration printout from INSIDE the fully-jitted loop (reference
    # ``printoutcallback`` runs inside the main optimizer,
    # src/callbacks.jl:39-60) via an ordered io_callback — no stepped-driver
    # fallback needed just to watch iterations.  One small host transfer per
    # outer iteration; off by default.  Ignored by the vmapped
    # per-variable alternation solves.
    jit_printout: bool = False
    iterator: str = LEVENBERG_MARQUARDT
    solver: str = "auto"
    schur_family: Any = None  # Manifold of the eliminated (landmark) family
    store_trajectory: bool = False
    # Initial iterator scalars (reference ``iteratordata`` override,
    # src/structs.jl:31): 0 = auto for λ and trust radius.
    init_lm_lambda: float = 0.0
    init_trust_radius: float = 0.0
    init_gd_step: float = 1.0
    # Implicit (schur_cg) only: run the reduced PCG for exactly this many
    # iterations as a ``fori_loop`` with frozen-on-convergence updates
    # instead of a data-dependent ``while_loop``.  Removes one level of
    # nested dynamic control flow at the price of always burning the whole
    # budget; also settable via NLLSTPU_CG_FIXED_ITERS.
    cg_fixed_iters: Any = None
    # Implicit (schur_cg) only: chunked CG — a while_loop over fori blocks
    # of this many iterations.  Converged solves stop at chunk granularity
    # (unlike cg_fixed_iters, which burns its whole budget every solve)
    # while the INNERMOST loop stays a fori_loop.  Also via
    # NLLSTPU_CG_CHUNK_ITERS.
    cg_chunk_iters: Any = None
    # Iterative backends (cg / schur_cg) only: relative residual tolerance
    # of the inner linear solve (the Ceres ``eta`` analogue).  None = the
    # backend's dtype default (exact-ish).  LM tolerates inexact steps, so
    # a loose tolerance (e.g. 1e-2) trades inner iterations for outer ones
    # — usually a large net win at scale.
    linear_tol: Any = None
    # Fully-jitted LM only: run the damping retry merged into the single
    # outer while_loop (one level of dynamic control flow) instead of a
    # nested inner while_loop.  Identical results and counts; one less
    # nesting level of dynamic control flow in the compiled program.  None
    # = on; False forces the nested machine.
    flat_lm: Any = None
    # Fully-jitted flat LM only: evaluate each damping trial with a FULL
    # assemble instead of a cost-only pass, so an accepted trial's system
    # is already built and the per-iteration re-assemble disappears.  The
    # per-trip arithmetic favors it whenever assemble < cost/accept_rate,
    # but f32 reduction-order noise in the trial cost perturbs the λ
    # adaptation into more rejected trips (untimed on the GPU).  Off by
    # default (None = off, or the NLLSTPU_FUSED_TRIAL env override);
    # opt-in for problems with a smaller assemble/cost ratio.
    # ``gradient_computations`` then counts one assemble per trial.
    fused_trial: Any = None
    # Implicit (schur_cg) only: cluster-Jacobi preconditioning (Ceres
    # CLUSTER_JACOBI analogue) with this many consecutive cameras per
    # cluster — the exact diagonal CLUSTER blocks of S, capturing
    # intra-cluster camera coupling.  0 = per-camera Schur-Jacobi.
    schur_cluster_size: int = 0

    def __post_init__(self):
        if self.iterator not in ITERATORS:
            raise ValueError(f"unknown iterator {self.iterator!r}; one of {ITERATORS}")


@dataclasses.dataclass
class Result:
    """Optimization result (reference ``NLLSResult``, src/structs.jl:37-50).

    Timing semantics: in the fully-jitted driver the whole optimization is
    one XLA computation, so only ``time_total`` and ``time_init`` are
    measurable — ``time_cost``/``time_gradient``/``time_solver`` are **NaN**
    there ("not measured", never zero masquerading as a measurement).  The
    stepped driver (any callback, or ``store_trajectory``) measures all
    three for real: ``time_gradient`` covers assembly, ``time_solver`` the
    linear solves, ``time_cost`` the cost evaluations (reference
    ``timecost``/``timegradient``/``timesolver``, src/structs.jl:44-46).
    """

    start_cost: float
    best_cost: float
    time_total: float
    time_init: float
    time_cost: float
    time_gradient: float
    time_solver: float
    termination: int
    num_iterations: int
    cost_computations: int
    gradient_computations: int
    linear_solves: int
    trajectory: Optional[Any] = None  # CostTrajectory when requested

    def termination_reasons(self) -> list:
        reasons = [msg for bit, msg in _TERM_MESSAGES if self.termination & bit]
        user = self.termination >> TERM_USER_SHIFT
        if user:
            reasons.append(
                f"Terminated by user-defined callback, with flags: {user:b}"
            )
        return reasons

    def __str__(self):
        def t(v):
            # NaN = "not measured" (fully-jitted driver), see class docstring.
            return f"{v:f} seconds" if v == v else "unmeasured time (jitted)"

        lines = [
            f"nllstpu optimization took {self.time_total:f} seconds and "
            f"{self.num_iterations} iterations to reduce the cost from "
            f"{self.start_cost:e} to {self.best_cost:e} "
            f"(a {100.0 * (1.0 - self.best_cost / self.start_cost) if self.start_cost else 0.0:.2f}% reduction), using:",
            f"   {self.cost_computations} cost computations in {t(self.time_cost)},",
            f"   {self.gradient_computations} gradient computations in {t(self.time_gradient)},",
            f"   {self.linear_solves} linear solver computations in {t(self.time_solver)},",
            f"   {self.time_init:f} seconds for initialization.",
        ]
        reasons = self.termination_reasons()
        if reasons:
            lines.append("Reason(s) for termination:")
            lines.extend(f"   {r}" for r in reasons)
        return "\n".join(lines)


@dataclasses.dataclass
class CostTrajectory:
    """Per-iteration cost/time/step record (reference ``CostTrajectory``,
    src/callbacks.jl:85-107).

    The stepped driver fills ``costs``/``times_ns``/``trajectory`` (full
    step vectors) exactly like the reference.  The jitted driver
    (``store_trajectory="jit"``) records ``costs`` and ``step_norms`` from
    inside the compiled loop; ``times_ns`` additionally requires the
    per-iteration host clock (``jit_max_time=True``); ``trajectory``
    stays empty under ``"jit"`` and is filled with the full per-iteration
    step vectors under ``"jit_full"`` (an in-loop [max_iters, dim] ring —
    matches the stepped driver's vectors bit-for-bit, tested)."""

    costs: list = dataclasses.field(default_factory=list)
    times_ns: list = dataclasses.field(default_factory=list)
    trajectory: list = dataclasses.field(default_factory=list)
    step_norms: list = dataclasses.field(default_factory=list)
