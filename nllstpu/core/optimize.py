"""Optimizer entry points: ``optimize`` and the compiled solver drivers.

Reference parity: src/optimize.jl.  Two drivers are provided:

* **jit driver** — the entire outer optimization (assembly → iterate →
  best-cost tracking → termination mask) is a single ``lax.while_loop``
  compiled by XLA; zero host round-trips per iteration.  This is the
  production path.
* **stepped driver** — one jitted computation per outer iteration with a
  Python shell, used when a user callback is supplied (callbacks may mutate
  the trial variables, as the reference's EM-alternation callback does,
  test/adaptivecost.jl:15-25) and for real wall-clock ``max_time``
  enforcement and per-phase timing.

Both drivers implement the reference's control flow exactly: unconditional
adoption of the trial variables (src/optimize.jl:147), best-variable snapshot
on the first consecutive failure with ``max_fails`` rollback
(src/optimize.jl:130-145, 173-176), and the 10-bit + user termination mask
(src/optimize.jl:149-165).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from . import engine, iterators, structs
from .problem import Problem, family_name
from .structs import CostTrajectory, Options, Result


def _tree_select(pred, on_true, on_false):
    return jtu.tree_map(lambda t, f: jnp.where(pred, t, f), on_true, on_false)


@dataclasses.dataclass
class CompiledProblem:
    """Problem lowered to jax functions over stacked variable dicts.  The
    linear-system backend is either the dense normal equations or the
    Schur-reduced system (landmark elimination) — both expose the same
    ``assemble``/``linops`` protocol to the iterators."""

    manifolds: dict
    layout: engine.Layout
    batches: list
    dtype: Any
    schur_info: Any = None  # nllstpu.ops.schur.SchurInfo when Schur is active
    cg_ops: Any = None  # nllstpu.ops.cg.CGOps when the matrix-free backend is active
    # Per-batch ObsBuckets repack metadata (Schur only): runtime-masked
    # views use its ``take`` to map original-order cost masks into the
    # repacked column order.
    obs_meta: Any = None

    def cost(self, variables):
        with jax.named_scope("cost"):
            return engine.total_cost(
                self.batches, variables, self.dtype,
                runs_list=self._cost_runs(),
            )

    def _cost_runs(self):
        """Per-batch obs-major run structure (slot, L, k) for the
        broadcast-runs gather (engine._gather_vals_cm): the eliminated
        slot of an obs-major cm batch is gathered once per landmark and
        broadcast over its run instead of a B-wide gather."""
        si = self.schur_info
        out = [None] * len(self.batches)
        if si is None:
            return out
        from ..ops.schur import _fast_buckets

        for bi, f in enumerate(si.fast or ()):
            b = self.batches[bi]
            if f is None or getattr(b, "batched", None) != "cm":
                continue
            buckets = _fast_buckets(f, si)
            if buckets is not None:
                e_slot = f.e_slot if f.e_slot is not None else 1 - f.r_slot
                out[bi] = (e_slot, buckets)
        return out

    def assemble(self, variables):
        with jax.named_scope("assemble"):
            return self._assemble(variables)

    def _assemble(self, variables):
        if self.schur_info is not None:
            from ..ops import schur

            return schur.assemble_schur(
                self.batches, variables, self.layout, self.schur_info, self.dtype
            )
        if self.cg_ops is not None:
            from ..ops import cg

            return cg.assemble_cg(
                self.batches, variables, self.layout, self.manifolds, self.dtype
            )
        cost, a, b = engine.assemble_dense(
            self.batches, variables, self.layout, self.dtype
        )
        return cost, (a, b)

    def apply(self, variables, x):
        return engine.apply_step(self.manifolds, self.layout, variables, x)

    def ctx(self, options=None) -> iterators.IterCtx:
        if self.schur_info is not None:
            linops = self.schur_info.ops()
            # 0 means "disabled", matching the NLLSTPU_CG_FIXED_ITERS env
            # var and the sharded runner.
            fixed = getattr(options, "cg_fixed_iters", None)
            if fixed and hasattr(linops, "fixed_iters"):
                linops = dataclasses.replace(linops, fixed_iters=int(fixed))
            chunk = getattr(options, "cg_chunk_iters", None)
            if chunk and hasattr(linops, "chunk_iters"):
                linops = dataclasses.replace(linops, chunk_iters=int(chunk))
        elif self.cg_ops is not None:
            linops = self.cg_ops
        else:
            linops = None
        ltol = getattr(options, "linear_tol", None)
        if ltol is not None and hasattr(linops, "tol"):
            linops = dataclasses.replace(linops, tol=float(ltol))
        csz = getattr(options, "schur_cluster_size", 0)
        if csz and hasattr(linops, "cluster_size"):
            linops = dataclasses.replace(linops, cluster_size=int(csz))
        return iterators.IterCtx(
            cost=self.cost,
            apply=self.apply,
            dtype=jnp.dtype(self.dtype),
            dim=self.layout.dof_total,
            linops=linops,
        )


#: Direct ("schur") elimination stores W densely; past this budget the
#: compile falls back to the implicit (matrix-free) reduced solve.
DENSE_W_BYTE_LIMIT = 4 << 30


def _auto_dense_or_cg(problem, batches, layout):
    """The reference's dense-vs-sparse decision (``makesymmvls``,
    src/linearsystem.jl:109-118): dense when the system is small (d ≤ 40),
    else count the scalar nonzeros of the lower-triangle block sparsity
    (``block_sparse_nnz``, src/utils.jl:110-120) from the cost-variable
    incidence and apply ``sparse_dense_decision`` (src/utils.jl:108) —
    "sparse" selects the matrix-free CG backend here."""
    d = layout.dof_total
    if d <= 40:
        return "dense"
    base, total, dof_parts = {}, 0, []
    for name in problem.family_names():
        n = int(np.asarray(layout.offsets[name]).shape[0])
        base[name] = total
        total += n
        dof_parts.append(
            np.full(n, problem.manifold_of(name).dof, dtype=np.int64)
        )
    dofs = np.concatenate(dof_parts) if dof_parts else np.zeros(0, np.int64)
    diag_ids, pair_keys = [], []
    for b in batches:
        mask = np.asarray(b.mask)
        gids = []
        for s, man in enumerate(b.manifolds):
            fam = family_name(man)
            idx = np.asarray(b.idx[s])
            unfixed = np.asarray(layout.offsets[fam])[idx] < layout.dof_total
            gids.append(np.where(unfixed & mask, base[fam] + idx, -1))
        for i in range(len(gids)):
            diag_ids.append(gids[i])
            for j in range(i + 1, len(gids)):
                lo = np.minimum(gids[i], gids[j]).astype(np.int64)
                hi = np.maximum(gids[i], gids[j]).astype(np.int64)
                keep = (lo >= 0) & (lo != hi)
                pair_keys.append(lo[keep] * total + hi[keep])
    nnz = 0
    if diag_ids:
        dv = np.unique(np.concatenate(diag_ids))
        dv = dv[dv >= 0]
        nnz += int((dofs[dv] ** 2).sum())
    if pair_keys:
        pk = np.unique(np.concatenate(pair_keys))
        nnz += int((dofs[pk // total] * dofs[pk % total]).sum())
    return "cg" if nnz * 64 < 25 * d * (d - 40) else "dense"


def _auto_schur_family(problem, batches, layout):
    """Detect the bipartite-eliminable ("landmark") family so plain
    ``optimize(p)`` lands on the Schur backend without the user knowing the
    term: a small-dof family that (a) no cost touches more than once —
    the Schur structural requirement, reference src/problem.jl:185 — (b)
    dominates the tangent space (eliminating it shrinks the solve the
    most), and (c) leaves a non-empty reduced system.  Pairwise-coupled
    families (pose-graph edges: two slots of the same family per cost)
    disqualify themselves via (a).  Returns the Manifold or None."""
    counts = {name: 0 for name in problem.family_names()}
    for b in batches:
        per = {}
        for m in b.manifolds:
            per[family_name(m)] = per.get(family_name(m), 0) + 1
        for name, k in per.items():
            if k > 1:
                counts[name] = -1  # structurally ineligible
    best = None
    for name in problem.family_names():
        if counts[name] < 0:
            continue
        man = problem.manifold_of(name)
        if man.dof > 3:
            continue  # points/scalars only — closed-form block inverses
        offs = np.asarray(layout.offsets[name])
        n_unfixed = int((offs < layout.dof_total).sum())
        fam_dof = n_unfixed * man.dof
        if n_unfixed < 64 or fam_dof * 2 < layout.dof_total:
            continue
        if layout.dof_total - fam_dof <= 0:
            continue  # nothing left to reduce onto
        if best is None or fam_dof > best[0]:
            best = (fam_dof, man)
    return None if best is None else best[1]


def compile_problem(
    problem: Problem, unfixed=None, solver: str = "dense", schur_family=None
) -> CompiledProblem:
    """Lower a problem; ``solver`` is "dense", "schur"/"schur_cg" (require
    ``schur_family``, the eliminated manifold), "cg", or "auto" — the
    analogue of the reference's uni/dense/sparse decision in ``makesymmvls``
    (src/linearsystem.jl:91-124): schur iff a ``schur_family`` is given,
    dense for small systems (d ≤ 40), and the reference's fill heuristic
    ``sparse_dense_decision`` (src/utils.jl:108, nnz·64 < 25·d·(d−40))
    chooses between dense and the matrix-free CG backend (the accelerator
    replacement for its sparse LDLᵀ)."""
    batches = problem.batches()
    if solver == "auto":
        if schur_family is not None:
            solver = "schur"
        else:
            layout = engine.build_layout(problem, unfixed, batches=batches)
            solver = _auto_dense_or_cg(problem, batches, layout)
            if solver == "cg":
                cand = _auto_schur_family(problem, batches, layout)
                if cand is not None:
                    solver, schur_family = "schur", cand
    manifolds = {name: problem.manifold_of(name) for name in problem.family_names()}
    if solver in ("schur", "schur_cg"):
        if schur_family is None:
            raise ValueError(f"solver={solver!r} requires schur_family")
        from ..ops import schur

        implicit = solver == "schur_cg"
        # Degree-skew detection: real-BAL track-length distributions are
        # long-tailed, and padding every landmark's run to the max length
        # blows the obs-major compute budget.  When skewed, relabel the
        # eliminated variables in DESCENDING observation count via the
        # layout (single source of truth for id order) so the repack can
        # bucket them into contiguous power-of-two degree classes
        # (ops/schur.obs_major_repack).  Uniform problems keep index order
        # — the round-1..3 layout, bit-identical.
        from ..ops.schur import _OBS_MAJOR_MAX_RATIO, elim_degree_counts

        counts = elim_degree_counts(batches, problem, schur_family)
        order_key = None
        if counts.size and counts.sum() > 0:
            if counts.size * counts.max() > _OBS_MAJOR_MAX_RATIO * counts.sum():
                order_key = {family_name(schur_family): counts}
        layout = engine.build_layout(
            problem, unfixed, batches=batches,
            order_last=family_name(schur_family), order_key=order_key,
        )
        if not implicit:
            # The direct elimination stores W densely: [L, Dr, dl].  Past a
            # memory budget, fall back to the implicit (matrix-free) reduced
            # solve automatically.
            elim_fam = family_name(schur_family)
            n_elim = int(engine.resolve_unfixed(problem, unfixed)[elim_fam].sum())
            dl = schur_family.dof
            dr = layout.dof_total - n_elim * dl
            w_bytes = n_elim * (dr + layout.pad) * dl * np.dtype(problem.dtype).itemsize
            if w_bytes > DENSE_W_BYTE_LIMIT:
                implicit = True
        # Repack BA-shaped batches into obs-major (landmark-run) column
        # order: landmark reductions become reshape + minor-axis sums with
        # no gather (see ops.schur.obs_major_repack), the reference's
        # reordercostsforschur! done at the batch-layout level.  The info is
        # built twice: elim ids first, then the fast tables against the
        # repacked batches.
        pre = schur.build_schur_info(
            problem, layout, schur_family, implicit=implicit
        )
        batches, obs_meta = schur.repack_batches_for_schur(batches, pre)
        info = schur.build_schur_info(
            problem, layout, schur_family, implicit=implicit,
            batches=batches, obs_meta=obs_meta,
        )
        return CompiledProblem(
            manifolds=manifolds,
            layout=layout,
            batches=batches,
            dtype=problem.dtype,
            schur_info=info,
            obs_meta=obs_meta,
        )
    if solver in ("cg", "pcg"):
        from ..ops import cg

        layout = engine.build_layout(problem, unfixed, batches=batches)
        return CompiledProblem(
            manifolds=manifolds,
            layout=layout,
            batches=batches,
            dtype=problem.dtype,
            cg_ops=cg.build_cg_ops(problem, layout, batches=batches),
        )
    if solver != "dense":
        raise ValueError(f"unknown solver {solver!r}")
    layout = engine.build_layout(problem, unfixed, batches=batches)
    return CompiledProblem(
        manifolds=manifolds, layout=layout, batches=batches, dtype=problem.dtype
    )


# ---------------------------------------------------------------------------
# Shared per-iteration post-processing (termination mask etc.)
# ---------------------------------------------------------------------------


def _termination_bits(cost, dcost, bestcost, maxstep, fails, iternum, opts):
    """The reference's termination bitmask (src/optimize.jl:149-165), as
    traced int32 arithmetic."""
    bits = jnp.int32(0)
    bits |= jnp.int32(jnp.isinf(cost)) << 0
    bits |= jnp.int32(jnp.isnan(cost)) << 1
    bits |= jnp.int32(dcost < bestcost * opts.rel_dcost) << 2
    bits |= jnp.int32(dcost < opts.abs_dcost) << 3
    bits |= jnp.int32(jnp.isinf(maxstep)) << 4
    bits |= jnp.int32(jnp.isnan(maxstep)) << 5
    bits |= jnp.int32(maxstep < opts.dstep) << 6
    bits |= jnp.int32(fails > opts.max_fails) << 7
    bits |= jnp.int32(iternum >= opts.max_iters) << 8
    return bits


# ---------------------------------------------------------------------------
# Fully-jitted driver
# ---------------------------------------------------------------------------


def _loop_machine(assemble_fn, cost_fn, ctx: iterators.IterCtx, opts: Options):
    """Build the jitted outer-loop machine as ``(init, cond, body, finish)``
    over a state dict — the reference's ``optimizeinternal!``
    (src/optimize.jl:109-180) as a resumable state machine.  ``run_loop``
    composes the pieces into one ``lax.while_loop``; the chunked driver
    (``_run_jit``) instead runs host-resumable chunks so the wall-clock
    budget ``max_time`` is ALWAYS enforced (at chunk granularity) without
    per-iteration host callbacks — closing the reference-semantics gap
    where a fully-jitted solve honored only ``max_iters``
    (src/optimize.jl:160-163)."""
    dtype = ctx.dtype

    # Opt-in wall-clock termination inside the jitted loop: an ordered
    # io_callback reads the host monotonic clock once per outer iteration.
    # Times are returned relative to a trace-time base so they fit f32
    # (absolute monotonic values would lose sub-second resolution).
    use_timer = bool(getattr(opts, "jit_max_time", False)) and np.isfinite(
        opts.max_time
    )
    if use_timer:
        from jax.experimental import io_callback

        _t_base = time.monotonic()
        _t_sds = jax.ShapeDtypeStruct((), np.float32)

        def _now():
            return np.float32(time.monotonic() - _t_base)

    # Opt-in per-iteration printout from INSIDE the jitted loop — reference
    # ``printoutcallback`` parity (src/callbacks.jl:39-60) without forcing
    # the stepped driver.  All row scalars ride ONE packed f32 array per
    # iteration; ordered=True keeps rows sequenced through the while_loop.
    use_print = bool(getattr(opts, "jit_printout", False))
    if use_print:
        from jax.experimental import io_callback

        def _print_row(vals):
            vals = np.asarray(vals, dtype=np.float64)
            if len(vals) > 7 and vals[7] == 0:
                return  # rejected damping attempt (flat LM), not a row
            it = int(vals[0])
            if it == 0:
                print(
                    f"{'iter':>6} {'cost':>16} {'cost change':>16}"
                    f" {'|step|':>12} {'trust':>12}"
                )
                print(f"{0:>6} {vals[1]:>16.8e}")
                return
            c, prev_best, step, lam, tr, gd = vals[1:7]
            trust = (1.0 / lam) if lam > 0 else (tr if tr > 0 else gd)
            print(
                f"{it:>6} {c:>16.8e} {prev_best - c:>16.8e}"
                f" {step:>12.4e} {trust:>12.4e}"
            )

        def _emit_row(it, c, prev_best, step, itdata, emit=1):
            io_callback(
                _print_row,
                None,
                jnp.stack(
                    [
                        jnp.asarray(it, jnp.float32),
                        jnp.asarray(c, jnp.float32),
                        jnp.asarray(prev_best, jnp.float32),
                        jnp.asarray(step, jnp.float32),
                        jnp.asarray(itdata["lm_lambda"], jnp.float32),
                        jnp.asarray(itdata["tr"], jnp.float32),
                        jnp.asarray(itdata["gd_step"], jnp.float32),
                        # Emit flag: the flat LM machine calls once per TRIP
                        # (rejected damping attempts included) and the host
                        # side skips non-completed rows.
                        jnp.asarray(emit, jnp.float32),
                    ]
                ),
                ordered=True,
            )

    store_traj = bool(opts.store_trajectory)
    # "jit_full" additionally rings a [max_iters, dim] buffer of FULL step
    # vectors through the compiled loop — reference CostTrajectory's
    # ``trajectory`` field (src/callbacks.jl:85-107) at jit-driver speed.
    # Opt-in: the buffer is max_iters×dim, fine at bench scale (~10 MB),
    # deliberately not the default for BAL-scale dof counts.
    store_traj_vec = opts.store_trajectory == "jit_full"

    def cond(st):
        return st["converged"] == 0

    # ------------------------------------------------------------------
    # Flat LM machine: the damping retry is merged into the single outer
    # while_loop (a rejected trip only rescales λ; a completed trip runs the
    # full outer-iteration bookkeeping and conditionally re-assembles).
    # Exactly the same operations in the same order as the nested machine —
    # iteration counts, λ trajectory and costs match bit-for-bit (tested) —
    # but with ONE level of dynamic control flow instead of two, so flat LM
    # + chunked reduced CG keeps a fully-jitted implicit program two loops
    # deep while still stopping converged CG solves early.  (The reference
    # nests the retry
    # loop inside iterate!, src/iterators.jl:139-172 — host control flow,
    # where nesting is free.)
    # ------------------------------------------------------------------
    flat_lm = opts.iterator == structs.LEVENBERG_MARQUARDT and (
        getattr(opts, "flat_lm", None) is not False
    )
    if flat_lm:
        ops = ctx.ops()
        fused_trial = getattr(opts, "fused_trial", None)
        if fused_trial is None:
            import os

            env = os.environ.get("NLLSTPU_FUSED_TRIAL")
            # Default OFF: reading the trial cost off the fused assemble
            # saves a cost pass per trip, but f32 reduction-order noise in
            # that cost perturbs the λ adaptation (more damping trips per
            # iteration); untimed on the GPU.
            fused_trial = (
                env not in ("0", "false", "off") if env is not None else False
            )

    def init(vars0):
        c0 = cost_fn(vars0)
        if use_timer:
            from jax.experimental import io_callback

            t0 = io_callback(_now, _t_sds, ordered=True)
        else:
            t0 = jnp.float32(0)
        if use_print:
            _emit_row(0, c0, c0, 0.0, iterators.init_data(dtype, opts))
        state = dict(
            variables=vars0,
            varbest=vars0,
            bestcost=c0,
            lastcost=c0,
            startcost=c0,
            itdata=iterators.init_data(dtype, opts),
            fails=jnp.int32(0),
            iternum=jnp.int32(0),
            converged=jnp.int32(0),
            ncost=jnp.int32(1),
            ngrad=jnp.int32(0),
            nsolve=jnp.int32(0),
            t0=t0,
            trace=(
                jnp.full((opts.max_iters,), jnp.nan, dtype=dtype)
                if store_traj
                else jnp.zeros((0,), dtype=dtype)
            ),
            # Per-iteration step 2-norms + (with the io_callback timer)
            # iteration-end times — reference CostTrajectory fidelity
            # (src/callbacks.jl:85-107) from inside the jitted loop.
            trace_step=(
                jnp.full((opts.max_iters,), jnp.nan, dtype=dtype)
                if store_traj
                else jnp.zeros((0,), dtype=dtype)
            ),
            trace_time=(
                jnp.full((opts.max_iters,), jnp.nan, dtype=jnp.float32)
                if (store_traj and use_timer)
                else jnp.zeros((0,), dtype=jnp.float32)
            ),
            trace_vec=(
                jnp.full((opts.max_iters, ctx.dim), jnp.nan, dtype=dtype)
                if store_traj_vec
                else jnp.zeros((0, 0), dtype=dtype)
            ),
        )
        if flat_lm:
            _, sys0 = assemble_fn(vars0)
            state = dict(
                state,
                sys=sys0,
                mu=jnp.asarray(2.0, dtype),
                ngrad=jnp.int32(1),  # the pre-loop assemble above
            )
        return state

    if flat_lm:

        def body_flat(st):
            sys = st["sys"]
            itdata = st["itdata"]
            lam = itdata["lm_lambda"]
            lam = jnp.where(
                lam == 0, ops.diag_max(sys) * dtype.type(1e-6), lam
            )
            x = -ops.solve(sys, lam)
            nv = ctx.apply(st["variables"], x)
            if fused_trial:
                c, sys_trial = assemble_fn(nv)
            else:
                c = ctx.cost(nv)
            maxstep = jnp.max(jnp.abs(x))
            # The nested machine's inner-loop exit condition; non-finite
            # trial costs are FAILED trials (λ escalates and the trip
            # retries) — see iterators._levmar for the rationale.
            inner_accept = (
                ((~(c > st["bestcost"])) & jnp.isfinite(c))
                | (maxstep < opts.dstep)
                | jnp.isnan(maxstep)  # NaN system: λ cannot rescue it
            )

            # Completed-iteration results (selected in only on inner_accept).
            g = ops.grad(sys)
            # Step quality via the damped-solve identity (see _levmar).
            quality = (c - st["bestcost"]) / (
                0.5 * (g @ x - lam * (x @ x))
            )
            lam_acc = lam * jnp.where(
                quality < 0.983,
                1 - (2 * quality - 1) ** 3,
                jnp.asarray(0.1, dtype),
            )
            dcost = st["bestcost"] - c
            accepted = dcost >= 0
            snap = inner_accept & (~accepted) & (st["fails"] == 0)
            varbest = _tree_select(snap, st["variables"], st["varbest"])
            fails = jnp.where(accepted, jnp.int32(0), st["fails"] + 1)
            bestcost = jnp.where(accepted, c, st["bestcost"])
            dcost_term = jnp.where(accepted, dcost, c)
            iternum = st["iternum"] + 1
            bits = _termination_bits(
                c, dcost_term, bestcost, maxstep, fails, iternum, opts
            )
            if use_timer:
                from jax.experimental import io_callback

                now = io_callback(_now, _t_sds, ordered=True)
                bits |= jnp.int32(now - st["t0"] > opts.max_time) << 9
            if use_print:
                _emit_row(
                    iternum,
                    c,
                    st["bestcost"],
                    jnp.linalg.norm(x),
                    dict(itdata, lm_lambda=lam_acc),
                    emit=jnp.int32(inner_accept),
                )
            trace = st["trace"]
            trace_step = st["trace_step"]
            trace_time = st["trace_time"]
            trace_vec = st["trace_vec"]
            if store_traj:
                trace = jnp.where(
                    inner_accept, trace.at[iternum - 1].set(c), trace
                )
                trace_step = jnp.where(
                    inner_accept,
                    trace_step.at[iternum - 1].set(jnp.linalg.norm(x)),
                    trace_step,
                )
                if store_traj_vec:
                    trace_vec = jnp.where(
                        inner_accept,
                        trace_vec.at[iternum - 1].set(x),
                        trace_vec,
                    )
                if use_timer:
                    trace_time = jnp.where(
                        inner_accept,
                        trace_time.at[iternum - 1].set(now - st["t0"]),
                        trace_time,
                    )
            cont = inner_accept & (bits == 0)
            if fused_trial:
                # The trial already assembled its system: accepted trips
                # adopt it, rejected trips keep the current one — no
                # separate re-assemble exists in this machine.
                sys_next = _tree_select(inner_accept, sys_trial, sys)
                ngrad_next = st["ngrad"] + 1
            else:
                # Re-assemble only when the loop will actually continue:
                # total assembles == completed iterations, like the nested
                # machine.
                sys_next = jax.lax.cond(
                    cont, lambda v: assemble_fn(v)[1], lambda v: sys, nv
                )
                ngrad_next = st["ngrad"] + jnp.int32(cont)
            return dict(
                variables=_tree_select(inner_accept, nv, st["variables"]),
                varbest=varbest,
                bestcost=jnp.where(inner_accept, bestcost, st["bestcost"]),
                lastcost=jnp.where(inner_accept, c, st["lastcost"]),
                startcost=st["startcost"],
                itdata=dict(
                    itdata,
                    lm_lambda=jnp.where(
                        inner_accept, lam_acc, lam * st["mu"]
                    ),
                ),
                mu=jnp.where(
                    inner_accept, jnp.asarray(2.0, dtype), st["mu"] * 2
                ),
                fails=jnp.where(inner_accept, fails, st["fails"]),
                iternum=jnp.where(inner_accept, iternum, st["iternum"]),
                converged=jnp.where(inner_accept, bits, jnp.int32(0)),
                ncost=st["ncost"] + 1,
                ngrad=ngrad_next,
                nsolve=st["nsolve"] + 1,
                t0=st["t0"],
                trace=trace,
                trace_step=trace_step,
                trace_time=trace_time,
                trace_vec=trace_vec,
                sys=sys_next,
            )

        def finish(final):
            final = {
                k: v for k, v in final.items() if k not in ("sys", "mu")
            }
            out_vars = _tree_select(
                ~(final["bestcost"] >= final["lastcost"]),
                final["varbest"],
                final["variables"],
            )
            return dict(final, variables=out_vars)

        return init, cond, body_flat, finish

    def body(st):
        _, sys = assemble_fn(st["variables"])
        nv, c, x, itdata, ns, nc = iterators.iterate(
            opts.iterator, ctx, sys, st["variables"], st["bestcost"], st["itdata"], opts
        )
        dcost = st["bestcost"] - c
        accepted = dcost >= 0
        snap = (~accepted) & (st["fails"] == 0)
        varbest = _tree_select(snap, st["variables"], st["varbest"])
        fails = jnp.where(accepted, jnp.int32(0), st["fails"] + 1)
        bestcost = jnp.where(accepted, c, st["bestcost"])
        dcost_term = jnp.where(accepted, dcost, c)
        iternum = st["iternum"] + 1
        maxstep = jnp.max(jnp.abs(x))
        bits = _termination_bits(
            c, dcost_term, bestcost, maxstep, fails, iternum, opts
        )
        if use_timer:
            from jax.experimental import io_callback

            now = io_callback(_now, _t_sds, ordered=True)
            bits |= jnp.int32(now - st["t0"] > opts.max_time) << 9
        if use_print:
            _emit_row(
                iternum, c, st["bestcost"], jnp.linalg.norm(x), itdata
            )
        trace = st["trace"]
        trace_step = st["trace_step"]
        trace_time = st["trace_time"]
        trace_vec = st["trace_vec"]
        if store_traj:
            trace = trace.at[iternum - 1].set(c)
            trace_step = trace_step.at[iternum - 1].set(jnp.linalg.norm(x))
            if store_traj_vec:
                trace_vec = trace_vec.at[iternum - 1].set(x)
            if use_timer:
                trace_time = trace_time.at[iternum - 1].set(now - st["t0"])
        return dict(
            variables=nv,
            varbest=varbest,
            bestcost=bestcost,
            lastcost=c,
            startcost=st["startcost"],
            itdata=itdata,
            fails=fails,
            iternum=iternum,
            converged=bits,
            ncost=st["ncost"] + nc,
            ngrad=st["ngrad"] + 1,
            nsolve=st["nsolve"] + ns,
            t0=st["t0"],
            trace=trace,
            trace_step=trace_step,
            trace_time=trace_time,
            trace_vec=trace_vec,
        )

    def finish(final):
        # Roll back to the best variables if the last ones are worse —
        # NaN-safe like the reference's ``!(bestcost >= cost)``
        # (src/optimize.jl:173-176): a NaN final cost must also trigger the
        # rollback.
        out_vars = _tree_select(
            ~(final["bestcost"] >= final["lastcost"]),
            final["varbest"],
            final["variables"],
        )
        return dict(final, variables=out_vars)

    return init, cond, body, finish


def run_loop(assemble_fn, cost_fn, ctx: iterators.IterCtx, opts: Options, vars0):
    """Generic jitted outer-optimization loop over an arbitrary variables
    pytree (the reference's ``optimizeinternal!``, src/optimize.jl:109-180).
    Used both for the full multivariate solve and — vmapped — for the
    per-variable alternation solves."""
    init, cond, body, finish = _loop_machine(assemble_fn, cost_fn, ctx, opts)
    return finish(jax.lax.while_loop(cond, body, init(vars0)))


#: Fully-jitted implicit programs above this many (padded) observations get
#: chunked reduced PCG by default: a ``while_loop`` over 25-iteration
#: ``fori_loop`` blocks, so converged solves stop at chunk granularity and
#: the loop state is checked once per chunk.  It applies on every backend and
#: changes where CG stops (a converged solve may run up to 24 extra frozen
#: iterations), so it is part of the solver's behaviour, not a device
#: workaround; whether it still pays on the GPU is open (ROADMAP §3.3).
GIANT_IMPLICIT_OBS_LIMIT = 200_000
_GIANT_IMPLICIT_CG_CHUNK = 25


class _JitRunner:
    """Compiled-loop driver with host-resumable chunks.

    ``start(vars0, iter_stop)`` initializes and runs the loop until
    convergence or ``iter_stop`` completed iterations; ``resume(state,
    iter_stop)`` continues it.  Both return ``(state, outputs)`` where
    ``outputs = (variables, trace, trace_step, trace_time, trace_vec,
    packed)`` are
    the finished results as of that chunk — a run that converges within
    its first chunk (the common case) never traces ``resume`` at all, so
    the always-on wall-clock enforcement costs nothing until a run is
    actually long."""

    def __init__(self, compiled: CompiledProblem, opts: Options):
        import os

        if (
            compiled.schur_info is not None
            and compiled.schur_info.implicit
            and getattr(opts, "cg_fixed_iters", None) is None
            and getattr(opts, "cg_chunk_iters", None) is None
            and os.environ.get("NLLSTPU_CG_FIXED_ITERS") is None
            and os.environ.get("NLLSTPU_CG_CHUNK_ITERS") is None
            and sum(b.n_padded for b in compiled.batches)
            > GIANT_IMPLICIT_OBS_LIMIT
        ):
            opts = dataclasses.replace(
                opts, cg_chunk_iters=_GIANT_IMPLICIT_CG_CHUNK
            )
        self.compiled = compiled
        self.opts = opts
        self._machine = None
        self._start = None
        self._resume = None

    def _pieces(self):
        if self._machine is None:
            ctx = self.compiled.ctx(self.opts)
            self._machine = _loop_machine(
                self.compiled.assemble, self.compiled.cost, ctx, self.opts
            )
        return self._machine

    @staticmethod
    def _outputs(final):
        # Pack all result scalars into one array: the host needs every one
        # of them, so one device-to-host copy serves them all.
        packed = jnp.stack(
            [
                final["startcost"].astype(jnp.float64),
                final["bestcost"].astype(jnp.float64),
                final["converged"].astype(jnp.float64),
                final["iternum"].astype(jnp.float64),
                final["ncost"].astype(jnp.float64),
                final["ngrad"].astype(jnp.float64),
                final["nsolve"].astype(jnp.float64),
            ]
        )
        return (
            final["variables"],
            final["trace"],
            final["trace_step"],
            final["trace_time"],
            final["trace_vec"],
            packed,
        )

    def _start_fn(self):
        init, cond, body, finish = self._pieces()

        def _start(v0, stop):
            st = jax.lax.while_loop(
                lambda s: cond(s) & (s["iternum"] < stop), body, init(v0)
            )
            return st, self._outputs(finish(st))

        return _start

    def _resume_fn(self):
        init, cond, body, finish = self._pieces()

        def _resume(st, stop):
            st = jax.lax.while_loop(
                lambda s: cond(s) & (s["iternum"] < stop), body, st
            )
            return st, self._outputs(finish(st))

        return _resume

    def prepare(self, vars0, need_resume: bool):
        """AOT-compile the chunk executable(s) so the ``max_time`` budget
        clock can start AFTER compilation: a large problem's first compile
        can take minutes and would otherwise eat a default 30 s budget
        before a single iteration ran.  (The ``jit_max_time``
        io_callback path already excludes compile naturally — its t0 is
        read when the program first EXECUTES.)"""
        stop_sds = jax.ShapeDtypeStruct((), jnp.int32)
        if self._start is None:
            self._start = (
                jax.jit(self._start_fn()).lower(vars0, stop_sds).compile()
            )
        if need_resume and self._resume is None:
            state_sds, _ = jax.eval_shape(self._start_fn(), vars0, stop_sds)
            # Donate the incoming state: chunk N's state is dead once
            # chunk N+1 starts, and the dense-W system buffer in the flat
            # LM state is large.  ALIASING INVARIANT (ADVICE round 4): the
            # previous chunk's ``outs`` tuple shares buffers with the
            # donated state (finish() passes trace/trace_step/trace_time
            # through unchanged), so every consumer must rebind ``outs``
            # from the resume's return value before touching the old one —
            # _run_jit reads back ``stats`` and rebinds ``state, outs``
            # each pass; any new caller holding a pre-resume ``outs`` after
            # a resume would read deleted buffers.
            self._resume = (
                jax.jit(self._resume_fn(), donate_argnums=(0,))
                .lower(state_sds, stop_sds)
                .compile()
            )

    def start(self, vars0, iter_stop):
        if self._start is None:
            self.prepare(vars0, need_resume=False)
        return self._start(vars0, jnp.int32(iter_stop))

    def resume(self, state, iter_stop):
        assert self._resume is not None  # prepare(need_resume=True) first
        return self._resume(state, jnp.int32(iter_stop))


def _unfixed_cache_key(unfixed):
    from .manifolds import Manifold
    from .problem import VarHandle

    if unfixed is None or isinstance(unfixed, Manifold):
        return unfixed
    if isinstance(unfixed, VarHandle):
        return (unfixed.family, unfixed.index)
    if isinstance(unfixed, dict):
        return tuple(
            (name, tuple(np.asarray(m, dtype=bool).tolist()))
            for name, m in sorted(unfixed.items())
        )
    return tuple((h.family, h.index) for h in unfixed)


#: LRU capacity of the compiled-runner cache: alternation workflows swap
#: between a handful of (problem, options, unfixed) configurations — e.g.
#: EM alternation over two subproblems — and must not recompile per call.
_RUNNER_CACHE_SIZE = 8
_runner_cache: dict = {}  # insertion-ordered → LRU via move-to-end semantics


class _RunnerEntry:
    """Cache slot: the compiled problem plus a lazily-built jit runner."""

    __slots__ = ("compiled", "opts", "_runner")

    def __init__(self, compiled, opts):
        self.compiled = compiled
        self.opts = opts
        self._runner = None

    def runner(self):
        if self._runner is None:
            self._runner = _JitRunner(self.compiled, self.opts)
        return self._runner


def _cached_entry(problem, opts, unfixed) -> _RunnerEntry:
    """Reuse the compiled problem (and its jit runner) across optimize()
    calls as long as the problem *structure* is unchanged (value edits via
    set_value don't invalidate — variable values are runtime arguments, not
    constants).  A small LRU (``_RUNNER_CACHE_SIZE`` entries) so alternating
    optimize() across several problems/options doesn't recompile every
    call."""
    key = (
        id(problem),
        problem.structure_version,
        opts,
        _unfixed_cache_key(unfixed),
    )
    hit = _runner_cache.pop(key, None)
    # id() can alias a garbage-collected problem: verify identity via weakref.
    if hit is not None and hit[1]() is problem:
        _runner_cache[key] = hit  # re-insert = most recently used
        return hit[0]
    compiled = compile_problem(
        problem, unfixed, solver=opts.solver, schur_family=opts.schur_family
    )
    if compiled.layout.dof_total == 0:
        raise ValueError("no unfixed variables to optimize")
    entry = _RunnerEntry(compiled, opts)
    while len(_runner_cache) >= _RUNNER_CACHE_SIZE:
        _runner_cache.pop(next(iter(_runner_cache)))
    _runner_cache[key] = (entry, weakref.ref(problem))
    return entry


#: First-chunk iteration budget of the chunked jit driver: one host
#: round-trip per this many iterations caps the ``max_time`` enforcement
#: overhead at well under 1% while guaranteeing at least this much progress
#: even when compilation alone exceeds the budget (mirrors the stepped
#: driver, which likewise checks the clock only after a full iteration).
_JIT_TIME_CHUNK = 32


def _run_jit(problem, entry: _RunnerEntry, opts) -> Result:
    t0 = time.perf_counter()
    runner = entry.runner()
    vars0 = problem.stacked_variables()
    t1 = time.perf_counter()
    # Wall-clock budget enforcement (reference src/optimize.jl:160-163 —
    # ALWAYS on there): with a finite ``max_time`` the loop runs in
    # host-resumable chunks and the clock is checked between chunks; the
    # opt-in ``jit_max_time`` io_callback path keeps per-iteration
    # precision inside one program.  ``max_time=inf`` runs one program.
    chunked = np.isfinite(opts.max_time) and not getattr(
        opts, "jit_max_time", False
    )
    timed_out = False
    if not chunked:
        state, outs = runner.start(vars0, opts.max_iters)
        stats = np.asarray(outs[-1])  # single readback fences execution
    else:
        # Compile BEFORE starting the budget clock (see _JitRunner.prepare)
        # — the budget covers optimization work, not XLA compilation.  The
        # resume executable compiles lazily on first actual use, with the
        # budget clock paused around it.
        runner.prepare(vars0, need_resume=False)
        t1 = time.perf_counter()
        t_budget = t1
        iter_stop = min(_JIT_TIME_CHUNK, opts.max_iters)
        # Stamp the chunk clock BEFORE the first chunk runs so the first
        # resume's chunk size is driven by chunk 1's measured per-iteration
        # rate — stamping after the readback made the first per_iter ~zero,
        # clipping the first resume to 4096 iterations and overshooting a
        # slow solve's budget (ADVICE round 4, medium).
        t_chunk = time.perf_counter()
        state, outs = runner.start(vars0, iter_stop)
        stats = np.asarray(outs[-1])
        prev_done = 0
        while stats[2] == 0:  # chunk budget hit, not converged
            if runner._resume is None:
                tc = time.perf_counter()
                runner.prepare(vars0, need_resume=True)
                dt_compile = time.perf_counter() - tc
                t_budget += dt_compile
                t_chunk += dt_compile
            elapsed = time.perf_counter() - t_budget
            if elapsed > opts.max_time:
                timed_out = True
                break
            # Size the next chunk from the LAST chunk's per-iteration rate
            # (excludes compile time after the first chunk), aiming at
            # ~half the remaining budget per chunk so the overshoot past
            # max_time stays small while long runs pay only a handful of
            # host round-trips.
            done = int(stats[3])
            per_iter = max(
                (time.perf_counter() - t_chunk) / max(done - prev_done, 1),
                1e-6,
            )
            remaining = opts.max_time - elapsed
            grow = int(np.clip(remaining / per_iter * 0.5, 8, 4096))
            prev_done = done
            iter_stop = min(done + grow, opts.max_iters)
            t_chunk = time.perf_counter()
            state, outs = runner.resume(state, iter_stop)
            stats = np.asarray(outs[-1])
    out_vars, trace, trace_step, trace_time, trace_vec, _ = outs
    t2 = time.perf_counter()
    problem.set_values(out_vars)
    n_iter = int(stats[3])
    termination = int(stats[2]) | (
        structs.TERM_MAX_TIME if timed_out else 0
    )
    trajectory = None
    if opts.store_trajectory:
        costs = np.asarray(trace)[:n_iter]
        tt = np.asarray(trace_time)
        times_ns = (
            [int(v * 1e9) for v in tt[:n_iter]] if tt.size else []
        )
        steps = np.asarray(trace_step)[:n_iter]
        vecs = np.asarray(trace_vec)
        trajectory = CostTrajectory(
            costs=list(costs),
            times_ns=times_ns,
            trajectory=(
                [vecs[i].copy() for i in range(n_iter)] if vecs.size else []
            ),
            step_norms=list(steps),
        )
    return Result(
        start_cost=float(stats[0]),
        best_cost=float(stats[1]),
        time_total=t2 - t0,
        time_init=t1 - t0,
        # The whole optimization is ONE fused XLA program here: per-phase
        # wall times are not separable, and zeros would masquerade as
        # measurements.  NaN = "not measured" (documented on Result); use a
        # callback / the stepped driver for real per-phase attribution.
        time_cost=float("nan"),
        time_gradient=float("nan"),
        time_solver=float("nan"),
        termination=termination,
        num_iterations=n_iter,
        cost_computations=int(stats[4]),
        gradient_computations=int(stats[5]),
        linear_solves=int(stats[6]),
        trajectory=trajectory,
    )


# ---------------------------------------------------------------------------
# Runtime-masked subproblem view (reference subproblem!, src/problem.jl:47-83)
# ---------------------------------------------------------------------------


class SubproblemView:
    """Reusable cost-subset view over one problem: compile ONCE, then swap
    the active subset as a runtime mask value — the compiled counterpart
    of the reference's in-place ``subproblem!`` (src/problem.jl:47-83),
    which reuses problem storage across subset swaps so tight alternation
    doesn't rebuild structures.  Here "structure" is the traced XLA
    program: the view's batches keep the FULL problem's padded shapes and
    the per-batch boolean masks arrive as jit arguments, so two subset
    swaps hit the same executable with zero retracing.

    ``solver="dense"`` (default) or ``"schur"`` (+ ``schur_family``) — the
    direct-Schur fast paths gate every contribution through the traced
    mask (the robust weights d1/d2 fold it in), so Schur-scale alternation
    swaps subsets with zero recompiles too; the view maps original-order
    masks through the obs-major/camera repack permutations
    (``CompiledProblem.obs_meta`` / ``_FastBatch.cam_take``).  Non-cm
    batches with fast tables are demoted to the generic (runtime-safe)
    scatter path at view build.  The implicit backend precomputes
    mask-dependent preconditioner structure and is not supported.

    Use a DAMPED iterator (LM or dogleg, the default): variables touched
    by no active cost have exactly-zero gradient and Hessian rows, so the
    λ-damped solve gives them an exactly-zero step, while undamped Newton
    would face a singular system (the reference's alternation likewise
    pairs ``subproblem`` with per-variable ``unfixed`` or damping).

    Usage::

        view = SubproblemView(problem)
        view.select(handle_or_predicate)
        res = view.optimize(options)          # same compile across selects
    """

    def __init__(self, problem: Problem, unfixed=None, solver: str = "dense",
                 schur_family=None):
        self.problem = problem
        self._structure_version = problem.structure_version
        if solver not in ("dense", "schur"):
            raise ValueError(
                "SubproblemView supports solver='dense' or 'schur'"
            )
        self.compiled = compile_problem(
            problem, unfixed, solver=solver, schur_family=schur_family
        )
        info = self.compiled.schur_info
        if info is not None:
            if info.implicit:
                raise ValueError(
                    "SubproblemView over the implicit Schur backend is not "
                    "supported (mask-dependent preconditioner structure); "
                    "use solver='schur' under the dense-W byte budget or "
                    "rebuild per subset via Problem.subproblem"
                )
            # Demote fast batches that would not take the DUAL path to the
            # generic scatter path: the non-dual one-hot/table reductions
            # key off STATIC dustbin ids and would ignore a runtime mask,
            # while the dual path gates every contribution through the
            # traced d1/d2 weights.
            from ..ops import schur as _schur

            fast = tuple(
                f
                if (
                    f is None
                    or (
                        getattr(b, "batched", None) == "cm"
                        and _schur._fast_buckets(f, info) is not None
                    )
                )
                else None
                for f, b in zip(info.fast, self.compiled.batches)
            )
            self.compiled = dataclasses.replace(
                self.compiled,
                schur_info=dataclasses.replace(info, fast=fast),
            )
        if self.compiled.layout.dof_total == 0:
            raise ValueError("no unfixed variables to optimize")
        self._base_masks = tuple(
            jnp.asarray(b.mask) for b in self.compiled.batches
        )
        self._masks = tuple(self._map_masks(None))
        self._runners: dict = {}
        self.trace_count = 0  # observable "no recompile" evidence for tests

    def _map_masks(self, orig_masks):
        """AND original-order subset masks (None = all-true) into the
        compiled batches' (possibly repacked) column order, including each
        dual-path batch's camera-major twin."""
        metas = self.compiled.obs_meta or [None] * len(self.compiled.batches)
        info = self.compiled.schur_info
        out = []
        for i, (b, base) in enumerate(
            zip(self.compiled.batches, self._base_masks)
        ):
            if orig_masks is None:
                m = base
            else:
                om = jnp.asarray(orig_masks[i])
                meta = metas[i] if i < len(metas) else None
                if meta is not None and meta.take is not None:
                    om = om[jnp.asarray(meta.take)]
                m = base & om
            cam_m = None
            f = info.fast[i] if info is not None and i < len(info.fast) else None
            if f is not None and f.cam_take is not None:
                cam_m = m[jnp.asarray(f.cam_take)] & jnp.asarray(
                    f.cam_batch.mask
                )
            out.append((m, cam_m))
        return out

    def select(self, predicate) -> "SubproblemView":
        """Choose the active cost subset (same predicate forms as
        ``Problem.subproblem``); padding and base-validity masks are always
        ANDed in.  Returns self for chaining."""
        if self.problem.structure_version != self._structure_version:
            raise ValueError(
                "problem structure changed since this view was compiled; "
                "build a new SubproblemView"
            )
        masks = self.problem.subset_masks(predicate)
        self._masks = tuple(self._map_masks(masks))
        return self

    def _masked(self, masks):
        batches = [
            dataclasses.replace(b, mask=m)
            for b, (m, _) in zip(self.compiled.batches, masks)
        ]
        compiled = dataclasses.replace(self.compiled, batches=batches)
        info = compiled.schur_info
        if info is not None:
            fast = tuple(
                f
                if (f is None or f.cam_batch is None)
                else dataclasses.replace(
                    f,
                    cam_batch=dataclasses.replace(
                        f.cam_batch, mask=cam_m
                    ),
                )
                for f, (_, cam_m) in zip(info.fast, masks)
            )
            compiled = dataclasses.replace(
                compiled, schur_info=dataclasses.replace(info, fast=fast)
            )
        return compiled

    def cost(self) -> float:
        runner = self._runners.get("cost")
        if runner is None:

            def _cost(variables, masks):
                return self._masked(masks).cost(variables)

            runner = jax.jit(_cost)
            self._runners["cost"] = runner
        return float(runner(self.problem.stacked_variables(), self._masks))

    def optimize(self, options: Options = None) -> Result:
        """Optimize the selected subset in place on the parent problem.
        One traced program per Options value; subset swaps reuse it."""
        options = options or Options()
        t0 = time.perf_counter()
        runner = self._runners.get(options)
        if runner is None:

            def _run(vars0, masks):
                # Python side effect: executes at TRACE time only, so
                # trace_count observably stays put across subset swaps
                # (the "no recompile" contract, asserted in tests).
                self.trace_count += 1
                c = self._masked(masks)
                final = run_loop(
                    c.assemble, c.cost, c.ctx(options), options, vars0
                )
                packed = jnp.stack(
                    [
                        final["startcost"].astype(jnp.float64),
                        final["bestcost"].astype(jnp.float64),
                        final["converged"].astype(jnp.float64),
                        final["iternum"].astype(jnp.float64),
                        final["ncost"].astype(jnp.float64),
                        final["ngrad"].astype(jnp.float64),
                        final["nsolve"].astype(jnp.float64),
                    ]
                )
                return final["variables"], packed

            runner = jax.jit(_run)
            self._runners[options] = runner
        vars0 = self.problem.stacked_variables()
        t1 = time.perf_counter()
        out_vars, packed = runner(vars0, self._masks)
        stats = np.asarray(packed)
        t2 = time.perf_counter()
        self.problem.set_values(out_vars)
        return Result(
            start_cost=float(stats[0]),
            best_cost=float(stats[1]),
            time_total=t2 - t0,
            time_init=t1 - t0,
            time_cost=float("nan"),
            time_gradient=float("nan"),
            time_solver=float("nan"),
            termination=int(stats[2]),
            num_iterations=int(stats[3]),
            cost_computations=int(stats[4]),
            gradient_computations=int(stats[5]),
            linear_solves=int(stats[6]),
        )


# ---------------------------------------------------------------------------
# Stepped driver (callbacks / wall-clock limits / per-phase timing)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CallbackContext:
    """What a user callback sees.  ``variables`` holds the *trial* variables
    produced by the current iteration; the callback may replace entries (the
    reference's callbacks may mutate ``problem.varnext``,
    src/optimize.jl:40-50 and test/adaptivecost.jl:15-25).  ``cost_fn`` is the
    compiled total-cost function for recomputing the cost after mutation."""

    problem: Problem
    variables: dict
    step: Any
    bestcost: float
    iteration: int
    cost_fn: Callable
    itdata: dict


def _run_stepped(problem, compiled, opts, callback) -> Result:
    t0 = time.perf_counter()
    ctx = compiled.ctx(opts)
    cost_j = jax.jit(compiled.cost)
    assemble_j = jax.jit(compiled.assemble)
    # Host-stepped iterator: the retry loop runs in Python with separately
    # jitted solve and apply+cost kernels so time_solver/time_cost are real
    # measurements (reference per-phase semantics, src/iterators.jl:19,24,
    # 149-157) rather than one fused iterate time.
    stepped = iterators.make_stepped(opts.iterator, ctx, opts)

    variables = problem.stacked_variables()
    tc = time.perf_counter()
    c0 = float(cost_j(variables))
    time_cost = time.perf_counter() - tc
    bestcost = c0
    varbest = variables
    itdata = iterators.init_data(ctx.dtype, opts)
    fails = 0
    iternum = 0
    ncost, ngrad, nsolve = 1, 0, 0
    time_grad = time_solve = 0.0
    trajectory = CostTrajectory() if opts.store_trajectory else None
    t_init = time.perf_counter() - t0
    termination = 0
    lastcost = c0

    while True:
        tg = time.perf_counter()
        _, sys = jax.block_until_ready(assemble_j(variables))
        ngrad += 1
        time_grad += time.perf_counter() - tg

        nv, c, x, itdata, ns, nc, t_sol, t_cst = stepped(
            sys, variables, bestcost, itdata
        )
        time_solve += t_sol
        time_cost += t_cst
        nsolve += int(ns)
        ncost += int(nc)
        iternum += 1
        c = float(c)

        user_term = 0
        if callback is not None:
            cb_ctx = CallbackContext(
                problem=problem,
                variables=dict(nv),
                step=x,
                bestcost=bestcost,
                iteration=iternum,
                cost_fn=cost_j,
                itdata=itdata,
            )
            c, user_term = callback(c, cb_ctx)
            c = float(c)
            nv = cb_ctx.variables

        dcost = bestcost - c
        if dcost >= 0:
            bestcost = c
            fails = 0
        else:
            dcost = c
            fails += 1
            if fails == 1:
                varbest = variables
        variables = nv
        lastcost = c
        maxstep = float(jnp.max(jnp.abs(x)))

        termination = 0
        if np.isinf(c):
            termination |= structs.TERM_COST_INF
        if np.isnan(c):
            termination |= structs.TERM_COST_NAN
        if dcost < bestcost * opts.rel_dcost:
            termination |= structs.TERM_RELDCOST
        if dcost < opts.abs_dcost:
            termination |= structs.TERM_ABSDCOST
        if np.isinf(maxstep):
            termination |= structs.TERM_STEP_INF
        if np.isnan(maxstep):
            termination |= structs.TERM_STEP_NAN
        if maxstep < opts.dstep:
            termination |= structs.TERM_SMALL_STEP
        if fails > opts.max_fails:
            termination |= structs.TERM_MAX_FAILS
        if iternum >= opts.max_iters:
            termination |= structs.TERM_MAX_ITERS
        if time.perf_counter() - t0 > opts.max_time:
            termination |= structs.TERM_MAX_TIME
        termination |= int(user_term) << structs.TERM_USER_SHIFT

        if trajectory is not None:
            trajectory.costs.append(c)
            trajectory.times_ns.append(int((time.perf_counter() - t0) * 1e9))
            trajectory.trajectory.append(np.asarray(x))

        if termination:
            break

    if not (bestcost >= lastcost):  # NaN-safe rollback (src/optimize.jl:173)
        variables = varbest
    problem.set_values(variables)
    return Result(
        start_cost=c0,
        best_cost=bestcost,
        time_total=time.perf_counter() - t0,
        time_init=t_init,
        time_cost=time_cost,
        time_gradient=time_grad,
        time_solver=time_solve,
        termination=termination,
        num_iterations=iternum,
        cost_computations=ncost,
        gradient_computations=ngrad,
        linear_solves=nsolve,
        trajectory=trajectory,
    )


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def cost(problem: Problem) -> float:
    """Total problem cost (reference ``cost(problem)``, src/cost.jl:10)."""
    compiled = compile_problem(problem)
    return float(jax.jit(compiled.cost)(problem.stacked_variables()))


def optimize(
    problem: Problem,
    options: Options = None,
    unfixed=None,
    callback: Optional[Callable] = None,
) -> Result:
    """Optimize the problem in place and return a :class:`Result`
    (reference ``optimize!``, src/optimize.jl:57).

    ``unfixed`` selects which variables to optimize: ``None`` (all), a
    :class:`Manifold` (one family), a :class:`VarHandle`, an iterable of
    handles, or a dict of per-family boolean masks.

    A ``callback(cost, ctx) -> (new_cost, terminate_flags)`` switches to the
    stepped driver; ``terminate_flags != 0`` stops the optimization and is
    reported shifted into the user bits of ``Result.termination``.
    """
    options = options or Options()
    # ``store_trajectory=True`` keeps full reference fidelity (per-phase
    # times, full step vectors) on the stepped driver; ``"jit"`` records
    # costs + step norms (+ times with ``jit_max_time``) from inside the
    # compiled loop at full jit-driver speed.
    if callback is not None or options.store_trajectory is True:
        compiled = compile_problem(
            problem, unfixed, solver=options.solver,
            schur_family=options.schur_family,
        )
        if compiled.layout.dof_total == 0:
            raise ValueError("no unfixed variables to optimize")
        return _run_stepped(problem, compiled, options, callback)
    return _run_jit(problem, _cached_entry(problem, options, unfixed), options)
