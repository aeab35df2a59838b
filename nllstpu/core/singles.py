"""Per-variable alternation: optimize many single variables independently.

Reference parity: ``optimizesingles!`` (src/optimize.jl:59-76, 183-205) loops
over the variables of one type serially, building a per-variable cost subset
from the transposed variable-cost incidence map.  The batched design
(SURVEY.md §7) instead runs **all** per-variable solves simultaneously: the
per-variable cost subsets become padded index lists, the tiny univariate
solver loop is the same generic ``run_loop``, and ``jax.vmap`` lifts it over
the whole variable batch — one XLA computation for thousands of independent
LM/Newton solves.

Semantics note: the reference's serial sweep is Gauss-Seidel (later variables
see earlier updates); the vmapped version is Jacobi (all solves see the
initial values of the other variables).  When no cost couples two target
variables — the bundle-adjustment landmark-polish case this API exists for —
the two are identical.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from . import iterators
from .engine import _cost_grad_hess_slot, _cost_value_one
from .optimize import run_loop
from .manifolds import Manifold
from .problem import Problem, family_name
from .structs import Options


def _pair_row_lists(batch, slot, target_indices):
    """For each target variable, the padded list of batch rows whose ``slot``
    dependency is that variable (the reference's per-variable ``selectcosts!``
    subsets, src/optimize.jl:194, built once host-side).  Sort-based:
    O(B log B + T·kmax) instead of a per-target scan of the batch — at
    BAL scale (8k landmarks × 100k obs) that is the difference between
    milliseconds and tens of seconds of setup."""
    idx = np.asarray(batch.idx[slot])
    mask = np.asarray(batch.mask)
    valid = np.nonzero(mask)[0]
    order = valid[np.argsort(idx[valid], kind="stable")]
    sorted_ids = idx[order]
    targets = np.asarray(target_indices, dtype=idx.dtype)
    starts = np.searchsorted(sorted_ids, targets, side="left")
    counts = np.searchsorted(sorted_ids, targets, side="right") - starts
    kmax = max(int(counts.max()) if counts.size else 0, 1)
    rmask = np.arange(kmax)[None, :] < counts[:, None]
    if order.size:
        gather = np.minimum(
            starts[:, None] + np.arange(kmax)[None, :], order.size - 1
        )
        rows = np.where(rmask, order[gather], 0).astype(np.int32)
    else:
        rows = np.zeros((len(targets), kmax), dtype=np.int32)
    return rows, rmask


def optimize_singles(problem: Problem, options: Options = None, targets=None):
    """Optimize each target variable independently, all others fixed
    (reference ``optimizesingles!``).  ``targets`` is a :class:`Manifold`
    (all variables of that family) or an iterable of handles.  Variables are
    updated in place; returns a dict of per-family iteration counts."""
    options = options or Options()
    if targets is None:
        raise ValueError("optimize_singles requires targets (a Manifold or handles)")
    if isinstance(targets, Manifold):
        fam_targets = {family_name(targets): None}  # None = all
    else:
        fam_targets = {}
        for h in targets:
            fam_targets.setdefault(h.family, []).append(h.index)

    batches = problem.batches()
    fam_arrays = problem.stacked_variables()
    summary = {}
    for fam, indices in fam_targets.items():
        man = problem.manifold_of(fam)
        n_all = fam_arrays[fam].shape[0]
        target_indices = list(range(n_all)) if indices is None else sorted(indices)
        new_values, iters = _solve_family(
            problem, batches, fam_arrays, fam, man, target_indices, options
        )
        arr = fam_arrays[fam].at[jnp.asarray(target_indices)].set(new_values)
        fam_arrays = dict(fam_arrays, **{fam: arr})
        summary[fam] = int(iters)
    problem.set_values(fam_arrays)
    return summary


def _solve_family(problem, batches, fam_arrays, fam, man, target_indices, opts):
    if getattr(opts, "jit_printout", False):
        # Per-iteration printing is meaningless (and ordered io_callbacks
        # unsupported) under the vmapped per-variable solves.
        import dataclasses

        opts = dataclasses.replace(opts, jit_printout=False)
    dtype = jnp.dtype(problem.dtype)
    d = man.dof
    # (batch, slot) pairs where this family appears.
    pairs = []
    row_data = []
    for ti, b in enumerate(batches):
        for s, m in enumerate(b.manifolds):
            if family_name(m) == fam:
                pairs.append((ti, s))
                row_data.append(_pair_row_lists(b, s, target_indices))
    if not pairs:
        raise ValueError(f"no costs touch family {fam}")

    def solve_one(value0, rowdata):
        def pair_vals(pair_i, value, rows):
            ti, s = pairs[pair_i]
            b = batches[ti]
            # Batch data are host numpy; lift to jnp before indexing with the
            # vmapped (traced) row indices.
            params_rows = (
                None
                if b.params is None
                else jtu.tree_map(lambda l: jnp.asarray(l)[rows], b.params)
            )
            other = tuple(
                fam_arrays[family_name(m)][jnp.asarray(b.idx[j])[rows]]
                for j, m in enumerate(b.manifolds)
            )
            return b, s, params_rows, other

        def cost_v(value):
            total = jnp.zeros((), dtype=dtype)
            for pair_i, (rows, rmask) in enumerate(rowdata):
                b, s, params_rows, other = pair_vals(pair_i, value, rows)

                def one(params, *ov):
                    vals = list(ov)
                    vals[s] = value
                    return _cost_value_one(b, params, tuple(vals))

                axes = (None if b.params is None else 0,) + (0,) * len(other)
                cc = jax.vmap(one, in_axes=axes)(params_rows, *other)
                total = total + jnp.sum(jnp.where(rmask, cc, 0))
            return total

        def assemble_v(value):
            total = jnp.zeros((), dtype=dtype)
            a = jnp.zeros((d, d), dtype=dtype)
            g = jnp.zeros(d, dtype=dtype)
            for pair_i, (rows, rmask) in enumerate(rowdata):
                b, s, params_rows, other = pair_vals(pair_i, value, rows)

                def one(params, *ov):
                    vals = list(ov)
                    vals[s] = value
                    return _cost_grad_hess_slot(b, params, tuple(vals), s, dtype)

                axes = (None if b.params is None else 0,) + (0,) * len(other)
                cc, gg, hh = jax.vmap(one, in_axes=axes)(params_rows, *other)
                total = total + jnp.sum(jnp.where(rmask, cc, 0))
                g = g + jnp.sum(jnp.where(rmask[:, None], gg, 0), axis=0)
                a = a + jnp.sum(jnp.where(rmask[:, None, None], hh, 0), axis=0)
            return total, (a, g)

        ctx = iterators.IterCtx(
            cost=cost_v,
            apply=lambda v, x: man.retract(v, x),
            dtype=dtype,
            dim=d,
        )
        final = run_loop(assemble_v, cost_v, ctx, opts, value0)
        return final["variables"], final["iternum"]

    values0 = fam_arrays[fam][np.asarray(target_indices)]
    solve_all = jax.jit(jax.vmap(solve_one))
    new_values, iters = solve_all(values0, row_data)
    return new_values, jnp.sum(iters)
