"""Cost / gradient / Hessian engine: vmapped per-type batches + scatter
assembly of the normal equations.

Reference parity: src/cost.jl (``cost``, ``costgradhess!``), src/residual.jl
lines 43-111 (robustified Gauss-Newton composition: g = Jᵀr, H = JᵀJ, IRLS
reweighting by ρ′, second-order correction 2ρ″ggᵀ, adaptive-kernel cross
blocks) and src/linearsystem.jl lines 132-175 (scatter-add of per-cost blocks
into the symmetric system).

Design (SURVEY.md §7):

* Jacobians come from ``jax.jacfwd`` of ``residual ∘ retract`` at the zero
  tangent — equivalent to the reference pushing ForwardDiff duals through the
  manifold ``update`` (src/autodiff.jl:57-93), but batched: one traced
  function per cost *type*, vmapped over the whole padded batch.
* The reference's per-cost ``varflags`` static specialization (fixed variables
  contribute nothing, src/cost.jl:27-52) becomes a *dustbin scatter*: the
  global tangent vector is padded by ``layout.pad`` extra rows and fixed /
  padding blocks scatter their contributions there, to be sliced off.  This
  keeps every batch a single fixed-shape XLA computation — no data-dependent
  control flow.
* Assembly is one ``scatter-add`` per batch into the dense padded system (the
  block-sparse/Schur paths reuse the same per-batch block computation).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from .manifolds import Manifold
from .problem import CostBatch, Problem, VarHandle, family_name


@dataclasses.dataclass
class Layout:
    """Tangent-space layout of the unfixed variables.

    ``offsets[name][i]`` is the offset of variable ``i`` of family ``name``
    in the global tangent/step vector, or ``dof_total`` (the dustbin) when the
    variable is fixed.  Plays the role of the reference's block index/offset
    assignment in ``makesymmvls`` (src/linearsystem.jl:93-102).
    """

    offsets: dict  # family name -> jnp int32 [n]
    unfixed: dict  # family name -> numpy bool [n]
    dof_total: int
    pad: int

    @property
    def padded_size(self) -> int:
        return self.dof_total + self.pad


def resolve_unfixed(problem: Problem, unfixed) -> dict:
    """Normalize the ``unfixed`` spec into per-family boolean masks
    (reference ``convertunfixed``, src/optimize.jl:19-22).  Accepts ``None``
    (all free), a :class:`Manifold` (that family only), a single
    :class:`VarHandle`, an iterable of handles, or a dict of masks."""
    masks = {
        name: np.zeros(fam.n, dtype=bool)
        for name, fam in problem._families.items()
    }
    if unfixed is None:
        for m in masks.values():
            m[:] = True
    elif isinstance(unfixed, Manifold):
        masks[family_name(unfixed)][:] = True
    elif isinstance(unfixed, VarHandle):
        masks[unfixed.family][unfixed.index] = True
    elif isinstance(unfixed, dict):
        for name, m in unfixed.items():
            masks[name][:] = np.asarray(m, dtype=bool)
    else:
        for h in unfixed:
            masks[h.family][h.index] = True
    return masks


def build_layout(problem: Problem, unfixed=None, batches=None, order_last=None,
                 order_key=None) -> Layout:
    """``order_last`` (a family name) forces that family's tangent block to
    the end of the global vector — the Schur solver requires the eliminated
    family to occupy the trailing block so the reduced/eliminated split is a
    contiguous slice.

    ``order_key`` optionally maps a family name to a per-variable sort key
    array: that family's unfixed variables are laid out in DESCENDING key
    order (stable) instead of index order.  The Schur backend uses this to
    relabel eliminated variables by observation count so skewed (real-BAL)
    degree distributions become contiguous run-length buckets — the layout
    is the single source of truth for the id order, so every downstream
    consumer (elim_ids, W columns, step slices) stays consistent for free."""
    masks = resolve_unfixed(problem, unfixed)
    offsets = {}
    running = 0
    names = problem.family_names()
    if order_last is not None:
        names = [n for n in names if n != order_last] + [order_last]
    for name in names:
        man = problem.manifold_of(name)
        mask = np.asarray(masks[name], dtype=bool)
        key = None if order_key is None else order_key.get(name)
        if key is not None:
            # Descending-key stable order among the unfixed variables.
            order = np.argsort(-np.asarray(key), kind="stable")
            order = order[mask[order]]  # unfixed only, in key order
            off = np.full(mask.shape[0], -1, dtype=np.int32)
            off[order] = running + np.arange(order.shape[0], dtype=np.int32) * man.dof
            running += int(order.shape[0]) * man.dof
            offsets[name] = off
            continue
        # Vectorized offset assignment: a per-variable Python loop costs
        # seconds of pure host time per compile at BAL scale (1M landmarks).
        rank = np.cumsum(mask) - 1  # rank of each free var within family
        off = np.where(mask, running + rank * man.dof, -1).astype(np.int32)
        running += int(mask.sum()) * man.dof
        offsets[name] = off
    dof_total = running
    pad = 1
    for name in names:
        pad = max(pad, problem.manifold_of(name).dof)
    if batches is None:
        batches = problem.batches()
    for b in batches:
        pad = max(pad, b.block_dof)
    for name, off in offsets.items():
        off[off < 0] = dof_total
    return Layout(offsets=offsets, unfixed=masks, dof_total=dof_total, pad=pad)


# ---------------------------------------------------------------------------
# Per-cost math (traced once per cost type, vmapped over the batch)
# ---------------------------------------------------------------------------


def _split_tangent(t, manifolds):
    parts = []
    start = 0
    for m in manifolds:
        parts.append(t[start : start + m.dof])
        start += m.dof
    return tuple(parts)


def _residual_fn(batch: CostBatch, params, vals):
    """Residual as a function of the concatenated tangent of the non-kernel
    dependency slots, plus the values/manifolds it closes over."""
    manifolds = batch.manifolds[1:] if batch.adaptive else batch.manifolds
    rvals = vals[1:] if batch.adaptive else vals

    def f(t):
        parts = _split_tangent(t, manifolds)
        newv = tuple(
            m.retract(v, dt) for m, v, dt in zip(manifolds, rvals, parts)
        )
        return jnp.atleast_1d(batch.fn(params, *newv))

    dof = sum(m.dof for m in manifolds)
    return f, dof


def _cost_value_one(batch: CostBatch, params, vals):
    """Cost of a single block (reference ``computecost``,
    src/residual.jl:44-55 for residuals; user value for plain costs)."""
    if batch.kind == "cost":
        return batch.fn(params, *vals)
    r = jnp.atleast_1d(batch.fn(params, *(vals[1:] if batch.adaptive else vals)))
    s = jnp.dot(r, r)
    if batch.adaptive:
        return 0.5 * batch.kernel.rho(vals[0], s)
    return 0.5 * batch.kernel.rho(s)


def _cost_grad_hess_one(batch: CostBatch, params, vals, dtype):
    """(cost, g, H) of a single cost block over its concatenated block
    tangent (kernel slot first for adaptive costs) — reference
    ``computecostgradhess`` (src/residual.jl:45-47, 57-111) and the plain-cost
    Hessian path (src/autodiff.jl:144-159)."""
    if batch.kind == "cost":
        manifolds = batch.manifolds

        def f(t):
            parts = _split_tangent(t, manifolds)
            newv = tuple(
                m.retract(v, dt) for m, v, dt in zip(manifolds, vals, parts)
            )
            return batch.fn(params, *newv)

        dof = sum(m.dof for m in manifolds)
        z = jnp.zeros(dof, dtype=dtype)
        val = f(z)
        g = jax.grad(f)(z)
        h = jax.jacfwd(jax.grad(f))(z)
        return val, g, h

    f, dof = _residual_fn(batch, params, vals)
    z = jnp.zeros(dof, dtype=dtype)
    r = f(z)
    if getattr(batch, "jacobian", None) is not None:
        # User-supplied hand Jacobian in tangent coordinates (reference
        # ``computeresjac`` override, src/docstrings.jl:220).
        rvals = vals[1:] if batch.adaptive else vals
        r, jac = batch.jacobian(params, *rvals)
        r = jnp.atleast_1d(r)
        jac = jnp.atleast_2d(jac)
    else:
        # Forward mode only: jacrev returns silently wrong values inside
        # shard_map in this JAX version (verified empirically).
        jac = jax.jacfwd(f)(z)  # [nres, dof]
    s = jnp.dot(r, r)
    g = jac.T @ r
    h = jac.T @ jac

    if not batch.adaptive:
        rho, d1, d2 = batch.kernel.rho_dc(s)
        # IRLS reweighting + second-order correction (src/residual.jl:90-101).
        h = h * d1 + (2.0 * d2) * jnp.outer(g, g)
        g = g * d1
        return 0.5 * rho, g, h

    kparams = vals[0]
    k = batch.kernel.manifold.dof
    rho, dgrad, dhess = batch.kernel.rho_dkernel(kparams, s)
    d1 = dgrad[k]
    d2 = dhess[k, k]
    # d²/dkernel·dvariables cross block (src/residual.jl:85-88) — note it uses
    # the *unweighted* Gauss-Newton gradient, as the reference does.
    dkdv = jnp.outer(g, dhess[:k, k])  # [dof, k]
    h = h * d1 + (2.0 * d2) * jnp.outer(g, g)
    g = g * d1
    # Kernel blocks are prepended unhalved, exactly as the reference
    # (src/residual.jl:103-107).
    g_full = jnp.concatenate([dgrad[:k], g])
    h_full = jnp.block([[dhess[:k, :k], dkdv.T], [dkdv, h]])
    return 0.5 * rho, g_full, h_full


def _cost_grad_hess_slot(batch: CostBatch, params, vals, slot: int, dtype):
    """(cost, g, H) restricted to the tangent of dependency slot ``slot``
    only, all other slots held fixed — the per-variable alternation path
    (reference univariate systems, src/linearsystem.jl:11-34, where only the
    target variable's ``varflags`` bit is set)."""
    man = batch.manifolds[slot]

    if batch.kind == "cost":

        def f(t):
            newv = list(vals)
            newv[slot] = man.retract(vals[slot], t)
            return batch.fn(params, *newv)

        z = jnp.zeros(man.dof, dtype=dtype)
        return f(z), jax.grad(f)(z), jax.jacfwd(jax.grad(f))(z)

    if batch.adaptive and slot == 0:
        # Only the kernel is optimized (src/residual.jl:59-66).
        r = jnp.atleast_1d(batch.fn(params, *vals[1:]))
        s = jnp.dot(r, r)
        rho, dgrad, dhess = batch.kernel.rho_dkernel(vals[0], s)
        k = batch.kernel.manifold.dof
        return 0.5 * rho, dgrad[:k], dhess[:k, :k]

    def f(t):
        newv = list(vals)
        newv[slot] = man.retract(vals[slot], t)
        rv = newv[1:] if batch.adaptive else newv
        return jnp.atleast_1d(batch.fn(params, *rv))

    z = jnp.zeros(man.dof, dtype=dtype)
    r = f(z)
    jac = jax.jacfwd(f)(z)
    s = jnp.dot(r, r)
    g = jac.T @ r
    h = jac.T @ jac
    if batch.adaptive:
        rho, d1, d2 = batch.kernel.rho_dc(vals[0], s)
    else:
        rho, d1, d2 = batch.kernel.rho_dc(s)
    h = h * d1 + (2.0 * d2) * jnp.outer(g, g)
    g = g * d1
    return 0.5 * rho, g, h


# ---------------------------------------------------------------------------
# Batched evaluation
# ---------------------------------------------------------------------------


def _gather_vals(batch: CostBatch, variables: dict):
    """Per-slot stacked variable values for every cost in the batch."""
    arrs = [variables[family_name(m)] for m in batch.manifolds]
    return tuple(arr[idx] for arr, idx in zip(arrs, batch.idx))


def _gather_vals_cm(batch: CostBatch, variables: dict, runs=None):
    """Components-major gathers: per slot ``[ambient, B]``.  Gathering from
    a transposed ``[ambient, n]`` family array puts the batch on the lane
    dimension, so the whole residual computation runs on contiguous [B]
    vectors instead of arrays with tiny trailing dims.

    ``runs = (slot, buckets)`` marks an obs-major batch (column
    ``col_base + (l − l_base)·k + j`` = the j-th cost of landmark ``l`` in
    that bucket, ops/schur.obs_major_repack; uniform problems have one
    bucket): slot ``slot`` is then gathered once per landmark ([ambient,
    L_b] per bucket) and broadcast over the run — replacing a B-wide lane
    gather with a run-count-wide one plus a free broadcast.  Masked pad
    slots inside a run receive the run's landmark value instead of the
    row-0 copy the plain gather yields; every consumer zeroes masked
    contributions (d1/d2/mask), so only dead values change."""
    out = []
    for slot_i, (m, idx) in enumerate(zip(batch.manifolds, batch.idx)):
        arr = variables[family_name(m)]
        flat = arr.reshape(arr.shape[0], -1).T  # [ambient, n] — n is small
        if runs is not None and slot_i == runs[0]:
            amb = flat.shape[0]
            parts = []
            pos = 0
            for (l0, lb, kb, c0) in runs[1]:
                if c0 > pos:  # gap between bucket regions: plain gather
                    parts.append(flat[:, idx[pos:c0]])
                head = flat[:, idx[c0 : c0 + lb * kb : kb]]  # [ambient, L_b]
                parts.append(
                    jnp.broadcast_to(
                        head[:, :, None], (amb, lb, kb)
                    ).reshape(amb, lb * kb)
                )
                pos = c0 + lb * kb
            if idx.shape[0] > pos:
                parts.append(flat[:, idx[pos:]])
            out.append(parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=1))
        else:
            out.append(flat[:, idx])
    return tuple(out)


def batch_cost(batch: CostBatch, variables: dict, dtype, runs=None) -> jnp.ndarray:
    """Masked total cost of one batch (reference type-grouped ``sum``,
    src/VectorRepo.jl:63-69 + src/cost.jl:10-13)."""
    if batch.batched == "cm":
        # Components-major whole-batch residual: fn gets [ambient, B] slots
        # and returns [nres, B].  Adaptive kernels take slot 0 (the kernel
        # parameters, gathered cm) as rho's first argument — all built-in
        # kernels are elementwise in s, so [ambient, B] params vectorize.
        gath = _gather_vals_cm(batch, variables, runs=runs)
        rvals = gath[1:] if batch.adaptive else gath
        r = batch.fn(batch.params, *rvals)
        sq = jnp.sum(r * r, axis=0)
        if batch.adaptive:
            costs = 0.5 * batch.kernel.rho(gath[0], sq)
        else:
            costs = 0.5 * batch.kernel.rho(sq)
        return jnp.sum(jnp.where(batch.mask, costs, jnp.zeros_like(costs)))
    vals = _gather_vals(batch, variables)
    if batch.batched:
        # Whole-batch residual function: [B]-major scalar-expanded math, no
        # vmap (no arrays with tiny trailing dims).
        r = batch.fn(batch.params, *vals)
        sq = jnp.sum(r * r, axis=-1)
        costs = 0.5 * batch.kernel.rho(sq)
        return jnp.sum(jnp.where(batch.mask, costs, jnp.zeros_like(costs)))

    def one(params, *vals_one):
        return _cost_value_one(batch, params, vals_one)

    in_axes = (None if batch.params is None else 0,) + (0,) * len(vals)
    costs = jax.vmap(one, in_axes=in_axes)(batch.params, *vals)
    return jnp.sum(jnp.where(batch.mask, costs, jnp.zeros_like(costs)))


def total_cost(batches, variables: dict, dtype, runs_list=None) -> jnp.ndarray:
    total = jnp.zeros((), dtype=dtype)
    for bi, b in enumerate(batches):
        runs = runs_list[bi] if runs_list else None
        total = total + batch_cost(b, variables, dtype, runs=runs)
    return total


def batch_grad_hess(batch: CostBatch, variables: dict, layout: Layout, dtype):
    """(masked cost sum, g [B,S], H [B,S,S], rows [B,S]) for one batch.

    ``rows`` are global tangent row indices; fixed variables and padding
    costs point at the dustbin (``layout.dof_total`` onwards)."""
    if batch.batched == "cm" and batch.adaptive:
        c, g_cm, h_cm, rows = batch_grad_hess_cm(
            batch, variables, layout, dtype
        )
        return c, g_cm.T, jnp.moveaxis(h_cm, -1, 0), rows
    vals = _gather_vals(batch, variables)

    if batch.batched == "cm":
        gath = _gather_vals_cm(batch, variables)
        r, jac = batch.jacobian(batch.params, *gath)  # [n,B], [n,S,B]
        sq = jnp.sum(r * r, axis=0)
        g = jnp.einsum("nsb,nb->bs", jac, r)
        h = jnp.einsum("nsb,ntb->bst", jac, jac, precision="highest")
        rho, d1, d2 = batch.kernel.rho_dc(sq)
        h = h * d1[:, None, None] + (2.0 * d2)[:, None, None] * (
            g[:, :, None] * g[:, None, :]
        )
        g = g * d1[:, None]
        costs = 0.5 * rho
    elif batch.batched:
        # Whole-batch residual+jacobian with IRLS composition vectorized
        # over [B] (see add_cost_batch(batched=True)).
        r, jac = batch.jacobian(batch.params, *vals)  # [B,n], [B,n,S]
        sq = jnp.sum(r * r, axis=-1)
        g = jnp.einsum("bns,bn->bs", jac, r)
        h = jnp.einsum("bns,bnt->bst", jac, jac, precision="highest")
        rho, d1, d2 = batch.kernel.rho_dc(sq)
        h = h * d1[:, None, None] + (2.0 * d2)[:, None, None] * (
            g[:, :, None] * g[:, None, :]
        )
        g = g * d1[:, None]
        costs = 0.5 * rho
    else:
        def one(params, *vals_one):
            return _cost_grad_hess_one(batch, params, vals_one, dtype)

        in_axes = (None if batch.params is None else 0,) + (0,) * len(vals)
        costs, g, h = jax.vmap(one, in_axes=in_axes)(batch.params, *vals)

    rows = _batch_rows(batch, layout)
    cost_sum = jnp.sum(jnp.where(batch.mask, costs, jnp.zeros_like(costs)))
    return cost_sum, g, h, rows


def _batch_rows(batch: CostBatch, layout: Layout):
    """[B, S] global tangent row per block column: per-slot tangent offsets
    gathered from the layout, with masked (padding) costs redirected
    wholesale to the dustbin.  Slot order matches the g/H block layout from
    ``_cost_grad_hess_one``: for adaptive costs the kernel is slot 0 and its
    tangent dims come first."""
    dustbin = jnp.int32(layout.dof_total)
    row_parts = []
    for slot in range(len(batch.manifolds)):
        man = batch.manifolds[slot]
        # offsets are host numpy; batch.idx may be traced (shard_map), so
        # lift to jnp before indexing.
        off = jnp.asarray(layout.offsets[family_name(man)])[batch.idx[slot]]  # [B]
        off = jnp.where(batch.mask, off, dustbin)
        row_parts.append(off[:, None] + jnp.arange(man.dof, dtype=jnp.int32)[None, :])
    return jnp.concatenate(row_parts, axis=1)  # [B, S]


def batch_grad_hess_cm(batch: CostBatch, variables: dict, layout: Layout, dtype):
    """Components-major variant of :func:`batch_grad_hess`:
    (masked cost sum, g [S, B], H [S, S, B], rows [B, S]).

    [S, S, B] keeps the long batch axis minor, so every reduction over the
    batch reads contiguous memory; the [B, S, S] layout puts the tiny
    (S, S) dims last.  (Time an assemble with its outputs used: an unused
    Hessian is dead-code eliminated.)  Only ``batched='cm'`` batches compute
    natively in this layout; others fall back to the batch-major math and
    transpose once at the boundary (small batches by construction)."""
    if batch.batched == "cm":
        gath = _gather_vals_cm(batch, variables)
        if batch.adaptive:
            # Adaptive robustified composition, components-major: kernel
            # blocks prepended UNHALVED with the unweighted-gradient cross
            # block — exact mirror of _cost_grad_hess_one (reference
            # src/residual.jl:57-111), vectorized over the lane axis.
            r, jac = batch.jacobian(batch.params, *gath[1:])
            sq = jnp.sum(r * r, axis=0)
            g0 = jnp.einsum("nsb,nb->sb", jac, r)
            h0 = jnp.einsum("nsb,ntb->stb", jac, jac, precision="highest")
            rho, dgrad, dhess = batch.kernel.rho_dkernel_cm(gath[0], sq)
            k = batch.kernel.manifold.dof
            d1 = dgrad[k]
            d2 = dhess[k, k]
            dkdv = g0[:, None, :] * dhess[None, :k, k, :]  # [S_res, k, B]
            h = h0 * d1[None, None, :] + (2.0 * d2)[None, None, :] * (
                g0[:, None, :] * g0[None, :, :]
            )
            g = g0 * d1[None, :]
            g_full = jnp.concatenate([dgrad[:k], g], axis=0)
            top = jnp.concatenate(
                [dhess[:k, :k], jnp.moveaxis(dkdv, 0, 1)], axis=1
            )  # [k, k+S_res, B]
            bot = jnp.concatenate([dkdv, h], axis=1)  # [S_res, k+S_res, B]
            h_full = jnp.concatenate([top, bot], axis=0)
            costs = 0.5 * rho
            cost_sum = jnp.sum(
                jnp.where(batch.mask, costs, jnp.zeros_like(costs))
            )
            rows = _batch_rows(batch, layout)
            return cost_sum, g_full, h_full, rows
        r, jac = batch.jacobian(batch.params, *gath)  # [n,B], [n,S,B]
        sq = jnp.sum(r * r, axis=0)
        g = jnp.einsum("nsb,nb->sb", jac, r)
        h = jnp.einsum("nsb,ntb->stb", jac, jac, precision="highest")
        rho, d1, d2 = batch.kernel.rho_dc(sq)
        h = h * d1[None, None, :] + (2.0 * d2)[None, None, :] * (
            g[:, None, :] * g[None, :, :]
        )
        g = g * d1[None, :]
        costs = 0.5 * rho
        cost_sum = jnp.sum(
            jnp.where(batch.mask, costs, jnp.zeros_like(costs))
        )
        rows = _batch_rows(batch, layout)
        return cost_sum, g, h, rows
    cost_sum, g, h, rows = batch_grad_hess(batch, variables, layout, dtype)
    return cost_sum, g.T, jnp.moveaxis(h, 0, -1), rows


def batch_res_jac_cm(batch: CostBatch, variables: dict, dtype, runs=None):
    """Raw components-major residual data of a ``batched='cm'`` batch:
    ``(cost_sum, r [n, B], jac [n, S, B], g0 [S, B], d1 [B], d2 [B], kern)``
    with ``g0 = Jᵀr`` unweighted over the NON-KERNEL tangent dims and
    (d1, d2) = (ρ′, ρ″).  Consumers compose the robustified blocks
    themselves — per OUTPUT, fused into its reduction — instead of
    materializing the shared [S, S, B] per-cost Hessian (60MB of
    (8,128)-padded tiles at 105k observations; profiled as a dominant
    assembly cost).

    ``kern`` is None for plain kernels; for adaptive batches it is
    ``(dgrad [k+1, B], dhess [k+1, k+1, B])`` from ``rho_dkernel_cm`` —
    the kernel diag/grad/cross blocks the consumer must place (reference
    src/residual.jl:103-107 layout: kernel dims first, unhalved).
    Returns None for non-cm batches."""
    if batch.batched != "cm":
        return None
    gath = _gather_vals_cm(batch, variables, runs=runs)
    if batch.adaptive:
        r, jac = batch.jacobian(batch.params, *gath[1:])
        sq = jnp.sum(r * r, axis=0)
        rho, dgrad, dhess = batch.kernel.rho_dkernel_cm(gath[0], sq)
        k = batch.kernel.manifold.dof
        g0 = jnp.einsum("nsb,nb->sb", jac, r)
        costs = 0.5 * rho
        cost_sum = jnp.sum(
            jnp.where(batch.mask, costs, jnp.zeros_like(costs))
        )
        return cost_sum, r, jac, g0, dgrad[k], dhess[k, k], (dgrad, dhess)
    r, jac = batch.jacobian(batch.params, *gath)  # [n,B], [n,S,B]
    sq = jnp.sum(r * r, axis=0)
    rho, d1, d2 = batch.kernel.rho_dc(sq)
    g0 = jnp.einsum("nsb,nb->sb", jac, r)
    costs = 0.5 * rho
    cost_sum = jnp.sum(jnp.where(batch.mask, costs, jnp.zeros_like(costs)))
    return cost_sum, r, jac, g0, d1, d2, None


def assemble_dense(batches, variables: dict, layout: Layout, dtype):
    """Dense symmetric normal equations (cost, H [D,D], g [D]) — the
    MultiVariateLSdense path (src/linearsystem.jl:73-87, 132-175), built with
    one scatter-add per cost type."""
    size = layout.padded_size
    a = jnp.zeros((size, size), dtype=dtype)
    b = jnp.zeros(size, dtype=dtype)
    total = jnp.zeros((), dtype=dtype)
    for batch in batches:
        c, g, h, rows = batch_grad_hess(batch, variables, layout, dtype)
        a = a.at[rows[:, :, None], rows[:, None, :]].add(h)
        b = b.at[rows].add(g)
        total = total + c
    d = layout.dof_total
    return total, a[:d, :d], b[:d]


def apply_step(problem_manifolds: dict, layout: Layout, variables: dict, x):
    """Retract every family by its slice of the step vector ``x`` [D]
    (reference ``update!``, src/linearsystem.jl:206-218).  Fixed variables
    read zeros from the pad region, so ``retract(x, 0) = x`` leaves them
    untouched."""
    xpad = jnp.concatenate([x, jnp.zeros(layout.pad, dtype=x.dtype)])
    out = {}
    for name, arr in variables.items():
        man = problem_manifolds[name]
        off = layout.offsets[name]  # [n]
        deltas = xpad[off[:, None] + jnp.arange(man.dof, dtype=jnp.int32)[None, :]]
        out[name] = jax.vmap(man.retract)(arr, deltas)
    return out
