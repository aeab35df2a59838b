"""Problem definition: variable families + type-grouped cost batches.

Reference parity: src/problem.jl (``NLLSProblem``, ``addvariable!``,
``addcost!``, ``subproblem``) and src/VectorRepo.jl (the type-keyed cost
store).  The batched translation (SURVEY.md §7): variables of one manifold
family are stacked into a single ``[n, *shape]`` array, and costs of one
*type* — same residual function, same kernel, same dependent families, same
parameter structure — form a padded struct-of-arrays batch evaluated by a
single vmapped kernel.  The reference achieves type-stable homogeneous inner
loops with ``VectorRepo``'s ``Dict{DataType, Vector}``; here the grouping is
explicit and the "inner loop" is one fused XLA computation per batch.

Host-side (numpy) index bookkeeping happens once per problem build; the
resulting integer arrays are trace-time constants of the compiled solver.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import jax.numpy as jnp
import jax.tree_util as jtu

from .manifolds import Manifold
from .robust import AdaptiveRobustifier, NoRobust

#: Batch padding granularity.  Cost batches are padded to a multiple of this
#: so recompilation is avoided for small count changes and batch dims stay
#: friendly to lane tiling.
BATCH_ALIGN = 8


def family_name(manifold: Manifold) -> str:
    """Stable string key for a variable family (dict pytree keys must be
    orderable, so we key the variable dict by this rather than the manifold
    object itself)."""
    return repr(manifold)


@dataclasses.dataclass(frozen=True)
class VarHandle:
    """Reference to a single variable block: (family, index-within-family).
    Plays the role of the reference's integer index into
    ``problem.variables`` (src/problem.jl:114-122)."""

    manifold: Manifold
    index: int

    @property
    def family(self) -> str:
        return family_name(self.manifold)


class _Family:
    """Array-backed storage for all variables of one manifold family:
    a growable ``[n, *shape]`` numpy block (amortized O(1) appends), so
    BAL-scale problems avoid per-variable Python objects."""

    def __init__(self, manifold: Manifold, dtype):
        self.manifold = manifold
        self._buf = np.zeros((8,) + manifold.shape, dtype=dtype)
        self.n = 0

    def _reserve(self, extra: int):
        need = self.n + extra
        if need > self._buf.shape[0]:
            cap = max(need, 2 * self._buf.shape[0])
            new = np.zeros((cap,) + self._buf.shape[1:], dtype=self._buf.dtype)
            new[: self.n] = self._buf[: self.n]
            self._buf = new

    @property
    def values(self) -> np.ndarray:
        return self._buf[: self.n]

    def add(self, value) -> int:
        self._reserve(1)
        self._buf[self.n] = value
        self.n += 1
        return self.n - 1

    def add_many(self, values) -> int:
        k = values.shape[0]
        self._reserve(k)
        self._buf[self.n : self.n + k] = values
        first = self.n
        self.n += k
        return first


@dataclasses.dataclass
class _CostGroup:
    """Host-side accumulation of one cost type before finalization.

    Costs arrive either one at a time (``params``/``indices`` lists, the
    reference's ``addcost!`` path) or in bulk chunks of pre-stacked arrays
    (``chunks``) — the fast path for BAL-scale problems where a Python loop
    per observation would dominate setup time."""

    kind: str  # "residual" or "cost"
    fn: Callable
    kernel: Any
    families: tuple  # manifold per dependency slot
    params: list  # list of per-cost param pytrees
    indices: list  # list of per-cost tuples of variable indices
    jacobian: Any = None  # optional hand Jacobian fn (residual kind only)
    batched: bool = False  # fn/jacobian operate on whole [B, ...] batches
    chunks: list = dataclasses.field(default_factory=list)
    # each chunk: (params pytree of [k, ...] arrays or None, indices [k, nslots])

    def count(self) -> int:
        return len(self.indices) + sum(c[1].shape[0] for c in self.chunks)


def _group_key(kind, fn, kernel, families, params_struct, jacobian=None,
               batched=False):
    return (kind, fn, kernel, families, params_struct, jacobian, batched)


def _auto_cm_jacobian(fn, manifolds):
    """Synthesize a components-major ``jacobian(params, *vals_cm) ->
    (r [n, B], jac [n, S, B])`` for a cm-batched residual ``fn`` when no
    hand Jacobian is supplied: one ``jax.linearize`` of (fn ∘ retract_cm)
    at the zero tangent, then one linear (jvp) pass per tangent column —
    every cost's column-j derivative rides the same broadcast basis
    tangent, so the whole batch stays components-major with no vmap.  This
    is the reference's duals-through-``update`` autodiff (src/autodiff.jl)
    in the components-major layout; hand Jacobians remain cheaper (one
    pass instead of S) and take precedence."""
    import jax

    dofs = [m.dof for m in manifolds]

    def jac_fn(params, *vals_cm):
        b = vals_cm[0].shape[-1]
        dtype = vals_cm[0].dtype

        def g(*tangents):
            newv = tuple(
                m.retract_cm(v, t)
                for m, v, t in zip(manifolds, vals_cm, tangents)
            )
            return jnp.atleast_2d(fn(params, *newv))

        zeros = tuple(jnp.zeros((d, b), dtype) for d in dofs)
        r, lin = jax.linearize(g, *zeros)
        cols = []
        for slot, d in enumerate(dofs):
            for j in range(d):
                tans = [jnp.zeros_like(z) for z in zeros]
                tans[slot] = tans[slot].at[j].set(dtype.type(1))
                cols.append(lin(*tans))
        return r, jnp.stack(cols, axis=1)  # [n, S, B]

    return jac_fn


@dataclasses.dataclass
class CostBatch:
    """Finalized, padded struct-of-arrays batch of one cost type."""

    kind: str
    fn: Callable
    kernel: Any
    adaptive: bool
    manifolds: tuple  # per slot
    idx: tuple  # per slot: int32 [B_pad] indices into the family array
    params: Any  # pytree with [B_pad, ...] leaves
    mask: Any  # bool [B_pad]; False for padding
    n: int  # true cost count
    jacobian: Any = None  # optional hand Jacobian fn: (params, *vals) -> (r, J)
    batched: bool = False  # fn/jacobian take whole [B, ...] batches (no vmap)

    @property
    def n_padded(self) -> int:
        return int(self.idx[0].shape[0]) if self.idx else int(self.mask.shape[0])

    @property
    def block_dof(self) -> int:
        """Total tangent dimension of one cost's variable block (kernel slot
        included for adaptive costs)."""
        return sum(m.dof for m in self.manifolds)


class Problem:
    """User-facing problem container (reference ``NLLSProblem``).

    Usage::

        p = Problem()
        x = p.add_variable(Scalar(), 0.0)
        p.add_cost(lambda params, x: params * (1.0 - x), (x,), params=1.0)
        result = optimize(p)
    """

    def __init__(self, dtype=None):
        from .. import config

        self.dtype = dtype or config.default_dtype
        # family name -> _Family (array-backed stacked storage)
        self._families: dict = {}
        self._groups: dict = {}
        self._group_order: list = []
        self._dirty = True
        self._built = None
        # Bumped on structural changes (new variables/costs); value edits
        # keep the version so compiled solvers can be reused.
        self.structure_version = 0

    # -- variables ---------------------------------------------------------

    def _family(self, manifold: Manifold) -> "_Family":
        name = family_name(manifold)
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(manifold, self.dtype)
            self._families[name] = fam
        return fam

    def add_variable(self, manifold: Manifold, value) -> VarHandle:
        """Add a variable block; returns its handle
        (reference ``addvariable!``, src/problem.jl:114-122)."""
        fam = self._family(manifold)
        value = np.asarray(value, dtype=self.dtype)
        if value.shape != manifold.shape:
            raise ValueError(
                f"variable value shape {value.shape} != manifold shape {manifold.shape}"
            )
        self._dirty = True
        self.structure_version += 1
        return VarHandle(manifold, fam.add(value))

    def add_variables(self, manifold: Manifold, values) -> list:
        """Bulk-add ``k`` variables from a stacked ``[k, *shape]`` array;
        returns their handles (O(1) Python work per call)."""
        fam = self._family(manifold)
        values = np.asarray(values, dtype=self.dtype)
        if values.shape[1:] != manifold.shape:
            raise ValueError(
                f"stacked value shape {values.shape[1:]} != manifold shape "
                f"{manifold.shape}"
            )
        first = fam.add_many(values)
        self._dirty = True
        self.structure_version += 1
        return [VarHandle(manifold, first + i) for i in range(values.shape[0])]

    def num_variables(self) -> int:
        return sum(f.n for f in self._families.values())

    def __repr__(self):
        # Reference Base.show (src/problem.jl:27-30).
        fams = ", ".join(
            f"{name}×{fam.n}" for name, fam in self._families.items()
        )
        return (
            f"Problem({self.num_variables()} variables [{fams}], "
            f"{self.num_costs()} costs in {len(self._group_order)} type groups)"
        )

    def get_value(self, handle: VarHandle):
        # Copy: family storage is a shared array block and callers must not
        # observe later solver writes through a live view.
        return self._families[handle.family].values[handle.index].copy()

    def set_value(self, handle: VarHandle, value):
        fam = self._families[handle.family]
        fam.values[handle.index] = np.asarray(value, dtype=self.dtype)
        self._dirty = True

    def set_values(self, variables: dict):
        """Write back a solver-produced variables dict (family -> stacked
        array) into the host-side store."""
        for name, arr in variables.items():
            fam = self._families[name]
            fam.values[:] = np.asarray(arr)
        self._dirty = True

    # -- costs -------------------------------------------------------------

    def add_cost(
        self,
        fn: Callable,
        variables: tuple,
        params: Any = None,
        kernel: Any = None,
        kind: str = "residual",
        jacobian: Callable = None,
    ):
        """Add one cost block (reference ``addcost!``, src/problem.jl:90-107).

        ``fn(params, *values)`` must return the residual vector (``kind ==
        "residual"``; robustified as ½·ρ(‖r‖²)) or a scalar cost (``kind ==
        "cost"``, the reference's plain ``AbstractCost``; used as-is).

        For an adaptive kernel, pass ``kernel`` as an
        :class:`AdaptiveRobustifier` and make the *first* element of
        ``variables`` the kernel-parameter variable (reference convention:
        kernel is the first element of ``getvars``, src/residual.jl:46-47).
        ``fn`` receives only the non-kernel variables.

        ``jacobian(params, *values) -> (residual, J)`` optionally supplies a
        hand-written Jacobian in tangent coordinates (columns ordered by the
        non-kernel dependency slots) — the reference's ``computeresjac``
        override (src/docstrings.jl:220).

        Costs batch by ``fn`` IDENTITY (the analogue of the reference's
        by-concrete-type VectorRepo grouping): pass the SAME function object
        and vary ``params`` per cost.  A fresh lambda/closure per cost
        creates one single-cost batch each — one XLA program per cost
        instead of one vmapped program for all of them.
        """
        from .. import config

        variables = tuple(variables)
        if not variables:
            raise ValueError("a cost must depend on at least one variable")
        if len(variables) > config.MAX_ARGS:
            raise ValueError(f"at most {config.MAX_ARGS} variable blocks per cost")
        if kind not in ("residual", "cost"):
            raise ValueError(f"unknown cost kind {kind!r}")
        if kernel is None:
            kernel = NoRobust() if kind == "residual" else None
        adaptive = isinstance(kernel, AdaptiveRobustifier)
        if adaptive:
            if kind != "residual":
                raise ValueError("adaptive kernels only apply to residual costs")
            if variables[0].manifold != kernel.manifold:
                raise ValueError(
                    "first variable of an adaptive cost must live on the "
                    f"kernel's manifold {kernel.manifold}"
                )
        if kind == "cost" and kernel is not None and not adaptive:
            if not isinstance(kernel, NoRobust):
                raise ValueError("plain costs are not robustified")
            kernel = None
        for h in variables:
            fam = self._families.get(h.family)
            if fam is None or not (0 <= h.index < fam.n):
                raise ValueError(f"unknown variable handle {h}")

        families = tuple(h.manifold for h in variables)
        params_struct = jtu.tree_structure(params)
        key = _group_key(kind, fn, kernel, families, params_struct, jacobian)
        group = self._groups.get(key)
        if group is None:
            group = _CostGroup(kind, fn, kernel, families, [], [], jacobian)
            self._groups[key] = group
            self._group_order.append(key)
        group.params.append(params)
        group.indices.append(tuple(h.index for h in variables))
        self._dirty = True
        self.structure_version += 1

    def add_cost_batch(
        self,
        fn: Callable,
        slots: list,
        params: Any = None,
        kernel: Any = None,
        kind: str = "residual",
        jacobian: Callable = None,
        batched: bool = False,
    ):
        """Bulk-add ``k`` costs of one type in a single call.

        ``slots`` is a list of ``(manifold, index_array[k])`` pairs (one per
        dependency slot) and ``params`` a pytree whose leaves have leading
        dimension ``k``.  Semantically identical to ``k`` ``add_cost`` calls
        but O(1) Python work — the bulk ingestion path for BAL-scale
        problems (SURVEY.md §7 step 8).

        ``batched=True`` declares that ``fn`` (and ``jacobian``) take whole
        ``[k, ...]`` stacked arguments instead of being vmapped per cost —
        the performance escape hatch for hot residuals: scalar-expanded
        batch code avoids the tiny trailing dimensions of vmapped per-cost
        math."""
        from .. import config

        if not slots:
            raise ValueError("a cost must depend on at least one variable")
        if len(slots) > config.MAX_ARGS:
            raise ValueError(f"at most {config.MAX_ARGS} variable blocks per cost")
        manifolds = tuple(m for m, _ in slots)
        idx = np.stack(
            [np.asarray(i, dtype=np.int32) for _, i in slots], axis=1
        )  # [k, nslots]
        for (man, _), col in zip(slots, idx.T):
            name = family_name(man)
            fam = self._families.get(name)
            n = fam.n if fam is not None else 0
            if col.size and (col.min() < 0 or col.max() >= n):
                raise ValueError(f"variable index out of range for family {name}")
        if kernel is None:
            kernel = NoRobust() if kind == "residual" else None
        adaptive = isinstance(kernel, AdaptiveRobustifier)
        if adaptive and manifolds[0] != kernel.manifold:
            raise ValueError(
                "first slot of an adaptive cost must be the kernel variable"
            )
        if batched:
            if kind != "residual":
                raise ValueError(
                    "batched=True supports residual costs only"
                )
            if adaptive and batched != "cm":
                raise ValueError(
                    "adaptive kernels require batched='cm' (the kernel "
                    "slot is gathered components-major and its derivative "
                    "blocks ride rho_dkernel_cm)"
                )
            if jacobian is None and batched != "cm":
                # cm batches synthesize one at finalization
                # (_auto_cm_jacobian); row-major batched fns have no
                # generic tangent hookup.
                raise ValueError(
                    "batched=True requires a (batched) hand jacobian"
                )
        params_struct = jtu.tree_structure(None if params is None else 0)
        if params is not None:
            params_struct = jtu.tree_structure(
                jtu.tree_map(lambda l: 0, params)
            )
        key = _group_key(kind, fn, kernel, manifolds, params_struct, jacobian,
                         batched)
        group = self._groups.get(key)
        if group is None:
            group = _CostGroup(kind, fn, kernel, manifolds, [], [], jacobian,
                               batched)
            self._groups[key] = group
            self._group_order.append(key)
        group.chunks.append(
            (
                None
                if params is None
                else jtu.tree_map(np.asarray, params),
                idx,
            )
        )
        self._dirty = True
        self.structure_version += 1

    def num_costs(self) -> int:
        """Reference ``countcosts(costnum, ...)`` (src/problem.jl:201-207)."""
        return sum(g.count() for g in self._groups.values())

    # -- finalization ------------------------------------------------------

    def manifold_of(self, name: str) -> Manifold:
        return self._families[name].manifold

    def family_names(self):
        return list(self._families.keys())

    def stacked_variables(self) -> dict:
        """Variables as a dict of stacked jnp arrays (the solver state).
        Copies: on the CPU ``jnp.asarray`` may share the host store's
        memory, which :meth:`set_values` overwrites in place."""
        return {
            name: jnp.array(fam.values, dtype=self.dtype, copy=True)
            for name, fam in self._families.items()
        }

    def _group_stacked(self, g, want_params=True):
        """Stacked ``(indices [n, nslots], params pytree of [n, ...] or
        None)`` for one cost group: per-cost list entries followed by bulk
        chunks — the exact order ``batches()`` emits costs."""
        ind_parts = []
        if g.indices:
            ind_parts.append(np.array(g.indices, dtype=np.int32))
        ind_parts.extend(ci for _, ci in g.chunks)
        ind = (
            np.concatenate(ind_parts)
            if ind_parts
            else np.zeros((0, len(g.families)), np.int32)
        )  # [n, nslots]
        if not want_params:
            return ind, None
        param_parts = []
        if g.params and g.params[0] is not None:
            param_parts.append(
                jtu.tree_map(
                    lambda *ls: np.stack([np.asarray(l) for l in ls]),
                    *g.params,
                )
            )
        param_parts.extend(cp for cp, _ in g.chunks if cp is not None)
        params = (
            jtu.tree_map(
                lambda *ls: np.concatenate([np.asarray(l) for l in ls]),
                *param_parts,
            )
            if param_parts
            else None
        )
        return ind, params

    def batches(self) -> list:
        """Finalize cost groups into padded CostBatch objects."""
        out = []
        for key in self._group_order:
            g = self._groups[key]
            ind, raw_params = self._group_stacked(g)
            n = ind.shape[0]
            n_pad = -(-n // BATCH_ALIGN) * BATCH_ALIGN
            idx_arr = np.zeros((len(g.families), n_pad), dtype=np.int32)
            idx_arr[:, :n] = ind.T
            mask = np.zeros(n_pad, dtype=bool)
            mask[:n] = True

            def pad_leaf(arr):
                arr = np.asarray(arr)
                if np.issubdtype(arr.dtype, np.floating):
                    # Keep all float params in the problem dtype so f32
                    # problems stay f32 end to end.
                    arr = arr.astype(self.dtype)
                padded = np.zeros((n_pad,) + arr.shape[1:], dtype=arr.dtype)
                padded[:n] = arr
                # Host numpy: becomes a trace-time constant; creating device
                # arrays here would force per-array transfers at build time.
                return padded

            params = (
                jtu.tree_map(pad_leaf, raw_params)
                if raw_params is not None
                else None
            )
            out.append(
                CostBatch(
                    kind=g.kind,
                    fn=g.fn,
                    kernel=g.kernel,
                    adaptive=isinstance(g.kernel, AdaptiveRobustifier),
                    manifolds=g.families,
                    idx=tuple(idx_arr[i] for i in range(len(g.families))),
                    params=params,
                    mask=mask,
                    n=n,
                    jacobian=(
                        g.jacobian
                        if g.jacobian is not None or g.batched != "cm"
                        # Adaptive cm residuals: fn takes the NON-kernel
                        # slots; the kernel's derivative blocks come from
                        # rho_dkernel_cm, not the residual Jacobian.
                        else _auto_cm_jacobian(
                            g.fn,
                            g.families[1:]
                            if isinstance(g.kernel, AdaptiveRobustifier)
                            else g.families,
                        )
                    ),
                    batched=g.batched,
                )
            )
        return out

    def subproblem(self, predicate) -> "Problem":
        """New problem sharing this problem's variables but keeping only the
        costs selected by ``predicate`` (reference ``subproblem``,
        src/problem.jl:47-83).  ``predicate`` is either a callable
        ``(slot_handles) -> bool``, a single :class:`VarHandle` (keep costs
        touching it — the reference's integer form), or an iterable of
        handles.

        Handle/iterable predicates select via numpy masks over the stacked
        index arrays — O(total incidence) with no per-cost Python, so a
        BAL-scale (millions of observations) subproblem builds in well under
        a second.  A callable predicate is evaluated per cost.  Selected
        costs keep their group's hand ``jacobian`` and ``batched`` layout."""
        targets = None
        if not callable(predicate):
            handles = (
                [predicate] if isinstance(predicate, VarHandle) else list(predicate)
            )
            targets = {}
            for h in handles:
                targets.setdefault(h.family, []).append(h.index)
            targets = {
                f: np.unique(np.asarray(ix, dtype=np.int64))
                for f, ix in targets.items()
            }

        sub = Problem(dtype=self.dtype)
        sub._families = self._families  # shared, as in the reference
        for key in self._group_order:
            g = self._groups[key]
            ind, params = self._group_stacked(g)
            n = ind.shape[0]
            if n == 0:
                continue
            sel = self._select_rows(g, ind, predicate, targets)
            if not sel.any():
                continue
            ind_sel = ind[sel]
            params_sel = (
                None
                if params is None
                else jtu.tree_map(lambda l: l[sel], params)
            )
            sub.add_cost_batch(
                g.fn,
                [(man, ind_sel[:, s]) for s, man in enumerate(g.families)],
                params=params_sel,
                kernel=g.kernel,
                kind=g.kind,
                jacobian=g.jacobian,
                batched=g.batched,
            )
        return sub

    @staticmethod
    def _normalize_predicate(predicate):
        """Handle/iterable predicates → per-family sorted index arrays
        (``targets``); callables pass through as ``(predicate, None)``."""
        if callable(predicate):
            return predicate, None
        handles = (
            [predicate] if isinstance(predicate, VarHandle) else list(predicate)
        )
        targets = {}
        for h in handles:
            targets.setdefault(h.family, []).append(h.index)
        return None, {
            f: np.unique(np.asarray(ix, dtype=np.int64))
            for f, ix in targets.items()
        }

    @staticmethod
    def _select_rows(g, ind, predicate, targets):
        """Boolean selection over one group's ``n`` real costs: vectorized
        numpy for handle targets, per-cost evaluation for callables."""
        n = ind.shape[0]
        if targets is not None:
            sel = np.zeros(n, dtype=bool)
            for s, man in enumerate(g.families):
                t = targets.get(family_name(man))
                if t is not None:
                    sel |= np.isin(ind[:, s], t)
            return sel
        return np.fromiter(
            (
                bool(
                    predicate(
                        tuple(
                            VarHandle(man, int(i))
                            for man, i in zip(g.families, row)
                        )
                    )
                )
                for row in ind
            ),
            dtype=bool,
            count=n,
        )

    def subset_masks(self, predicate) -> list:
        """Per-batch boolean masks (aligned with :meth:`batches`, padded to
        the same lengths) selecting the costs ``predicate`` keeps — the
        runtime-valued half of the reference's in-place ``subproblem!``
        (src/problem.jl:47-83): the batch SHAPES are those of the full
        problem, so a jitted program taking these masks as arguments swaps
        cost subsets with zero recompilation (see
        :class:`nllstpu.core.optimize.SubproblemView`).  Accepts the same
        predicate forms as :meth:`subproblem`."""
        predicate, targets = self._normalize_predicate(predicate)
        masks = []
        for key in self._group_order:
            g = self._groups[key]
            ind, _ = self._group_stacked(g, want_params=False)
            n = ind.shape[0]
            n_pad = -(-n // BATCH_ALIGN) * BATCH_ALIGN  # as in batches()
            m = np.zeros(n_pad, dtype=bool)
            if n:
                m[:n] = self._select_rows(g, ind, predicate, targets)
            masks.append(m)
        return masks

    def varcostmap(self) -> dict:
        """Full variable-cost incidence (reference ``updatevarcostmap!`` /
        ``getvarcostmap``, src/problem.jl:124-175) in COO form: per family, a
        ``(var_idx, cost_id)`` pair of int64 arrays, with cost ids global
        across the problem in the exact order ``batches()`` emits costs
        (group order; singly-added costs before bulk chunks within a group).
        Built with vectorized numpy — O(total incidence), no per-cost
        Python.  The transposed view (costs touching each variable) is a
        ``bincount``/argsort away, which is how ``var_cost_counts`` and the
        per-variable subsets of ``optimize_singles`` use it."""
        rows = {name: [] for name in self._families}
        cols = {name: [] for name in self._families}
        base = 0
        for key in self._group_order:
            g = self._groups[key]
            ind, _ = self._group_stacked(g, want_params=False)
            n = ind.shape[0]
            cost_ids = base + np.arange(n, dtype=np.int64)
            for s, man in enumerate(g.families):
                name = family_name(man)
                rows[name].append(ind[:, s].astype(np.int64))
                cols[name].append(cost_ids)
            base += n
        out = {}
        for name in self._families:
            out[name] = (
                np.concatenate(rows[name]) if rows[name] else np.zeros(0, np.int64),
                np.concatenate(cols[name]) if cols[name] else np.zeros(0, np.int64),
            )
        return out

    def var_cost_counts(self) -> dict:
        """Per-family array counting how many costs touch each variable — the
        row sums of the reference's ``varcostmap`` incidence matrix
        (src/problem.jl:124-168)."""
        coo = self.varcostmap()
        return {
            name: np.bincount(coo[name][0], minlength=fam.n).astype(np.int64)
            for name, fam in self._families.items()
        }
