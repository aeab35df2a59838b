"""Landmark-sharded distributed Schur solve: the reduced system assembled
and eliminated across the device mesh.

The basic data-parallel path (:mod:`nllstpu.parallel.mesh`) shards costs
arbitrarily and ``psum``s the *whole* assembled system — including the dense
W coupling ([dl, L, Dr], by far the largest buffer) — so every device holds
and reduces the full W and the elimination work is replicated.  This module
is the scaling design the reference cannot express (it is single-threaded,
SURVEY.md §5; no distributed machinery anywhere):

* Landmarks are partitioned into ``n`` contiguous chunks; every cost is
  routed to the device owning its landmark, so each device assembles a
  **complete, local** ``h_ll / g_l / W`` for its own landmarks — these are
  never communicated.
* The reduced (camera) system is formed by a ``psum`` of the per-device
  partial Schur corrections ``Σ_l W_l H_ll⁻¹ W_lᵀ`` — only the small
  [Dr, Dr] S and [Dr] rhs ride the interconnect, not W.
* The reduced Cholesky runs replicated (Dr is small by construction — that
  is the point of the Schur trick); back-substitution for the landmark
  steps is local, and only the [L·dl] step vector is all-gathered.

Per-device W memory and elimination FLOPs both scale 1/n, so an
``n``-device mesh raises the direct solver's feasible problem size and
speeds up the dominant S contraction by the device count.  The whole outer
optimization (``core.optimize.run_loop``) runs inside ONE ``shard_map``:
collectives appear only inside the linear-system ops, and XLA sees a single
program with no per-iteration host round-trips.

Tested against the single-device Schur backend on a virtual 8-device CPU
mesh (tests/test_parallel.py).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import engine, iterators, structs
from ..core.linearsolver import batched_inv_spd_cm, cholesky_solve
from ..core.optimize import CompiledProblem, compile_problem, run_loop
from ..core.problem import family_name
from ..core.structs import CostTrajectory, Options, Result
from ..ops import schur
from .mesh import DATA_AXIS

#: LRU capacity of ShardedSchurCompiled.run's per-Options runner cache —
#: mirrors core.optimize._RUNNER_CACHE_SIZE's rationale (alternation over a
#: handful of Options must not recompile per call).
_SHARD_RUNNER_CACHE_SIZE = 4


def _pad_eye_local(axis, lc, num_real, dl, dtype):
    """Components-major [dl, dl, Lc] identity on pad slots (global id ≥
    ``num_real``), zero elsewhere — regularizes the zero blocks of landmark
    slots that exist only for even sharding, so λ=0 inversions stay finite
    (their gradient and coupling are zero, so their step is exactly
    zero)."""
    s = jax.lax.axis_index(axis)
    gid = s * lc + jnp.arange(lc, dtype=jnp.int32)
    pad = (gid >= num_real).astype(dtype)
    return jnp.eye(dl, dtype=dtype)[:, :, None] * pad[None, None, :]


def _local_slice_elim(axis, lc, dl, x_elim):
    """Local [Lc, dl] chunk of the global [Lp·dl] eliminated-step vector."""
    s = jax.lax.axis_index(axis)
    return jax.lax.dynamic_slice_in_dim(
        x_elim.reshape(-1, dl), s * lc, lc, axis=0
    )


def _gather_elim_chunks(axis, lc, n_devices, dl, v_local):
    """Concatenate per-device components-major [dl, Lc] landmark chunks
    into the replicated global [Lp, dl] (landmark-major) array.  Written as
    place-into-zeros + psum rather than ``all_gather`` because the latter
    has no replication rule in shard_map's output checker (same bytes over
    the interconnect)."""
    full = jnp.zeros((dl, n_devices * lc), dtype=v_local.dtype)
    s = jax.lax.axis_index(axis)
    full = jax.lax.dynamic_update_slice_in_dim(full, v_local, s * lc, 1)
    return jax.lax.psum(full, axis).T


_HIGHEST = jax.lax.Precision.HIGHEST


def _quad_r(a, x):
    """xᵀ A x at full precision."""
    return jnp.dot(x, jnp.dot(a, x, precision=_HIGHEST), precision=_HIGHEST)


def _local_schur(w, h_inv, g_l):
    """This device's partial Schur correction W·H⁻¹·Wᵀ [Dr, Dr] and rhs
    term W·H⁻¹·g [Dr] over its landmark chunk (components-major local W
    [dl, Lc, Dr]); the S GEMM runs at :func:`schur.s_precision`."""
    y = jnp.einsum("dlr,del->elr", w, h_inv, precision=_HIGHEST)
    corr = jnp.einsum(
        "elr,els->rs", y, w, precision=schur.s_precision(g_l.dtype)
    )
    return corr, jnp.einsum("elr,el->r", y, g_l, precision=_HIGHEST)


@dataclasses.dataclass(frozen=True)
class ShardedSchurOps:
    """The :class:`nllstpu.ops.schur.SchurOps` protocol over a
    landmark-sharded system ``sys = (a_rr, b_r, h_ll, g_l, w)`` where
    ``a_rr``/``b_r`` are replicated and the components-major
    ``h_ll [dl, dl, Lc]``, ``g_l [dl, Lc]``, ``w [dl, Lc, Dr]`` hold only
    the local landmark chunk.  Must be used inside a ``shard_map`` over
    ``axis``.

    Global landmark slots are padded to ``Lp = n · Lc``; pad slots (global
    id ≥ ``num_elim``) carry zero blocks and are regularized with an
    identity before inversion so the λ=0 Newton solve stays finite (their
    gradient and coupling are zero, so their step is exactly zero)."""

    dim_reduced: int
    num_elim: int  # real landmark count L
    num_elim_local: int  # Lc = Lp / n
    dof_elim: int
    n_devices: int = 1
    axis: str = DATA_AXIS
    #: None (contiguous landmark ownership — device s owns global lids
    #: [s·Lc, (s+1)·Lc), the uniform-layout fast path), or the strided-
    #: ownership maps of the bucketed layout (_bucket_shard_plan):
    #: ``gid_table [n, Lc]`` = global lid per (device, local slot) with
    #: ``num_elim`` marking pad slots, and ``gid_pos [n·Lc]`` reordering
    #: the device-major gathered step into global lid order.  Both are
    #: REPLICATED host constants (closing over them is multi-process safe,
    #: unlike sharded arrays).
    gid_table: Any = None
    gid_pos: Any = None

    @property
    def dim(self):
        # Global step length includes the pad slots (they solve to zero).
        return (
            self.dim_reduced
            + self.n_devices * self.num_elim_local * self.dof_elim
        )

    def _pad_eye(self, dtype):
        if self.gid_table is None:
            return _pad_eye_local(
                self.axis, self.num_elim_local, self.num_elim, self.dof_elim,
                dtype,
            )
        s = jax.lax.axis_index(self.axis)
        gids = jnp.asarray(self.gid_table)[s]
        pad = (gids >= self.num_elim).astype(dtype)
        return jnp.eye(self.dof_elim, dtype=dtype)[:, :, None] * pad[None, None, :]

    def _local_xl(self, x):
        x_elim = x[self.dim_reduced :]
        if self.gid_table is None:
            return _local_slice_elim(
                self.axis, self.num_elim_local, self.dof_elim, x_elim
            )
        # Strided ownership: gather this device's rows of the lid-ordered
        # step.  Pad slots index row ``num_elim``, which exists (pads ⇒
        # n·Lc > L) and is zero (gid_pos routes it to a zero pad slot of
        # the gathered vector; see _gather_elim).
        s = jax.lax.axis_index(self.axis)
        rows = jnp.asarray(self.gid_table)[s]
        return x_elim.reshape(-1, self.dof_elim)[rows]

    def _gather_elim(self, v_local):
        full = _gather_elim_chunks(
            self.axis, self.num_elim_local, self.n_devices, self.dof_elim,
            v_local,
        )
        if self.gid_pos is not None:
            # Device-major → global-lid order (strided bucketed ownership);
            # rows past num_elim copy a zero pad slot.
            full = full[jnp.asarray(self.gid_pos)]
        return full

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return jnp.concatenate([b_r, self._gather_elim(g_l).reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        # initial= handles an empty reduced block (every reduced variable
        # fixed); pad-slot h_ll blocks are zero and cannot win the max.
        m_r = jnp.max(jnp.abs(jnp.diagonal(a_rr)), initial=0.0)
        m_l = jnp.max(jnp.abs(jnp.diagonal(h_ll, axis1=0, axis2=1)), initial=0.0)
        return jnp.maximum(m_r, jax.lax.pmax(m_l, self.axis))

    def quad(self, sys, x):
        a_rr, _, h_ll, _, w = sys
        xr = x[: self.dim_reduced]
        xl = self._local_xl(x)
        cross = jnp.einsum("dlr,r,ld->", w, xr, xl, precision=_HIGHEST)
        local = 2.0 * cross + jnp.einsum(
            "ld,del,le->", xl, h_ll, xl, precision=_HIGHEST
        )
        return _quad_r(a_rr, xr) + jax.lax.psum(local, self.axis)

    def solve(self, sys, lam):
        a_rr, b_r, h_ll, g_l, w = sys
        dl = self.dof_elim
        dtype = b_r.dtype
        eye_l = jnp.eye(dl, dtype=dtype)
        eye_r = jnp.eye(self.dim_reduced, dtype=dtype)
        h_damped = h_ll + lam * eye_l[:, :, None] + self._pad_eye(dtype)
        h_inv = batched_inv_spd_cm(h_damped)
        # Only the [Dr, Dr] partial correction and [Dr] partial rhs cross
        # the interconnect — W itself never moves.
        corr, wy = jax.lax.psum(_local_schur(w, h_inv, g_l), self.axis)
        s_mat = a_rr + lam * eye_r - corr
        rhs = b_r - wy
        xr = cholesky_solve(s_mat, rhs)  # replicated reduced solve
        wx = jnp.einsum("dlr,r->dl", w, xr, precision=_HIGHEST)
        xl = jnp.einsum("del,el->dl", h_inv, g_l - wx, precision=_HIGHEST)
        return jnp.concatenate([xr, self._gather_elim(xl).reshape(-1)])

    def solve0_quad_grad(self, sys):
        """Fused undamped solve + gᵀHg for dogleg (see SchurOps): the quad
        cross term rides the back-substitution's local W pass as a stacked
        column; only one extra scalar psum crosses the interconnect."""
        a_rr, b_r, h_ll, g_l, w = sys
        dtype = b_r.dtype
        h_damped = h_ll + self._pad_eye(dtype)
        h_inv = batched_inv_spd_cm(h_damped)
        corr, wy = jax.lax.psum(_local_schur(w, h_inv, g_l), self.axis)
        xr = cholesky_solve(a_rr - corr, b_r - wy)
        wt = jnp.einsum(
            "dlr,rk->kdl", w, jnp.stack([xr, b_r], axis=1),
            precision=_HIGHEST,
        )
        xl = jnp.einsum(
            "del,el->dl", h_inv, g_l - wt[0], precision=_HIGHEST
        )
        local = 2.0 * jnp.sum(wt[1] * g_l) + jnp.einsum(
            "dl,del,el->", g_l, h_ll, g_l, precision=_HIGHEST
        )
        ghg = _quad_r(a_rr, b_r) + jax.lax.psum(local, self.axis)
        return (
            jnp.concatenate([xr, self._gather_elim(xl).reshape(-1)]),
            ghg,
        )


@dataclasses.dataclass(frozen=True)
class ShardedSchurCGOps(schur.SchurCGOps):
    """Landmark-sharded implicit (matrix-free) Schur: the reduced-system
    PCG runs replicated, but every W-coupling term inside its matvec, rhs
    and Schur-Jacobi preconditioner streams through the LOCAL per-cost
    coupling blocks and is psum-reduced — so per-device memory and matvec
    FLOPs for the coupling scale 1/n while the CG itself stays a small
    replicated [Dr] iteration.  ``num_elim`` is the LOCAL chunk size Lc;
    ``num_elim_global`` the real landmark count L.

    This is the multi-chip composition of Ceres' ITERATIVE_SCHUR: combined
    with the implicit backend's O(obs) memory it removes both the dense-W
    and the single-chip HBM bounds."""

    num_elim_global: int = 0
    n_devices: int = 1
    axis: str = DATA_AXIS

    @property
    def dim(self):
        return (
            self.dim_reduced
            + self.n_devices * self.num_elim * self.dof_elim
        )

    # -- distribution hooks (see SchurCGOps) -------------------------------

    def _reduce(self, x):
        return jax.lax.psum(x, self.axis)

    def _h_damp_extra(self, dtype):
        return _pad_eye_local(
            self.axis, self.num_elim, self.num_elim_global, self.dof_elim,
            dtype,
        )

    def _finalize(self, xr, xl):
        g = _gather_elim_chunks(
            self.axis, self.num_elim, self.n_devices, self.dof_elim, xl
        )
        return jnp.concatenate([xr, g.reshape(-1)])

    # -- replicated-protocol overrides -------------------------------------

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        g = _gather_elim_chunks(
            self.axis, self.num_elim, self.n_devices, self.dof_elim, g_l
        )
        return jnp.concatenate([b_r, g.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        m_r = jnp.max(jnp.abs(jnp.diagonal(a_rr)), initial=0.0)
        m_l = jnp.max(jnp.abs(jnp.diagonal(h_ll, axis1=0, axis2=1)), initial=0.0)
        return jnp.maximum(m_r, jax.lax.pmax(m_l, self.axis))

    def quad(self, sys, x):
        a_rr, _, h_ll, _, wparts = sys
        xr = x[: self.dim_reduced]
        xl = _local_slice_elim(
            self.axis, self.num_elim, self.dof_elim, x[self.dim_reduced :]
        )
        cross = xr @ self._w_apply(wparts, xl.T)
        local = 2.0 * cross + jnp.einsum("ld,del,le->", xl, h_ll, xl)
        return xr @ (a_rr @ xr) + jax.lax.psum(local, self.axis)


def _bucket_shard_plan(buckets, L, n):
    """Per-shard STRIDED decomposition of a bucketed obs-major layout
    (ops/schur.ObsBuckets) so the round-4 skewed-degree fast paths survive
    landmark sharding.

    Landmark ids are degree-DESCENDING and each degree-class bucket is a
    contiguous id range, so CONTIGUOUS ownership would concentrate every
    heavy bucket on shard 0 — and shard_map needs one SPMD program, so
    per-shard bucket widths must be IDENTICAL.  Strided ownership
    (``owner(l) = l % n``) gives every shard ``ceil(L_b/n)`` landmarks of
    every class — balanced AND structurally identical — while each
    landmark's k_b-long run stays contiguous, so per-shard assembly is
    still pure reshape+sum.

    The local landmark numbering is shard-INDEPENDENT by construction:
    ``localid(l) = class_base_loc + (l - l0) // n`` (the shard offset
    cancels), which keeps the mapping arrays small.  Chunk buckets (the
    heavy-prefix overlays, always ``l_base == 0``) reuse the containing
    class's local base, exactly like the global plan.  Relies on
    ``_plan_obs_buckets``'s tuple order: chunk buckets first, then class
    buckets in ascending l_base — the LAST bucket with ``l_base == 0`` is
    the head class.

    Returns ``(local_buckets, local_extra_base, Lc, gid_table [n, Lc],
    gid_pos [n*Lc], localid [L], owner [L])`` where ``gid_table[s, t]`` is
    the global lid owned by shard s's local slot t (``L`` = pad slot) and
    ``gid_pos`` reorders the device-major gathered step vector into global
    lid order (pad lids point at a zero pad slot)."""
    i0 = max(i for i, b in enumerate(buckets) if b[0] == 0)
    classes = buckets[i0:]
    assert classes[0][0] == 0
    class_base_loc = {}
    lc = 0
    for (l0, lb, kb, c0) in classes:
        class_base_loc[l0] = lc
        lc += -(-lb // n)
    local_buckets = []
    col = 0
    for (l0, lb, kb, c0) in buckets:  # original order (chunks first)
        lb_loc = -(-lb // n)
        local_buckets.append((class_base_loc[l0], lb_loc, kb, col))
        col += lb_loc * kb
    localid = np.zeros(max(L, 1), dtype=np.int32)
    for (l0, lb, kb, c0) in classes:
        ids = np.arange(l0, l0 + lb)
        localid[ids] = class_base_loc[l0] + (ids - l0) // n
    owner = (np.arange(max(L, 1)) % n).astype(np.int32)
    gid_table = np.full((n, lc), L, dtype=np.int32)
    ls = np.arange(L)
    gid_table[owner[:L], localid[:L]] = ls
    gid_pos = np.empty(n * lc, dtype=np.int64)
    gid_pos[ls] = owner[:L].astype(np.int64) * lc + localid[:L]
    pad_flats = np.nonzero(gid_table.reshape(-1) >= L)[0]
    if L < n * lc:
        gid_pos[L:] = pad_flats[0]  # any zero pad slot
    return (
        tuple(local_buckets), col, lc, gid_table, gid_pos, localid, owner,
    )


def _bucket_shard_sels(buckets, n):
    """Per-shard column selections (with -1 in-place padding) realizing
    :func:`_bucket_shard_plan`'s strided layout: shard s's local column
    block for bucket ``(l0, lb, kb, ·)`` holds the runs of global
    landmarks ``l0 + ((s - l0) % n) + t·n``; slots past the class end pad
    with -1 (mask False).  The caller appends the fixed-landmark extras
    region via balanced fill."""
    sels = []
    for s in range(n):
        parts = []
        for (l0, lb, kb, c0) in buckets:
            lb_loc = -(-lb // n)
            j0 = (s - l0) % n
            g = l0 + j0 + np.arange(lb_loc, dtype=np.int64) * n
            valid = g < l0 + lb
            starts = c0 + (g - l0) * kb
            rows = starts[:, None] + np.arange(kb, dtype=np.int64)[None, :]
            rows = np.where(valid[:, None], rows, -1).reshape(-1)
            parts.append(rows)
        sels.append(np.concatenate(parts) if parts else np.empty(0, np.int64))
    return sels


def _balanced_fill(counts, n, total_extra):
    """Assign ``total_extra`` extra items to ``n`` buckets, most-empty
    first; returns per-item bucket ids [total_extra]."""
    counts = list(counts)
    out = np.empty(total_extra, dtype=np.int64)
    for i in range(total_extra):
        s = int(np.argmin(counts))
        out[i] = s
        counts[s] += 1
    return out


def _slice_batch(batch, sel, target, mask_np):
    """Shard sub-batch: rows ``sel`` of ``batch`` padded to ``target`` rows
    (padding replicates row 0 with mask False).  Entries of ``sel`` equal
    to -1 are in-place padding slots (row 0, mask False) — used by the
    run-preserving obs-major routing to keep every shard's landmark-run
    region exactly ``Lc·k`` rows even when the last shard owns fewer
    landmarks."""
    b_pad = batch.n_padded
    sel = np.asarray(sel, dtype=np.int64)
    pad_n = target - len(sel)
    safe = np.where(sel < 0, 0, sel)
    idx_rows = np.concatenate([safe, np.zeros(pad_n, dtype=np.int64)])
    mask = np.concatenate(
        [np.where(sel < 0, False, mask_np[safe]), np.zeros(pad_n, dtype=bool)]
    )
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[idx_rows] for i in batch.idx),
        params=None
        if batch.params is None
        else jtu.tree_map(lambda l: np.asarray(l)[idx_rows], batch.params),
        mask=mask,
    )


@dataclasses.dataclass
class ShardedSchurCompiled:
    """Landmark-sharded direct-Schur execution of a compiled problem.

    ``batch_tpl`` holds per-shard batch *templates* (shard 0's structure);
    the per-shard arrays live in ``batch_args`` with a leading device axis,
    sharded over the mesh.  ``elim_ids`` maps each eliminated-family
    variable to its LOCAL landmark slot on the owning device (dustbin
    ``Lc`` elsewhere), also per-shard."""

    base: CompiledProblem
    mesh: Mesh
    batch_tpl: list
    batch_args: Any  # sharded [(idx..., params, mask)] per batch
    elim_ids: Any  # sharded [n, n_vars] int32
    fast_meta: Any  # per-batch _FastBatch template or None
    fast_args: Any  # per-batch (obs [n,Lc,K], rvid [n,B_local]) or None
    num_elim: int  # real L
    num_elim_local: int  # Lc
    n_devices: int
    #: Strided-ownership maps when the global layout is BUCKETED
    #: (_bucket_shard_plan; None for uniform layouts, which keep the
    #: contiguous ownership bit-identically).  Replicated host constants.
    gid_table: Any = None
    gid_pos: Any = None

    @property
    def layout(self):
        return self.base.layout

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def info(self):
        return self.base.schur_info

    def _dim(self):
        i = self.info
        return i.dim_reduced + self.n_devices * self.num_elim_local * i.dof_elim

    def ops(self, options=None):
        i = self.info
        if i.implicit:
            fixed = getattr(options, "cg_fixed_iters", None)
            if fixed is None:
                fixed = os.environ.get("NLLSTPU_CG_FIXED_ITERS")
            chunk = getattr(options, "cg_chunk_iters", None)
            if chunk is None:
                chunk = os.environ.get("NLLSTPU_CG_CHUNK_ITERS")
            ltol = getattr(options, "linear_tol", None)
            return ShardedSchurCGOps(
                i.dim_reduced,
                self.num_elim_local,  # local chunk size Lc
                i.dof_elim,
                pad=i.pad,
                fam_offsets=i.fam_offsets,
                wpart_fam=i.wpart_fam,
                fixed_iters=int(fixed) if fixed else None,
                chunk_iters=int(chunk) if chunk else None,
                tol=None if ltol is None else float(ltol),
                num_elim_global=self.num_elim,
                n_devices=self.n_devices,
            )
        return ShardedSchurOps(
            dim_reduced=i.dim_reduced,
            num_elim=self.num_elim,
            num_elim_local=self.num_elim_local,
            dof_elim=i.dof_elim,
            n_devices=self.n_devices,
            gid_table=self.gid_table,
            gid_pos=self.gid_pos,
        )

    # -- local (inside-shard_map) computations -----------------------------

    def _rebuild(self, batch_args):
        # Every leaf was stacked host-side with a leading device axis of
        # size n; inside shard_map the local slice is [1, ...] — strip it.
        return [
            dataclasses.replace(
                b,
                idx=tuple(x[0] for x in i),
                params=None if p is None else jtu.tree_map(lambda l: l[0], p),
                mask=m[0],
            )
            for b, (i, p, m) in zip(self.batch_tpl, batch_args)
        ]

    def _local_info(self, elim_ids, fast_args):
        i = self.info
        fast = []
        for meta, fa in zip(self.fast_meta, fast_args):
            if meta is None or fa is None:
                fast.append(None)
            else:
                obs_table, rvid = fa[0], fa[1]
                cam = fa[2][0] if len(fa) > 2 and fa[2] is not None else None
                fast.append(
                    dataclasses.replace(
                        meta,
                        obs_table=obs_table[0],
                        rvid=rvid[0],
                        cam_table=cam,
                        # meta.obs_k is the SHARED run stride under the
                        # positional routing (parallelize_schur), None
                        # otherwise; the dual-sorted cam fields never
                        # apply to shard repads.
                        obs_k=meta.obs_k,
                        cam_batch=None,
                        cam_k=None,
                        # Bucketed layouts carry the PER-SHARD local
                        # bucket plan (identical on every shard —
                        # _bucket_shard_plan) on the meta; uniform
                        # layouts have None here and obs_k above.
                        buckets=meta.buckets,
                        extra_base=meta.extra_base,
                    )
                )
        return dataclasses.replace(
            i,
            num_elim=self.num_elim_local,
            elim_ids={i.elim_family: elim_ids[0]},
            fast=tuple(fast),
            wpart_fam=i.wpart_fam,  # static per-batch structure is unchanged
            # The sharded CG ops consume batch-major wparts; keep the local
            # assemble off the cm dual-wpart path (global bucket ranges are
            # meaningless per shard anyway).
            wpart_buckets=(),
        )

    def _local_assemble(self, variables, batch_args, elim_ids, fast_args):
        bs = self._rebuild(batch_args)
        info = self._local_info(elim_ids, fast_args)
        # w_dtype=None → the NLLSTPU_W_DTYPE knob applies, exactly like the
        # single-device direct Schur: each device owns its landmarks' W rows
        # outright (W is sharded on the landmark axis, never psum-reduced —
        # only c/a_rr/b_r cross the interconnect below), so per-device bf16 storage
        # introduces the same single downcast after f32 assembly as the
        # single-chip path, with f32 accumulation in every consumer.
        c, sys = schur.assemble_schur(
            bs, variables, self.layout, info, self.dtype, w_dtype=None
        )
        a_rr, b_r, h_ll, g_l, w = sys
        c, a_rr, b_r = jax.lax.psum((c, a_rr, b_r), DATA_AXIS)
        return c, (a_rr, b_r, h_ll, g_l, w)

    def _local_cost(self, variables, batch_args):
        c = engine.total_cost(
            self._rebuild(batch_args), variables, self.dtype,
            runs_list=self._cost_runs(),
        )
        return jax.lax.psum(c, DATA_AXIS)

    def _cost_runs(self):
        """Per-batch LOCAL obs-major run structure for the broadcast-runs
        gather (engine._gather_vals_cm): valid under the run-preserving
        positional routing (meta.obs_k shared across shards)."""
        out = []
        for b, meta in zip(self.batch_tpl, self.fast_meta):
            if (
                meta is not None
                and (meta.obs_k is not None or meta.buckets is not None)
                and getattr(b, "batched", None) == "cm"
            ):
                e_slot = (
                    meta.e_slot
                    if meta.e_slot is not None
                    else 1 - meta.r_slot
                )
                runs = (
                    meta.buckets
                    if meta.buckets is not None
                    else ((0, self.num_elim_local, meta.obs_k, 0),)
                )
                out.append((e_slot, runs))
            else:
                out.append(None)
        return out

    # -- public jitted entry points ----------------------------------------

    def cost(self, variables):
        f = jax.shard_map(
            self._local_cost,
            mesh=self.mesh,
            in_specs=(P(), P(DATA_AXIS)),
            out_specs=P(),
        )
        return f(variables, self.batch_args)

    def assemble(self, variables):
        """(cost, sys) with the landmark-sharded components-major layout:
        ``h_ll [dl, dl, Lp]``/``g_l [dl, Lp]`` sharded on the (minor)
        landmark axis, ``w`` is [dl, Lp, Dr] sharded on axis 1.  Direct
        backend only — the implicit system's per-cost coupling pytree is
        shard-local by construction (use :meth:`solve_once` /
        :meth:`run`)."""
        if self.info.implicit:
            raise ValueError(
                "assemble() is not exposed for the implicit sharded system; "
                "use solve_once()/run()"
            )
        f = jax.shard_map(
            self._local_assemble,
            mesh=self.mesh,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(
                P(),
                (
                    P(),
                    P(),
                    P(None, None, DATA_AXIS),
                    P(None, DATA_AXIS),
                    P(None, DATA_AXIS),
                ),
            ),
        )
        return f(variables, self.batch_args, self.elim_ids, self.fast_args)

    def solve_once(self, variables, lam):
        """Assemble and solve the damped system once, returning
        ``(cost, x)`` with the full (replicated) step vector — the
        sharded analogue of ``ops().solve(assemble(v)[1], lam)``.

        The shard_map-wrapped function is CACHED on the instance: a fresh
        wrapper per call is a new jit cache key, so a host-side λ ladder
        (e.g. scripts/venice_scale.py) recompiled the whole sharded solve
        per λ — 3 compiles ≈ 41 min at 6M obs on the CPU mesh.  λ is a
        runtime argument either way."""
        f = self.__dict__.get("_solve_once_fn")
        if f is None:

            def _one(variables, lam, batch_args, elim_ids, fast_args):
                c, sys = self._local_assemble(
                    variables, batch_args, elim_ids, fast_args
                )
                return c, self.ops().solve(sys, lam)

            f = jax.jit(jax.shard_map(
                _one,
                mesh=self.mesh,
                in_specs=(
                    P(), P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)
                ),
                out_specs=(P(), P()),
            ))
            self.__dict__["_solve_once_fn"] = f
        return f(
            variables, lam, self.batch_args, self.elim_ids, self.fast_args
        )

    def run(self, vars0, opts: Options):
        """The full jitted optimization under one ``shard_map`` — the
        sharded analogue of ``core.optimize.run_loop``."""
        # LRU of several Options: alternation workflows swap between a
        # handful of configurations and must not recompile per call (the
        # same pathology optimize()'s _runner_cache fixes; a single-entry
        # cache here recompiled on every swap).
        cache = self.__dict__.setdefault("_runner_cache", {})
        runner = cache.pop(opts, None)
        if runner is None:
            runner = self._make_runner(opts)
            while len(cache) >= _SHARD_RUNNER_CACHE_SIZE:
                cache.pop(next(iter(cache)))
        cache[opts] = runner  # (re-)insert = most recently used
        return runner(vars0)

    def _make_runner(self, opts: Options):
        def _run(vars0, batch_args, elim_ids, fast_args):
            def assemble_fn(v):
                return self._local_assemble(v, batch_args, elim_ids, fast_args)

            def cost_fn(v):
                return self._local_cost(v, batch_args)

            ctx = iterators.IterCtx(
                cost=cost_fn,
                apply=self.base.apply,
                dtype=jnp.dtype(self.dtype),
                dim=self._dim(),
                linops=self.ops(opts),
            )
            final = run_loop(assemble_fn, cost_fn, ctx, opts, vars0)
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
            return final["variables"], final["trace"], packed

        f = jax.shard_map(
            _run,
            mesh=self.mesh,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=(P(), P(), P()),
        )
        # Globally-sharded arrays must enter as jit ARGUMENTS: a closed-over
        # array spanning non-addressable devices is an unmaterializable
        # constant in multi-process meshes (same fix as
        # ParallelCompiled.run_loop_jit; caught by the 2-process gloo test).
        jitted = jax.jit(f)
        return lambda v: jitted(
            v, self.batch_args, self.elim_ids, self.fast_args
        )


def parallelize_schur(compiled: CompiledProblem, mesh: Mesh) -> ShardedSchurCompiled:
    """Partition a direct-Schur compiled problem across ``mesh`` by
    landmark ownership (see module docstring)."""
    info = compiled.schur_info
    if info is None:
        raise ValueError(
            "parallelize_schur requires a Schur compiled problem "
            "(solver='schur' or 'schur_cg'); use parallel.mesh.parallelize "
            "otherwise"
        )
    n = int(np.prod(mesh.devices.shape))
    L = info.num_elim
    elim_fam = info.elim_family
    gids = np.asarray(info.elim_ids[elim_fam])  # [n_vars] global lid (L=dustbin)

    # Bucketed (skewed-degree) layouts shard by STRIDED ownership so the
    # round-4 fast paths survive (see _bucket_shard_plan); uniform layouts
    # keep the contiguous ownership bit-identically.
    bucket_plan = None
    if not info.implicit:
        wfast = next(
            (
                f
                for f in info.fast
                if f is not None and f.buckets is not None
            ),
            None,
        )
        if wfast is not None and L > 0:
            bucket_plan = _bucket_shard_plan(wfast.buckets, L, n)
    if bucket_plan is not None:
        (
            local_buckets, local_extra_base, lc, gid_table, gid_pos,
            localid, owner,
        ) = bucket_plan
        real = gids < L
        safe = np.where(real, gids, 0)
        elim_ids = np.full((n, gids.shape[0]), lc, dtype=np.int32)
        for s in range(n):
            owned = real & (owner[safe] == s)
            elim_ids[s, owned] = localid[gids[owned]]
    else:
        lc = -(-max(L, 1) // n)  # local landmarks per device (≥ 1)
        gid_table = gid_pos = None
        # Per-shard LOCAL elim ids: owned vars map to [0, Lc), others to
        # the dustbin Lc.
        elim_ids = np.full((n, gids.shape[0]), lc, dtype=np.int32)
        for s in range(n):
            owned = (gids >= s * lc) & (gids < min((s + 1) * lc, L))
            elim_ids[s, owned] = gids[owned] - s * lc

    batch_tpl, batch_args_host, fast_meta, fast_args_host = [], [], [], []
    for bi, b in enumerate(compiled.batches):
        mask_np = np.asarray(b.mask)
        elim_slots = [
            i
            for i, m in enumerate(b.manifolds)
            if family_name(m) == elim_fam
        ]
        b_rows = b.n_padded
        g_fast = info.fast[bi] if bi < len(info.fast) else None
        obs_k_shared = None
        batch_local_buckets = None
        if (
            bucket_plan is not None
            and elim_slots
            and g_fast is not None
            and g_fast.buckets is not None
        ):
            # Bucketed strided routing: each shard takes its strided
            # landmarks' runs per bucket (same local plan on every shard —
            # the SPMD requirement), plus -1 in-place padding for class
            # tails; fixed-landmark extras balanced-fill below.
            sels = _bucket_shard_sels(g_fast.buckets, n)
            eb = g_fast.extra_base
            if eb is None:
                eb = sum(lb * kb for (_, lb, kb, _) in g_fast.buckets)
            rows = np.arange(b_rows, dtype=np.int64)
            extra_rows = rows[rows >= eb]
            batch_local_buckets = local_buckets
        elif (
            not info.implicit
            and elim_slots
            and g_fast is not None
            and g_fast.obs_k is not None
            and bucket_plan is None
        ):
            # Run-preserving POSITIONAL routing: the global batch is
            # obs-major (column l·k+j = landmark l's j-th cost, masked
            # slots inside their run — ops/schur.obs_major_repack), so
            # shard s owns the contiguous row block of its landmarks and
            # every shard is itself obs-major with the same stride k.
            # Landmark reductions then stay contiguous reshape+sums on
            # every device — the old mask-null routing pulled masked
            # slots out of their runs and forced the obs-table gather
            # path per shard (round-3: the single biggest sharded-vs-
            # single-device assembly gap).  Missing landmarks on the
            # last shard become in-place -1 padding so the run region is
            # exactly lc·k rows everywhere.
            kk = g_fast.obs_k
            rows = np.arange(b_rows, dtype=np.int64)
            run_l = rows // kk
            sels = []
            for s in range(n):
                lo, hi = s * lc, min((s + 1) * lc, L)
                run_rows = rows[(rows < L * kk) & (run_l >= lo) & (run_l < hi)]
                pad_slots = np.full((lc - (hi - lo)) * kk, -1, dtype=np.int64)
                sels.append(np.concatenate([run_rows, pad_slots]))
            extra_rows = rows[rows >= L * kk]
            obs_k_shared = kk
        else:
            if elim_slots:
                e = elim_slots[0]
                lid = gids[np.asarray(b.idx[e])]
                lid = np.where(mask_np, lid, L)
                if bucket_plan is not None:
                    safe_l = np.where(lid < L, lid, 0)
                    sh = np.where(lid < L, owner[safe_l], -1)
                else:
                    sh = np.where(lid < L, lid // lc, -1)
            else:
                sh = np.full(b_rows, -1, dtype=np.int64)
            sels = [np.nonzero(sh == s)[0] for s in range(n)]
            extra_rows = np.nonzero(sh < 0)[0]
        fill = _balanced_fill([len(s) for s in sels], n, len(extra_rows))
        for s in range(n):
            sels[s] = np.concatenate(
                [sels[s], extra_rows[fill == s]]
            )
        target = max(1, max(len(s) for s in sels))
        target = -(-target // 8) * 8  # pad to a tile-friendly multiple
        shards = [_slice_batch(b, sels[s], target, mask_np) for s in range(n)]

        # Stack per-shard leaves with a leading device axis.
        def stack(getter):
            return np.stack([np.asarray(getter(sb)) for sb in shards])

        idx_stacked = tuple(
            stack(lambda sb, k=k: sb.idx[k]) for k in range(len(b.idx))
        )
        params_stacked = (
            None
            if b.params is None
            else jtu.tree_map(
                lambda *ls: np.stack([np.asarray(l) for l in ls]),
                *[sb.params for sb in shards],
            )
        )
        mask_stacked = stack(lambda sb: sb.mask)
        batch_tpl.append(shards[0])
        batch_args_host.append((idx_stacked, params_stacked, mask_stacked))

        # Per-shard fast tables against the LOCAL landmark numbering.
        meta = None
        fargs = None
        if elim_slots:
            local_infos = [
                dataclasses.replace(
                    info,
                    num_elim=lc,
                    elim_ids={elim_fam: elim_ids[s]},
                    fast=(),
                )
                for s in range(n)
            ]
            shard_fast = [
                schur._fast_batch_data(sb, compiled.layout, li)
                for sb, li in zip(shards, local_infos)
            ]
            if all(f is not None for f in shard_fast):
                k_max = max(f.obs_table.shape[1] for f in shard_fast)
                tables = np.stack(
                    [
                        np.pad(
                            f.obs_table,
                            ((0, 0), (0, k_max - f.obs_table.shape[1])),
                            constant_values=target,
                        )
                        for f in shard_fast
                    ]
                )
                rvids = np.stack([f.rvid for f in shard_fast])
                # obs_k is shared across shards ONLY under the positional
                # run-preserving routing above (shard-0's own detection may
                # not transfer to the other shards' repadded batches —
                # normalize it away otherwise).
                meta = dataclasses.replace(
                    shard_fast[0],
                    obs_k=obs_k_shared,
                    cam_batch=None,
                    cam_k=None,
                    # The per-shard LOCAL bucket plan (identical across
                    # shards) under the bucketed strided routing; None
                    # otherwise.
                    buckets=batch_local_buckets,
                    extra_base=(
                        local_extra_base
                        if batch_local_buckets is not None
                        else None
                    ),
                )
                cams = None
                if info.implicit and all(
                    f.cam_table is not None for f in shard_fast
                ):
                    # Camera tables hold shard-LOCAL row ids; pad K to the
                    # max over shards so one program serves all devices.
                    kc_max = max(f.cam_table.shape[1] for f in shard_fast)
                    cams = np.stack(
                        [
                            np.pad(
                                f.cam_table,
                                ((0, 0), (0, kc_max - f.cam_table.shape[1])),
                                constant_values=target,
                            )
                            for f in shard_fast
                        ]
                    )
                fargs = (tables, rvids, cams)
        fast_meta.append(meta)
        fast_args_host.append(fargs)

    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def put(x):
        return jax.device_put(np.asarray(x), sharding)

    batch_args = [
        (
            tuple(put(i) for i in idx),
            None if params is None else jtu.tree_map(put, params),
            put(mask),
        )
        for idx, params, mask in batch_args_host
    ]
    fast_args = [
        None
        if fa is None
        else tuple(None if x is None else put(x) for x in fa)
        for fa in fast_args_host
    ]
    return ShardedSchurCompiled(
        base=compiled,
        mesh=mesh,
        batch_tpl=batch_tpl,
        batch_args=batch_args,
        elim_ids=put(elim_ids),
        fast_meta=fast_meta,
        fast_args=fast_args,
        num_elim=L,
        num_elim_local=lc,
        n_devices=n,
        gid_table=gid_table,
        gid_pos=gid_pos,
    )


def optimize_sharded(
    problem,
    mesh: Mesh,
    options: Options = None,
    unfixed=None,
) -> Result:
    """Distributed drop-in for :func:`nllstpu.optimize` on Schur problems:
    the whole jitted optimization runs landmark-sharded over ``mesh``."""
    options = options or Options()
    if options.schur_family is None:
        raise ValueError("optimize_sharded requires Options(schur_family=...)")
    solver = options.solver if options.solver in ("schur", "schur_cg") else "schur"
    t0 = time.perf_counter()
    compiled = compile_problem(
        problem, unfixed, solver=solver, schur_family=options.schur_family
    )
    par = parallelize_schur(compiled, mesh)
    vars0 = problem.stacked_variables()
    t1 = time.perf_counter()
    out_vars, trace, packed = par.run(vars0, options)
    stats = np.asarray(packed)
    t2 = time.perf_counter()
    problem.set_values(out_vars)
    n_iter = int(stats[3])
    trajectory = None
    if options.store_trajectory:
        costs = np.asarray(trace)[:n_iter]
        trajectory = CostTrajectory(costs=list(costs), times_ns=[], trajectory=[])
    return Result(
        start_cost=float(stats[0]),
        best_cost=float(stats[1]),
        time_total=t2 - t0,
        time_init=t1 - t0,
        # NaN = not measured (one fused XLA program; see Result docstring).
        time_cost=float("nan"),
        time_gradient=float("nan"),
        time_solver=float("nan"),
        termination=int(stats[2]),
        num_iterations=n_iter,
        cost_computations=int(stats[4]),
        gradient_computations=int(stats[5]),
        linear_solves=int(stats[6]),
        trajectory=trajectory,
    )
