"""Schur-complement (marginalized) linear system: batched landmark
elimination + dense reduced solve.

Reference parity: the reference only *reorders* costs for Schur and solves
the full system with sparse LDLᵀ (``reordercostsforschur!``,
src/problem.jl:177-199; ``formarginalization`` in src/linearsystem.jl:91-124
— SURVEY.md §3.5 notes there is no marginalizing solver in the snapshot).
Sparse direct factorization is a poor fit for an accelerator, so this
module replaces it (SURVEY.md §2 native table, §7 step 6): eliminate the
designated variable family (the "landmarks") with batched small-block
inverses, form the reduced ("camera") system with one big GEMM,
dense-Cholesky it, and back-substitute — all inside jit.

Block structure, with r = reduced tangent dims and l = eliminated dims:

    [A_rr  W ] [x_r]   [b_r]          S x_r = b_r − W H_ll⁻¹ g_l
    [Wᵀ  H_ll] [x_l] = [g_l]   →      S = A_rr − W H_ll⁻¹ Wᵀ
                                       x_l = H_ll⁻¹ (g_l − Wᵀ x_r)

H_ll is block diagonal, stored components-major ``[dl, dl, L]``; the
gradient ``g_l`` is ``[dl, L]``; W is dense components-major ``[dl, L, Dr]``.
The tiny dl axes are kept leading so that the landmark axis, the long one,
is the minor (contiguous) axis of every batched block array.  The S
contraction is a single [Dr, dl·L] × [dl·L, Dr] GEMM.  The flat step vector
``x`` keeps the reference's variable-major order (landmark-major,
dof-minor) so ``apply_step`` and the iterators are layout-agnostic; the
solve transposes its [dl, L] eliminated step once at the boundary.
Requirement inherited from the reference (src/problem.jl:185): each cost
touches at most one eliminated variable.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Any

import numpy as np
import jax
import jax.numpy as jnp
import jax.tree_util as jtu

from ..core import engine
from ..core.linearsolver import (
    batched_inv_spd,
    batched_inv_spd_cm,
    cholesky_solve,
)
from ..core.problem import family_name

_HIGHEST = jax.lax.Precision.HIGHEST

#: Precision of the f32 reduced-system GEMM S = (W·H⁻¹)·Wᵀ, the one large
#: contraction of the direct solve (K = dl·L).  Measured on an H100 at the
#: Ladybug-49 shape (441 x 23,328 operands): HIGH lowers to the same TF32
#: product as DEFAULT (S relative error 1.3e-5 against an f64 product, and
#: 20 LM iterations end 1.50x above the f64 best cost), HIGHEST to full f32
#: (1.4e-7, 1.04x).  HIGHEST is the lowest precision that keeps the f32 run
#: within 1.1x of f64; it costs ~0.15 ms per GEMM, within run-to-run noise
#: end to end (``scripts/trace_direct.py``).
F32_S_PRECISION = jax.lax.Precision.HIGHEST


def s_precision(dtype):
    """Precision of the S contraction for a system of ``dtype`` (f64 keeps
    full precision for the reference's 1e-15 targets)."""
    return _HIGHEST if dtype == jnp.float64 else F32_S_PRECISION


@dataclasses.dataclass(frozen=True)
class SchurOps:
    """Linear-system ops over ``sys = (a_rr, b_r, h_ll, g_l, w)`` implementing
    the same protocol as :class:`nllstpu.core.iterators.DenseOps`."""

    dim_reduced: int
    num_elim: int
    dof_elim: int

    @property
    def dim(self):
        return self.dim_reduced + self.num_elim * self.dof_elim

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return jnp.concatenate([b_r, g_l.T.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        # initial= handles an empty reduced block (every reduced variable
        # fixed — e.g. landmark-only polish with solver="schur").
        m_r = jnp.max(jnp.abs(jnp.diagonal(a_rr)), initial=0.0)
        m_l = jnp.max(jnp.abs(jnp.diagonal(h_ll, axis1=0, axis2=1)), initial=0.0)
        return jnp.maximum(m_r, m_l)

    def quad(self, sys, x):
        a_rr, _, h_ll, _, w = sys
        xr = x[: self.dim_reduced]
        xl = x[self.dim_reduced :].reshape(self.num_elim, self.dof_elim)
        cross = jnp.einsum("dlr,r,ld->", w, xr, xl, precision=_HIGHEST)
        return (
            jnp.dot(xr, jnp.dot(a_rr, xr, precision=_HIGHEST),
                    precision=_HIGHEST)
            + 2.0 * cross
            + jnp.einsum("ld,del,le->", xl, h_ll, xl, precision=_HIGHEST)
        )

    def solve(self, sys, lam):
        return self._solve(sys, lam, want_gquad=False)[0]

    def solve0_quad_grad(self, sys):
        """Undamped Newton solve H·x = g fused with the gradient curvature
        gᵀHg — dogleg needs both every outer iteration (the reference does
        them as separate solve!/fast_bAb passes, src/iterators.jl:47-57).
        Fusing lets the quad's cross term Wᵀb_r ride the back-substitution's
        W pass as a second stacked column instead of streaming the dense W
        coupling a second time."""
        zero = jnp.zeros((), dtype=sys[0].dtype)
        return self._solve(sys, zero, want_gquad=True)

    def _solve(self, sys, lam, want_gquad):
        a_rr, b_r, h_ll, g_l, w = sys
        dl = self.dof_elim
        eye_l = jnp.eye(dl, dtype=h_ll.dtype)
        eye_r = jnp.eye(self.dim_reduced, dtype=a_rr.dtype)
        h_damped = h_ll + lam * eye_l[:, :, None]
        a_damped = a_rr + lam * eye_r
        with jax.named_scope("schur_damped_solve"):
            # Batched landmark-block inverses (closed-form for d<=3).
            h_inv = batched_inv_spd_cm(h_damped)
            # y = W·H⁻¹, never materialized wider than one W (h_inv
            # symmetric).  The reduced (Schur) system is one GEMM over
            # dl·L; its precision is ``s_precision`` (see there).  The
            # K = dl contractions around it read W once each and do ~dl
            # flops per element read, so they stay at HIGHEST: a TF32
            # product would only lose digits.
            y = jnp.einsum("dlr,del->elr", w, h_inv, precision=_HIGHEST)
            s_sum = jnp.einsum(
                "elr,els->rs", y, w, precision=s_precision(a_rr.dtype)
            )
            rhs_sum = jnp.einsum("elr,el->r", y, g_l, precision=_HIGHEST)
            s = a_damped - s_sum
            rhs = b_r - rhs_sum
            xr = cholesky_solve(s, rhs)
            if not want_gquad:
                # Back-substitution; transpose to landmark-major at the
                # boundary.
                wx = jnp.einsum("dlr,r->dl", w, xr, precision=_HIGHEST)
                xl = jnp.einsum(
                    "del,el->dl", h_inv, g_l - wx, precision=_HIGHEST
                )
                return jnp.concatenate([xr, xl.T.reshape(-1)]), None
            # Wᵀ·[x_r | b_r] in ONE W pass: column 0 feeds the
            # back-substitution, column 1 is the quad cross term.
            stacked = jnp.stack([xr, b_r], axis=1)
            wt = jnp.einsum("dlr,rk->kdl", w, stacked, precision=_HIGHEST)
            xl = jnp.einsum(
                "del,el->dl", h_inv, g_l - wt[0], precision=_HIGHEST
            )
            ghg = (
                jnp.dot(b_r, jnp.dot(a_rr, b_r, precision=_HIGHEST),
                        precision=_HIGHEST)
                + 2.0 * jnp.sum(wt[1] * g_l)
                + jnp.einsum("dl,del,el->", g_l, h_ll, g_l,
                             precision=_HIGHEST)
            )
            return jnp.concatenate([xr, xl.T.reshape(-1)]), ghg


class WPart(NamedTuple):
    """Per-batch coupling data for the implicit (matrix-free) Schur solve.
    A NamedTuple so it rides through jit as a pytree; optional fields are
    None when the corresponding fast-path table is unavailable.

    The two observation tables turn the CG matvec's landmark- and
    camera-keyed reductions into gathers + dense sums instead of
    duplicate-index scatter-adds: a ``[keys, K]`` table gather with a
    fill-value for padding is one vectorized load + sum."""

    w_blk: Any  # [B, Sr, dl] per-cost coupling blocks
    rows_r: Any  # [B, Sr] global reduced row per block column
    lid: Any  # [B] eliminated-variable id (dustbin L when masked/fixed)
    rvid: Optional[Any]  # [B] reduced-variable id within its family
    obs: Optional[Any]  # [L, K] cost ids per landmark (pad = out-of-range)
    cam_obs: Optional[Any]  # [n_r, Kc] cost ids per reduced var
    row_base: Optional[Any]  # [n_r] first reduced row per var (fixed → dr)


@dataclasses.dataclass(frozen=True)
class SchurCGOps:
    """Implicit (iterative) Schur: the reduced system S = A_rr − W·H_ll⁻¹·Wᵀ
    is never materialized — its matvec streams through the per-cost W blocks
    (gather → block multiply → landmark segment-sum → back) and the reduced
    solve is PCG with a block-Jacobi preconditioner over A_rr's diagonal.
    This removes the O(L·Dr·dl) dense-W memory of :class:`SchurOps`, making
    Venice/Final-scale BAL feasible on one chip (Ceres ITERATIVE_SCHUR
    analogue).

    ``sys = (a_rr, b_r, h_ll, g_l, wparts)`` with ``wparts`` a tuple of
    per-batch :class:`WPart` (``w_blk [B,Sr,dl]``, ``rows_r [B,Sr]``,
    ``lid [B]``, and ``rvid``, the per-cost reduced-variable id within its
    family, None when unavailable).

    The PCG preconditioner is **Schur-Jacobi** (the Ceres ``SCHUR_JACOBI``
    analogue): the exact diagonal blocks of S = A_rr − W·H_ll⁻¹·Wᵀ, i.e.
    A_rr's diagonal blocks minus the per-camera Σ_c w_c H_ll⁻¹ w_cᵀ
    correction, reduced over costs with a one-hot matmul.  Batches
    without ``rvid`` (or reduced families untouched by coupling costs) fall
    back to the A_rr-only block-Jacobi blocks."""

    dim_reduced: int
    num_elim: int
    dof_elim: int
    pad: int
    # Reduced-family layout for the preconditioner: (name, offsets [n], dof).
    fam_offsets: tuple
    # Per-wpart index into fam_offsets of the single reduced slot's family
    # (None disables the Schur-Jacobi correction for that wpart).
    wpart_fam: tuple = ()
    # Relative PCG residual tolerance; None = dtype default (1e-12 for f64,
    # 1e-5 for f32 — an f64 tolerance is unreachable in f32 and forces every
    # solve to burn max_iters; LM's acceptance test tolerates inexact steps).
    tol: Optional[float] = None
    max_iters: int = 500
    # Per-wpart obs-major run length (see obs_major_repack): the CG
    # matvec's landmark reductions become contiguous reshape + minor-axis
    # sums and the ``W u`` expansion a broadcast — no gathers in the CG
    # loop.  None entries use the obs-table / scatter paths.  UNIFORM runs
    # only — the cluster-Jacobi layout requires it; run structure proper
    # lives in ``wpart_buckets``.
    wpart_obs_k: tuple = ()
    # Per-wpart obs-major run buckets (((l_base, L_b, k_b, col_base), ...)
    # or None): marks a components-major [Sr, dl, B] w_blk whose landmark
    # reductions are bucketed reshape-sums (uniform batches are one
    # bucket; skewed real-BAL layouts several).
    wpart_buckets: tuple = ()
    # Cluster-Jacobi preconditioner (Ceres CLUSTER_JACOBI analogue): group
    # this many consecutive reduced variables per cluster and precondition
    # with the exact [cdim, cdim] diagonal CLUSTER blocks of S — capturing
    # the camera-camera coupling that per-camera Schur-Jacobi ignores, at
    # the price of one W-sized contraction per cluster per solve.  0 = off
    # (per-variable Schur-Jacobi).  Requires a single reduced family with
    # contiguous offsets and an obs-major coupling batch; silently falls
    # back otherwise.
    cluster_size: int = 0
    # Fixed-trip-count CG: run exactly this many iterations as a
    # ``lax.fori_loop`` with masked (frozen-on-convergence) updates instead
    # of a data-dependent ``while_loop``.  Removes one level of nested
    # dynamic control flow, at the price of always burning the full
    # iteration budget.  None = dynamic while loop.
    fixed_iters: Optional[int] = None
    # Chunked CG: a ``while_loop`` over ``fori_loop`` blocks of this many
    # iterations — converged solves stop at chunk granularity (frozen
    # updates keep over-running within a chunk exact) instead of burning
    # ``fixed_iters`` every solve, while the INNERMOST loop stays a fori.
    # Takes precedence over ``fixed_iters``; bounded by ``max_iters``.
    # None/0 = off.
    chunk_iters: Optional[int] = None

    def _tol(self, dtype):
        if self.tol is not None:
            return self.tol
        return 1e-5 if jnp.dtype(dtype).itemsize <= 4 else 1e-12

    # -- distribution hooks -------------------------------------------------
    # The landmark-sharded multi-device variant
    # (nllstpu.parallel.schur_shard.ShardedSchurCGOps) overrides these: the
    # W-coupling terms and preconditioner corrections become psums over the
    # mesh, eliminated-block damping gains pad-slot regularization, and the
    # final landmark step is gathered.  Single-device defaults are no-ops.

    def _reduce(self, x):
        """Cross-device sum of a landmark-reduced coupling term."""
        return x

    def _h_damp_extra(self, dtype):
        """Extra [*, dl, dl] damping added to H_ll before inversion."""
        return jnp.zeros((), dtype=dtype)

    def _finalize(self, xr, xl):
        """Assemble the full step from reduced + (local) eliminated parts;
        ``xl`` arrives components-major [dl, L] and is transposed to the
        flat landmark-major order once, at this boundary."""
        return jnp.concatenate([xr, xl.T.reshape(-1)])

    @property
    def dim(self):
        return self.dim_reduced + self.num_elim * self.dof_elim

    def grad(self, sys):
        _, b_r, _, g_l, _ = sys
        return jnp.concatenate([b_r, g_l.T.reshape(-1)])

    def diag_max(self, sys):
        a_rr, _, h_ll, _, _ = sys
        m_r = jnp.max(jnp.abs(jnp.diagonal(a_rr)), initial=0.0)
        m_l = jnp.max(jnp.abs(jnp.diagonal(h_ll, axis1=0, axis2=1)), initial=0.0)
        return jnp.maximum(m_r, m_l)

    def _wt_apply(self, wparts, v):
        """u[:, l] = Σ_{costs i of l} w_iᵀ v[rows_i]  →  cm [dl, L].

        Landmark reduction preference: obs-major run sums > observation-
        table gather + dense sum > scatter-add fallback."""
        u = jnp.zeros((self.dof_elim, self.num_elim + 1), dtype=v.dtype)
        vp = jnp.concatenate([v, jnp.zeros(self.pad + 1, dtype=v.dtype)])
        for i, wp in enumerate(wparts):
            bks = (
                self.wpart_buckets[i] if i < len(self.wpart_buckets) else None
            )
            if bks is not None:
                # Obs-major run buckets: landmark l of bucket (l0, L_b, K_b,
                # c0) owns columns c0 + (l−l0)·K_b + j.  Masked/dustbin
                # columns contribute zero (their rvid one-hot column is
                # all-zero); extras (fixed-landmark costs, beyond the
                # buckets) have no W rows at all.  w_blk is stored
                # components-major [Sr, dl, B] for obs-major wparts, and
                # EVERY intermediate stays [.., B] (B-minor, the long axis
                # contiguous).  The per-cost expansion of v is a one-hot
                # matmul against the tiny per-camera table.
                if wp.row_base is not None and wp.rvid is not None:
                    sr = wp.w_blk.shape[0]
                    n_r = wp.row_base.shape[0]
                    cam_idx = (
                        wp.row_base[:, None]
                        + jnp.arange(sr, dtype=jnp.int32)[None, :]
                    )
                    v_cam = vp[cam_idx]  # [n_r, Sr] — tiny
                    bsz = wp.rvid.shape[0]
                    vg = None
                    for start, width in _onehot_chunks(
                        n_r, _FAST_MAX_ONEHOT, bsz
                    ):
                        oh = (
                            (start + jnp.arange(width, dtype=jnp.int32))[
                                :, None
                            ]
                            == wp.rvid[None, :]
                        ).astype(v.dtype)  # [width, B]
                        part = jnp.einsum(
                            "vb,vs->sb", oh, v_cam[start : start + width],
                            precision="highest",
                        )
                        vg = part if vg is None else vg + part
                else:
                    vg = vp[wp.rows_r.T]  # [Sr, B]
                q = jnp.einsum("sdb,sb->db", wp.w_blk, vg)  # cm [dl, B]
                for (l0, lb, kb, c0) in bks:
                    u = u.at[:, l0 : l0 + lb].add(
                        q[:, c0 : c0 + lb * kb].reshape(-1, lb, kb).sum(-1)
                    )
                continue
            vg = vp[wp.rows_r]  # [B, Sr]
            q = jnp.einsum("bsd,bs->db", wp.w_blk, vg)  # cm [dl, B]
            if wp.obs is not None:
                L, k = wp.obs.shape
                # Chunk the [dl, L·k] gather transient over landmarks
                # (same Venice-scale bound as the camera tables).
                qrows = max(
                    1, _FAST_MAX_ONEHOT // max(k * q.shape[0], 1)
                )
                for l0 in range(0, L, qrows):
                    tbl = wp.obs[l0 : l0 + qrows]
                    flat = jnp.take(
                        q, tbl.reshape(-1), axis=-1, mode="fill",
                        fill_value=0,
                    )
                    u = u.at[:, l0 : l0 + tbl.shape[0]].add(
                        flat.reshape(-1, tbl.shape[0], k).sum(axis=-1)
                    )
            else:
                u = u.at[:, wp.lid].add(q)
        return u[:, : self.num_elim]

    def _w_apply(self, wparts, u):
        """y = Σ_i w_i u[:, l_i] scattered at rows_i  →  [Dr]; ``u`` is
        components-major [dl, L].

        With a camera table the per-cost contributions are gathered per
        reduced variable and land with a UNIQUE-row scatter; otherwise a
        duplicate-index scatter-add."""
        up = jnp.concatenate(
            [u, jnp.zeros((self.dof_elim, 1), dtype=u.dtype)], axis=-1
        )
        y = jnp.zeros(self.dim_reduced + self.pad + 1, dtype=u.dtype)
        for i, wp in enumerate(wparts):
            bks = (
                self.wpart_buckets[i] if i < len(self.wpart_buckets) else None
            )
            if bks is not None:
                # Obs-major: the gather u[:, lid] is a broadcast over the
                # run slots of each bucket; masked columns (and the extras
                # region beyond the buckets) are zeroed via the lid dustbin
                # mask.  w_blk is components-major [Sr, dl, B] here.
                L = self.num_elim
                b_tot = wp.lid.shape[0]
                parts, pos = [], 0
                for (l0, lb, kb, c0) in bks:
                    if c0 > pos:
                        parts.append(
                            jnp.zeros((u.shape[0], c0 - pos), dtype=u.dtype)
                        )
                    parts.append(
                        jnp.broadcast_to(
                            u[:, l0 : l0 + lb, None],
                            (u.shape[0], lb, kb),
                        ).reshape(u.shape[0], lb * kb)
                    )
                    pos = c0 + lb * kb
                ug = jnp.concatenate(parts, axis=1) if len(parts) > 1 else parts[0]
                ug = jnp.pad(ug, ((0, 0), (0, b_tot - pos)))
                ug = ug * (wp.lid < L)[None, :]
                # B-minor throughout (see _wt_apply): the camera-keyed
                # reduction is the chunked one-hot matmul over rvid (the
                # direct path's _onehot_reduced_tail pattern) instead of a
                # gather over [B, Sr].
                t = jnp.einsum("sdb,db->sb", wp.w_blk, ug)  # [Sr, B]
                if wp.rvid is not None and wp.row_base is not None:
                    sr = t.shape[0]
                    n_r = wp.row_base.shape[0]
                    for start, width in _onehot_chunks(
                        n_r, _FAST_MAX_ONEHOT, t.shape[1]
                    ):
                        oh = (
                            (start + jnp.arange(width, dtype=jnp.int32))[
                                :, None
                            ]
                            == wp.rvid[None, :]
                        ).astype(t.dtype)  # dustbin rvid → all-zero column
                        g = jnp.einsum(
                            "vb,sb->vs", oh, t, precision="highest"
                        )
                        idx = (
                            wp.row_base[start : start + width, None]
                            + jnp.arange(sr, dtype=jnp.int32)[None, :]
                        )
                        y = y.at[idx].add(g)
                else:
                    y = y.at[wp.rows_r].add(t.T)
                continue
            ug = up[:, wp.lid]  # cm [dl, B]
            t = jnp.einsum("bsd,db->bs", wp.w_blk, ug)  # [B, Sr]
            if wp.cam_obs is not None and wp.row_base is not None:
                n_r, kc = wp.cam_obs.shape
                sr = t.shape[1]
                # Chunk the [n_r, kc, sr] gather transient over kc: at
                # Venice scale a skew-hot camera gives kc ≈ 5.8k per shard
                # and the unchunked transient was a 33 GB/device (267 GB
                # global) allocation on the 8-device CPU mesh.  Work is
                # unchanged; only the transient is bounded.
                q = max(1, _FAST_MAX_ONEHOT // max(n_r * sr, 1))
                g = jnp.zeros((n_r, sr), dtype=t.dtype)
                for s0 in range(0, kc, q):
                    cols = wp.cam_obs[:, s0 : s0 + q]
                    g = g + jnp.take(
                        t, cols.reshape(-1), axis=0, mode="fill",
                        fill_value=0,
                    ).reshape(n_r, cols.shape[1], sr).sum(axis=1)
                idx = (
                    wp.row_base[:, None]
                    + jnp.arange(sr, dtype=jnp.int32)[None, :]
                )
                y = y.at[idx].add(g)
            else:
                y = y.at[wp.rows_r].add(t)
        return y[: self.dim_reduced]

    def quad(self, sys, x):
        a_rr, _, h_ll, _, wparts = sys
        xr = x[: self.dim_reduced]
        xl = x[self.dim_reduced :].reshape(self.num_elim, self.dof_elim)
        cross = xr @ self._w_apply(wparts, xl.T)
        return (
            xr @ (a_rr @ xr)
            + 2.0 * cross
            + jnp.einsum("ld,del,le->", xl, h_ll, xl)
        )

    def precond_blocks(self, sys, lam, h_inv):
        """Per-family damped S diagonal blocks (Schur-Jacobi) — exact
        ``S[v,v] = (A_rr + λI)[v,v] − Σ_c w_c H⁻¹ w_cᵀ`` where coupling data
        is available, A_rr-only (block-Jacobi) otherwise.  Returns
        ``(blocks, corrected)``: a list of ``[n, dof, dof]`` aligned with
        ``fam_offsets`` and per-family flags marking which received the
        Schur correction."""
        a_rr, _, _, _, wparts = sys
        dtype = a_rr.dtype
        dl = self.dof_elim

        # Start from A_rr's diagonal blocks, then subtract the per-variable
        # correction Σ_c w_c H⁻¹ w_cᵀ, reduced over costs with a chunked
        # one-hot matmul keyed by the reduced-variable id instead of a
        # duplicate-index scatter.
        a_pad = jnp.pad(a_rr, ((0, 1), (0, 1)))
        fam_blocks = []
        for name, offs, dof in self.fam_offsets:
            idx = offs[:, None] + np.arange(dof, dtype=np.int32)[None, :]
            idx = np.minimum(idx, self.dim_reduced)  # dustbin-safe
            fam_blocks.append(
                a_pad[idx[:, :, None], idx[:, None, :]]
                + lam * jnp.eye(dof, dtype=dtype)
            )
        h_inv_p = jnp.pad(h_inv, ((0, 0), (0, 0), (0, 1)))
        corrected = [False] * len(fam_blocks)
        for i, wp in enumerate(wparts):
            fi = self.wpart_fam[i] if i < len(self.wpart_fam) else None
            if fi is None or wp.rvid is None:
                continue
            name, offs, dof = self.fam_offsets[fi]
            cm_blk = (
                i < len(self.wpart_buckets)
                and self.wpart_buckets[i] is not None
            )
            # w_blk layout: cm [Sr, dl, B] for obs-major wparts, batch-major
            # [B, Sr, dl] otherwise.
            b_axis, s_axis = (-1, 0) if cm_blk else (0, 1)
            if (
                wp.w_blk.shape[s_axis] != dof
                or wp.rvid.shape[0] != wp.w_blk.shape[b_axis]
            ):
                continue  # per-shard repads: shapes no longer line up
            # cm [dl, dl, B]; masked costs hit the zero pad column.
            hi = h_inv_p[:, :, wp.lid]
            if cm_blk:
                m = jnp.einsum("pdb,deb,qeb->bpq", wp.w_blk, hi, wp.w_blk)
            else:
                m = jnp.einsum("bpd,deb,bqe->bpq", wp.w_blk, hi, wp.w_blk)
            n_r = offs.shape[0]
            mf = m.reshape(m.shape[0], dof * dof)
            if wp.cam_obs is not None:
                # Camera-table gather: O(B) work, no one-hot transient.
                # Chunked over kc — same Venice-scale transient bound as
                # _w_apply (the unchunked [n_r, kc, dof²] staging was a
                # 33 GB/device allocation at 54M obs).
                kc = wp.cam_obs.shape[1]
                q = max(1, _FAST_MAX_ONEHOT // max(n_r * dof * dof, 1))
                corr = jnp.zeros((n_r, dof * dof), dtype=mf.dtype)
                for s0 in range(0, kc, q):
                    cols = wp.cam_obs[:, s0 : s0 + q]
                    corr = corr + jnp.take(
                        mf, cols.reshape(-1), axis=0, mode="fill",
                        fill_value=0,
                    ).reshape(n_r, cols.shape[1], dof * dof).sum(axis=1)
            else:
                parts = []
                for start, width in _onehot_chunks(
                    n_r, _FAST_MAX_ONEHOT, mf.shape[0]
                ):
                    oh = (
                        wp.rvid[:, None]
                        == (start + jnp.arange(width, dtype=jnp.int32))[None, :]
                    ).astype(dtype)  # dustbin (fixed/masked) rows are all-zero
                    parts.append(jnp.einsum("bv,bk->vk", oh, mf))
                corr = jnp.concatenate(parts, axis=0)
            corr = self._reduce(corr)  # sum per-device partials when sharded
            fam_blocks[fi] = fam_blocks[fi] - corr.reshape(n_r, dof, dof)
            corrected[fi] = True
        return fam_blocks, corrected

    def _cluster_layout(self):
        """Static qualification for the cluster-Jacobi preconditioner:
        (n_clusters, m, dof, cdim, n_r) or None."""
        if self.cluster_size <= 0 or len(self.fam_offsets) != 1:
            return None
        if len(self.wpart_obs_k) != 1 or self.wpart_obs_k[0] is None:
            return None
        name, offs, dof = self.fam_offsets[0]
        offs = np.asarray(offs)
        n_r = offs.shape[0]
        if n_r == 0 or not np.array_equal(
            offs, np.arange(n_r, dtype=offs.dtype) * dof
        ):
            return None  # fixed/reordered cameras: fall back
        m = int(self.cluster_size)
        n_cl = -(-n_r // m)
        if n_cl > 64:
            return None  # unrolled build would bloat the program
        return n_cl, m, dof, m * dof, n_r

    def cluster_inverses(self, sys, lam, h_inv, layout):
        """Inverted [n_cl, cdim, cdim] diagonal cluster blocks of the damped
        reduced matrix S(λ) — exact, including the cross-camera coupling
        within each cluster: S_CC = (A_rr + λI)_CC − Σ_l U_lC H_l⁻¹ U_lCᵀ
        where U_lC stacks landmark l's couplings into cluster C's columns.
        Built per cluster from the obs-major runs with one one-hot
        contraction (a W-sized pass per cluster).  Ill-conditioned clusters
        fall back to their A-only block inverse."""
        n_cl, m, dof, cdim, n_r = layout
        a_rr, _, _, _, wparts = sys
        dtype = a_rr.dtype
        wp = wparts[0]
        ok = self.wpart_obs_k[0]
        L = self.num_elim
        # Padded A with identity on the pad rows (partial last cluster).
        total = n_cl * cdim
        ap = jnp.pad(a_rr, ((0, total - self.dim_reduced),) * 2)
        if total > self.dim_reduced:
            pad_ix = jnp.arange(self.dim_reduced, total)
            ap = ap.at[pad_ix, pad_ix].set(1.0)
        a_blocks = jax.vmap(
            lambda i: jax.lax.dynamic_slice(
                ap, (i * cdim, i * cdim), (cdim, cdim)
            )
        )(jnp.arange(n_cl))
        vc = wp.rvid[: L * ok].reshape(L, ok)  # camera id per obs slot
        w_runs = wp.w_blk[..., : L * ok].reshape(
            wp.w_blk.shape[0], wp.w_blk.shape[1], L, ok
        )  # cm [Sr, dl, L, K]
        corrs = []
        for ci in range(n_cl):
            loc = vc - ci * m  # [L, K]
            # Dustbin ids (≥ n_r: masked costs, fixed cameras) can land
            # inside the LAST cluster's id range, so exclude them
            # explicitly rather than relying on their w_blk being zero.
            oh = (
                (loc[:, :, None] == jnp.arange(m, dtype=vc.dtype)[None, None, :])
                & (vc[:, :, None] < n_r)
            ).astype(dtype)  # [L, K, m]; out-of-cluster/dustbin → all-zero
            # U [dl, L, cdim]: local column = loc·dof + p (m-major, p-minor
            # = the contiguous-offsets order).
            u = jnp.einsum(
                "pdlk,lkm->dlmp", w_runs, oh, precision="highest"
            ).reshape(w_runs.shape[1], L, cdim)
            hu = jnp.einsum("del,elx->dlx", h_inv, u)
            corrs.append(
                jnp.einsum("dlx,dly->xy", hu, u, precision="highest")
            )
        corr = self._reduce(jnp.stack(corrs))
        blocks = (
            a_blocks + lam * jnp.eye(cdim, dtype=dtype)[None] - corr
        )
        inv = batched_inv_spd(blocks)
        plain = batched_inv_spd(
            a_blocks + lam * jnp.eye(cdim, dtype=dtype)[None]
        )
        bad = ~jnp.all(jnp.isfinite(inv), axis=(-2, -1), keepdims=True)
        return jnp.where(bad, plain, inv)

    def precond_inverses(self, sys, lam, h_inv):
        """Inverted preconditioner blocks, with a per-block fallback to the
        A_rr-only inverse when a corrected block loses definiteness (λ=0 on
        gauge-deficient problems)."""
        a_rr = sys[0]
        dtype = a_rr.dtype
        a_pad = jnp.pad(a_rr, ((0, 1), (0, 1)))
        fam_blocks, corrected = self.precond_blocks(sys, lam, h_inv)
        inv_blocks = []
        for was_corrected, (name, offs, dof), blocks in zip(
            corrected, self.fam_offsets, fam_blocks
        ):
            inv = batched_inv_spd(blocks)
            if was_corrected:
                idx = offs[:, None] + np.arange(dof, dtype=np.int32)[None, :]
                idx = np.minimum(idx, self.dim_reduced)
                plain = batched_inv_spd(
                    a_pad[idx[:, :, None], idx[:, None, :]]
                    + lam * jnp.eye(dof, dtype=dtype)
                )
                bad = ~jnp.all(
                    jnp.isfinite(inv), axis=(-2, -1), keepdims=True
                )
                inv = jnp.where(bad, plain, inv)
            inv_blocks.append(inv)
        return inv_blocks

    def solve(self, sys, lam):
        a_rr, b_r, h_ll, g_l, wparts = sys
        dtype = b_r.dtype
        dl = self.dof_elim
        h_inv = batched_inv_spd_cm(
            h_ll
            + lam * jnp.eye(dl, dtype=dtype)[:, :, None]
            + self._h_damp_extra(dtype)
        )

        def s_matvec(v):
            u = self._wt_apply(wparts, v)  # Wᵀ v, cm [dl, L]
            u = jnp.einsum("del,el->dl", h_inv, u)  # H_ll⁻¹ Wᵀ v
            return a_rr @ v + lam * v - self._reduce(self._w_apply(wparts, u))

        rhs = b_r - self._reduce(
            self._w_apply(wparts, jnp.einsum("del,el->dl", h_inv, g_l))
        )

        cluster = self._cluster_layout()
        if cluster is not None:
            n_cl, _, _, cdim, _ = cluster
            cinv = self.cluster_inverses(sys, lam, h_inv, cluster)

            def precond(r):
                # Contiguous offsets: the block apply is a pure reshape.
                rp = jnp.pad(r, (0, n_cl * cdim - self.dim_reduced))
                z = jnp.einsum(
                    "nxy,ny->nx", cinv, rp.reshape(n_cl, cdim),
                    precision="highest",
                )
                return z.reshape(-1)[: self.dim_reduced]
        else:
            inv_blocks = self.precond_inverses(sys, lam, h_inv)

            def precond(r):
                rp = jnp.concatenate([r, jnp.zeros(self.pad + 1, dtype=dtype)])
                z = jnp.zeros(self.dim_reduced + self.pad + 1, dtype=dtype)
                for (name, offs, dof), inv in zip(self.fam_offsets, inv_blocks):
                    idx = jnp.asarray(offs)[:, None] + jnp.arange(dof, dtype=jnp.int32)[None, :]
                    idx = jnp.minimum(idx, self.dim_reduced + self.pad)
                    rg = rp[idx]
                    z = z.at[idx].add(jnp.einsum("nst,nt->ns", inv, rg))
                return z[: self.dim_reduced]

        x0 = jnp.zeros(self.dim_reduced, dtype=dtype)
        r0 = rhs
        z0 = precond(r0)
        rz0 = r0 @ z0
        tol2 = jnp.asarray(self._tol(dtype), dtype) ** 2 * (rhs @ rhs)

        def body(st):
            x, r, z, p, rz, k = st
            active = r @ r > tol2
            ap = s_matvec(p)
            denom = p @ ap
            alpha = rz / jnp.where(denom == 0, jnp.ones_like(denom), denom)
            # Frozen once converged: keeps the fixed-trip fori_loop exact.
            alpha = jnp.where(active, alpha, jnp.zeros_like(alpha))
            x2 = x + alpha * p
            r2 = r - alpha * ap
            z2 = precond(r2)
            rz2 = r2 @ z2
            beta = rz2 / jnp.where(rz == 0, jnp.ones_like(rz), rz)
            p2 = jnp.where(active, z2 + beta * p, p)
            rz2 = jnp.where(active, rz2, rz)
            z2 = jnp.where(active, z2, z)
            return (x2, r2, z2, p2, rz2, k + jnp.int32(active))

        init = (x0, r0, z0, z0, rz0, jnp.int32(0))

        def cond(st):
            _, r, _, _, _, k = st
            return (r @ r > tol2) & (k < self.max_iters)

        if self.chunk_iters:
            chunk = int(self.chunk_iters)
            xr, *_ = jax.lax.while_loop(
                cond,
                lambda st: jax.lax.fori_loop(
                    0, chunk, lambda i, s: body(s), st
                ),
                init,
            )
        elif self.fixed_iters is not None:
            xr, *_ = jax.lax.fori_loop(
                0, self.fixed_iters, lambda i, st: body(st), init
            )
        else:
            xr, *_ = jax.lax.while_loop(cond, body, init)
        xl = jnp.einsum(
            "del,el->dl", h_inv, g_l - self._wt_apply(wparts, xr)
        )
        return self._finalize(xr, xl)


@dataclasses.dataclass
class _FastBatch:
    """Host-precomputed structure for the gather/one-hot fast assembly path
    of a BA-shaped batch (one reduced slot + one eliminated slot).

    This path replaces duplicate-index scatters with
    (a) a per-landmark observation table ``obs_table [L, K]`` so
    landmark-keyed reductions become gathers + dense sums, and
    (b) one-hot matmuls over the reduced-variable id for the camera-keyed
    reductions, followed by unique-index block scatters.  Whether that
    beats scatter-add with atomics on the GPU is an open measurement
    (ROADMAP)."""

    r_slot: int  # index of the reduced dependency slot
    n_r: int  # reduced family size
    obs_table: np.ndarray  # [L, K] batch-row ids (out-of-range = padding)
    rvid: np.ndarray  # [B] reduced var id (n_r = dustbin for fixed/masked)
    row_base: np.ndarray  # [n_r] global tangent offset per reduced var (dustbin→dr)
    cam_table: np.ndarray = None  # [n_r, Kc] batch-row ids keyed by rvid
    # When the batch is obs-major packed (column l·K + j = j-th cost of
    # landmark l; see ``obs_major_repack``), the run length K: landmark
    # reductions become reshape + minor-axis sums with NO gather.  None =
    # use obs_table.
    obs_k: int = None
    # Dual-sorted direct assembly (obs_k batches only): a second repack of
    # the SAME costs in camera-run order, so the a_rr/b_r reductions are
    # also reshape + minor-axis sums — at the price of evaluating the
    # residual Jacobian twice.
    cam_batch: Any = None
    cam_k: int = None
    # Camera-repack column permutation over the (repacked) batch rows —
    # lets runtime-masked views map their mask into cam_batch's order.
    cam_take: Any = None
    # Bucketed obs-major layout (skewed/real-BAL degree distributions):
    # tuple of ``(l_base, L_b, k_b, col_base)`` runs — landmark ``l`` in
    # ``[l_base, l_base + L_b)`` owns columns ``col_base + (l − l_base)·k_b
    # + j``.  Landmark ids are relabeled degree-descending at layout time
    # (engine.build_layout order_key) so each power-of-two degree class is
    # a contiguous id range; heavy landmarks (> _OBS_BUCKET_K_CAP obs) get
    # extra full-K chunk buckets over the same (prefix) id range, whose
    # partial sums simply accumulate.  None for uniform batches (single
    # implicit bucket ``(0, L, obs_k, 0)``).
    buckets: tuple = None
    extra_base: int = None  # first fixed-landmark-extras column (buckets only)
    # Eliminated-family slot index within batch.manifolds (2-slot batches:
    # 1 - r_slot; 3-slot adaptive batches: slot 0 is the kernel).
    e_slot: int = None
    # Adaptive (kernel, reduced, eliminated) batches with ONE shared kernel
    # variable: its global tangent rows [kdof] (dustbin dr when fixed) —
    # the kernel's diag/grad/cross blocks then land via single reductions
    # instead of B duplicate scatters.
    kernel_rows: Any = None


@dataclasses.dataclass
class SchurInfo:
    """Static structure for Schur assembly.  ``implicit=True`` selects the
    matrix-free reduced solve (:class:`SchurCGOps`); otherwise the dense-W
    direct elimination (:class:`SchurOps`)."""

    elim_family: str
    dim_reduced: int  # Dr
    num_elim: int  # L
    dof_elim: int  # dl
    elim_ids: dict  # family name -> [n] landmark ids (L = dustbin) for elim fam
    implicit: bool = False
    fam_offsets: tuple = ()  # reduced-family (name, offsets, dof) for precond
    pad: int = 1
    fast: tuple = ()  # per-batch _FastBatch or None, aligned with batches
    # Per-wpart fam_offsets index of the (single) reduced slot's family, for
    # the Schur-Jacobi preconditioner; None = correction unavailable.
    wpart_fam: tuple = ()
    # Per-wpart obs-major run length (None = not obs-major / not uniform);
    # cluster-Jacobi requires uniform runs (see SchurCGOps.wpart_obs_k).
    wpart_obs_k: tuple = ()
    # Per-wpart obs-major run buckets (see SchurCGOps.wpart_buckets); set
    # exactly when the dual assembly path built a cm-layout wpart.
    wpart_buckets: tuple = ()
    def ops(self):
        if self.implicit:
            import os

            fixed = os.environ.get("NLLSTPU_CG_FIXED_ITERS")
            chunk = os.environ.get("NLLSTPU_CG_CHUNK_ITERS")
            return SchurCGOps(
                self.dim_reduced,
                self.num_elim,
                self.dof_elim,
                pad=self.pad,
                fam_offsets=self.fam_offsets,
                wpart_fam=self.wpart_fam,
                wpart_obs_k=self.wpart_obs_k,
                wpart_buckets=self.wpart_buckets,
                fixed_iters=int(fixed) if fixed else None,
                chunk_iters=int(chunk) if chunk else None,
            )
        return SchurOps(self.dim_reduced, self.num_elim, self.dof_elim)


#: Fast-path guards: transient one-hot memory cap (elements) and
#: observation-table skew caps (per-landmark / per-camera).
_FAST_MAX_ONEHOT = 64 * 1024 * 1024  # elements
_FAST_MAX_K = 512
_FAST_MAX_CAM_K = 8192
#: Obs-major repack guard: max padded-columns-to-real-costs compute ratio.
_OBS_MAJOR_MAX_RATIO = 2.5
#: Bucketed layout: per-bucket run-length cap; heavier landmarks get chunk
#: buckets.  It sets how many buckets (and so how many separate reshape-sum
#: and one-hot contractions) a skewed layout has, and how much padding the
#: widest classes carry.  The value 64 was sized for a kernel that has since
#: been removed; it is untuned for the XLA paths on the GPU (ROADMAP §3).
_OBS_BUCKET_K_CAP = 64


class ObsBuckets(NamedTuple):
    """Bucketed obs-major column layout (see ``_FastBatch.buckets``)."""

    buckets: tuple  # ((l_base, L_b, k_b, col_base), ...)
    extra_base: int  # first column of the fixed-landmark extras region
    uniform_k: Any  # run length when single-bucket-covering-all-L, else None
    # Column permutation: repacked column j holds original row take[j]
    # (pad slots point at row 0 and carry mask False) — lets runtime-masked
    # views (SubproblemView) map original-order cost masks into the
    # repacked order.
    take: Any = None


def _plan_obs_buckets(counts):
    """Bucket plan over DESCENDING per-landmark counts: power-of-two degree
    classes (contiguous id ranges by monotonicity) plus full-K_CAP chunk
    buckets over the heavy prefix.  Returns a list of
    ``(l_base, L_b, k_b, obs_offset)`` where ``obs_offset`` is the first
    observation index of each landmark carried by that bucket."""
    L = counts.shape[0]
    cap = _OBS_BUCKET_K_CAP

    def ceil8(x):
        return -(-int(x) // 8) * 8

    plan = []
    # Chunk buckets j = 1.. over the heavy prefix {l : c_l > j·cap}; the
    # run width is capped at the widest remaining window (ceil-8).
    j = 1
    while True:
        h = int(np.sum(counts > j * cap))
        if h == 0:
            break
        width = min(cap, ceil8(int(counts[0]) - j * cap))
        plan.append((0, h, width, j * cap))
        j += 1
    # Power-of-two classes over min(c, cap) for all landmarks with c > 0;
    # each class's run width is tightened to its actual max count (ceil-8)
    # — pow2 is just the grouping key, and e.g. a 96-track class must not
    # pad to 128 (25% wasted compute).
    base = np.minimum(counts, cap)
    cls = np.where(base > 0, 2 ** np.ceil(np.log2(np.maximum(base, 1))), 0)
    cls = cls.astype(np.int64)
    start = 0
    while start < L and cls[start] > 0:
        k_cls = int(cls[start])
        end = start + int(np.sum(cls[start:] == k_cls))
        k_b = min(k_cls, max(ceil8(int(counts[start])), 1))
        plan.append((start, end - start, k_b, 0))
        start = end
    return plan


def obs_major_repack(batch, info: "SchurInfo"):
    """Host-side reorder + pad of a BA-shaped batch into landmark-run
    ("obs-major") column order: column ``col_base + (l − l_base)·K_b + j``
    holds the j-th cost of landmark ``l`` in its bucket (mask False beyond
    its count); real costs whose landmark is fixed are appended after the
    buckets.  Landmark-keyed reductions over an obs-major batch are a
    reshape + minor-axis sum — no gather at all; the batch *order* is the
    one free axis.  This is the descendant of the reference's
    ``reordercostsforschur!`` (src/problem.jl:177-199), which likewise
    sorts costs by their single Schur variable.

    Uniform degree distributions get ONE bucket ``(0, L, K, 0)`` (the
    round-1..3 layout, bit-identical).  Skewed (real-BAL) distributions —
    where padding every landmark to the max track length would blow the
    ``_OBS_MAJOR_MAX_RATIO`` compute budget — get power-of-two degree-class
    buckets instead (≤ 2x padding within each class), which REQUIRES the
    landmark ids to be degree-descending (contiguous classes): the Schur
    compile relabels them via ``build_layout(order_key=...)``.

    Returns ``(repacked_batch, ObsBuckets)`` or ``(None, None)`` when the
    batch shape doesn't qualify (multi-slot costs, no landmarks, excessive
    padding even after bucketing)."""
    elim_slots = [
        i
        for i, m in enumerate(batch.manifolds)
        if family_name(m) == info.elim_family
    ]
    adaptive3 = (
        getattr(batch, "adaptive", False)
        and len(batch.manifolds) == 3
        and len(elim_slots) == 1
        and elim_slots[0] != 0
    )
    if (
        len(elim_slots) != 1
        or (len(batch.manifolds) != 2 and not adaptive3)
        or info.num_elim == 0
    ):
        return None, None
    e = elim_slots[0]
    mask = np.asarray(batch.mask)
    L = info.num_elim
    lid = np.asarray(info.elim_ids[info.elim_family])[np.asarray(batch.idx[e])]
    lid = np.where(mask, lid, L)
    extra = np.nonzero(mask & (lid == L))[0]  # real costs, fixed landmark
    rows_sorted, skey, counts, pos, k = _group_rows(lid, L)
    uniform_total = L * k + len(extra)
    if (
        k <= _FAST_MAX_K
        and uniform_total <= _OBS_MAJOR_MAX_RATIO * max(batch.n, 1)
    ):
        # Uniform-ish: single bucket, the legacy layout.
        cols = skey * k + pos
        b_new = -(-uniform_total // 8) * 8  # tile-friendly trailing pad
        take = np.zeros(b_new, dtype=np.int64)
        newmask = np.zeros(b_new, dtype=bool)
        take[cols] = rows_sorted
        newmask[cols] = True
        if len(extra):
            take[L * k : L * k + len(extra)] = extra
            newmask[L * k : L * k + len(extra)] = True
        meta = ObsBuckets(
            buckets=((0, L, k, 0),), extra_base=L * k, uniform_k=k,
            take=take,
        )
        return _apply_take(batch, take, newmask), meta
    # Skewed: bucketed layout.  Requires degree-descending landmark ids
    # (contiguous power-of-two classes) — compile_problem relabels them;
    # bail when it didn't (e.g. direct build_schur_info callers).
    if np.any(np.diff(counts) > 0):
        return None, None
    plan = _plan_obs_buckets(counts)
    total = sum(lb * kb for (_, lb, kb, _) in plan) + len(extra)
    if total > _OBS_MAJOR_MAX_RATIO * max(batch.n, 1):
        return None, None
    # Per-cost position within its landmark's run: obs j of landmark l goes
    # to the bucket whose [obs_offset, obs_offset + k_b) window contains j.
    take = np.zeros(-(-total // 8) * 8, dtype=np.int64)
    newmask = np.zeros(take.shape[0], dtype=bool)
    col_base = 0
    buckets = []
    for (l0, lb, kb, ob) in plan:
        in_b = (skey >= l0) & (skey < l0 + lb) & (pos >= ob) & (pos < ob + kb)
        cols = col_base + (skey[in_b] - l0) * kb + (pos[in_b] - ob)
        take[cols] = rows_sorted[in_b]
        newmask[cols] = True
        buckets.append((l0, lb, kb, col_base))
        col_base += lb * kb
    if len(extra):
        take[col_base : col_base + len(extra)] = extra
        newmask[col_base : col_base + len(extra)] = True
    meta = ObsBuckets(
        buckets=tuple(buckets), extra_base=col_base, uniform_k=None,
        take=take,
    )
    return _apply_take(batch, take, newmask), meta


def _apply_take(batch, take, newmask):
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[take] for i in batch.idx),
        params=None
        if batch.params is None
        else jtu.tree_map(lambda l: np.asarray(l)[take], batch.params),
        mask=newmask,
    )


def repack_batches_for_schur(batches, info: "SchurInfo"):
    """Apply :func:`obs_major_repack` where it qualifies, passing the rest
    through unchanged.  Returns ``(batches, metas)`` with per-batch
    :class:`ObsBuckets` (None where not repacked)."""
    out, metas = [], []
    for b in batches:
        nb, meta = obs_major_repack(b, info)
        out.append(nb if nb is not None else b)
        metas.append(meta)
    return out, metas


def elim_degree_counts(batches, problem, elim_manifold):
    """Per-variable observation counts of the (candidate) eliminated family
    over all W-producing batches — the ``order_key`` for the degree-sorted
    landmark relabel (see :func:`obs_major_repack`).

    KNOWN LIMITATION (ADVICE r4): the counts are summed over ALL batches,
    but ``obs_major_repack`` requires each INDIVIDUAL batch's counts to be
    non-increasing under the resulting order.  With several W-producing
    batches whose per-batch degree orders diverge, the non-dominant
    batches silently fail the monotonicity check inside the repack and
    fall back to the obs-table/scatter paths (performance only —
    correctness is unaffected).  Per-batch orders cannot be reconciled
    into one id relabel, so this is inherent; single-W-batch problems
    (every BAL-class workload) are unaffected."""
    elim_fam = family_name(elim_manifold)
    fam = problem._families.get(elim_fam)
    n = fam.n if fam is not None else 0
    counts = np.zeros(n, dtype=np.int64)
    for b in batches:
        eslots = [
            i
            for i, m in enumerate(b.manifolds)
            if family_name(m) == elim_fam
        ]
        if len(eslots) != 1 or len(b.manifolds) < 2:
            continue
        idx = np.asarray(b.idx[eslots[0]])[np.asarray(b.mask)]
        counts += np.bincount(idx, minlength=n)
    return counts


def _onehot_chunks(n_r, rows_per_chunk_elems, b):
    chunk = max(1, min(n_r, rows_per_chunk_elems // max(b, 1)))
    return [(start, min(chunk, n_r - start)) for start in range(0, n_r, chunk)]


def _fast_batch_data(batch, layout, info, meta=None):
    """Precompute the fast-path tables for one batch, or None when the batch
    shape doesn't qualify (multi-slot costs, oversized one-hot, extreme
    observation skew).  ``meta`` (an :class:`ObsBuckets` from the repack
    that produced this batch) marks a bucketed obs-major layout — landmark
    reductions then run per bucket and the dense observation table is not
    needed (nor buildable within its skew guard)."""
    elim_slots = [
        i
        for i, m in enumerate(batch.manifolds)
        if family_name(m) == info.elim_family
    ]
    adaptive3 = (
        getattr(batch, "adaptive", False)
        and len(batch.manifolds) == 3
        and len(elim_slots) == 1
        and elim_slots[0] != 0
    )
    if len(elim_slots) != 1 or (len(batch.manifolds) != 2 and not adaptive3):
        return None
    e = elim_slots[0]
    mask = np.asarray(batch.mask)
    kernel_rows = None
    if adaptive3:
        # Fast tables require ONE shared kernel variable (the common case:
        # one adaptive kernel jointly fit over the whole batch) so its
        # blocks reduce once; per-cost kernels fall back to the generic
        # scatter path.
        kidx = np.asarray(batch.idx[0])[mask]
        if kidx.size == 0 or np.unique(kidx).size != 1:
            return None
        kfam = family_name(batch.manifolds[0])
        koff = int(np.asarray(layout.offsets[kfam])[kidx[0]])
        kdof = batch.manifolds[0].dof
        kernel_rows = np.minimum(
            koff + np.arange(kdof, dtype=np.int32), info.dim_reduced
        ).astype(np.int32)
        r_slot = 3 - e  # the non-kernel, non-eliminated slot
    else:
        r_slot = 1 - e
    rman = batch.manifolds[r_slot]
    rfam = family_name(rman)
    n_r = int(layout.unfixed[rfam].shape[0])
    b_pad = batch.n_padded
    lid = np.asarray(info.elim_ids[info.elim_family])[np.asarray(batch.idx[e])]
    lid = lid.copy()
    lid[~mask] = info.num_elim
    if info.num_elim == 0:
        return None

    obs_table = None
    obs_k = None
    buckets = extra_base = None
    if meta is not None and meta.uniform_k is None:
        buckets, extra_base = meta.buckets, meta.extra_base
    else:
        sorted_rows, sorted_lid, counts, pos, k = _group_rows(
            lid, info.num_elim
        )
        if k > _FAST_MAX_K or info.num_elim * k > 8 * max(len(sorted_rows), 1):
            return None
        obs_table = np.full((info.num_elim, k), b_pad, dtype=np.int32)
        obs_table[sorted_lid, pos] = sorted_rows

        # Obs-major detection (see obs_major_repack): the table is exactly
        # the contiguous pattern l·K + j ⇒ landmark reductions need no
        # gather.
        contiguous = np.where(
            np.arange(k)[None, :] < counts[:, None],
            np.arange(info.num_elim)[:, None] * k + np.arange(k)[None, :],
            b_pad,
        )
        obs_k = k if (
            info.num_elim * k <= b_pad and np.array_equal(obs_table, contiguous)
        ) else None

    off_r = np.asarray(layout.offsets[rfam])
    rvid = np.asarray(batch.idx[r_slot]).astype(np.int32).copy()
    var_fixed = off_r[rvid] >= layout.dof_total
    rvid[(~mask) | var_fixed] = n_r  # dustbin id → all-zero one-hot row
    row_base = np.minimum(off_r, info.dim_reduced).astype(np.int32)
    cam_table = _key_table(rvid, n_r, b_pad, _FAST_MAX_CAM_K)
    cam_batch = cam_k = cam_take = None
    # The dual-sorted direct path (and the cm wpart layout keyed off
    # cam_batch's presence) applies only to components-major batches.
    if obs_k is not None and batch.batched == "cm":
        cam_batch, cam_k, cam_take = _cam_major_repack(batch, rvid, n_r)
    return _FastBatch(
        r_slot=r_slot,
        n_r=n_r,
        obs_table=obs_table,
        rvid=rvid,
        row_base=row_base,
        cam_table=cam_table,
        obs_k=obs_k,
        cam_batch=cam_batch,
        cam_k=cam_k,
        cam_take=cam_take,
        buckets=buckets,
        extra_base=extra_base,
        e_slot=e,
        kernel_rows=kernel_rows,
    )


def _cam_major_repack(batch, rvid, n_r):
    """Camera-run repack of an (obs-major) batch: column ``c·Kc + j`` holds
    the j-th cost touching unfixed reduced variable ``c``; costs with a
    dustbin rvid (masked, or fixed camera — no a_rr contribution) are
    dropped.  Returns (batch, Kc, take) or (None, None, None) on
    excessive skew."""
    if n_r == 0:
        return None, None, None
    rows_sorted, skey, counts, pos, kc = _group_rows(rvid, n_r)
    if kc > _FAST_MAX_CAM_K or n_r * kc > _OBS_MAJOR_MAX_RATIO * max(
        len(rows_sorted), 1
    ):
        return None, None, None
    cols = skey * kc + pos
    b_new = -(-(n_r * kc) // 8) * 8
    take = np.zeros(b_new, dtype=np.int64)
    newmask = np.zeros(b_new, dtype=bool)
    take[cols] = rows_sorted
    newmask[cols] = True
    return dataclasses.replace(
        batch,
        idx=tuple(np.asarray(i)[take] for i in batch.idx),
        params=None
        if batch.params is None
        else jtu.tree_map(lambda l: np.asarray(l)[take], batch.params),
        mask=newmask,
    ), kc, take


def _group_rows(keys, n_keys):
    """Host-side stable grouping of row indices by key (keys ≥ ``n_keys``
    are dropped): returns ``(rows_sorted, sorted_keys, counts, pos, k)``
    where ``pos`` is each row's rank within its key's run and ``k`` the
    maximum run length — the single primitive behind every dense key table
    and run repack in this module and ops/cg.py."""
    valid = np.nonzero(keys < n_keys)[0]
    counts = np.bincount(keys[valid], minlength=n_keys)
    k = int(max(counts.max(initial=0), 1))
    order = np.argsort(keys[valid], kind="stable")
    rows = valid[order]
    skey = keys[valid][order]
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(rows)) - np.repeat(starts, counts)
    return rows, skey, counts, pos, k


def _key_table(keys, n_keys, pad_value, max_k):
    """[n_keys, K] table of row ids grouped by key (pad = ``pad_value``);
    None when the per-key count is too skewed for a dense table."""
    if n_keys == 0:
        return None
    rows, skey, counts, pos, k = _group_rows(keys, n_keys)
    if k > max_k or n_keys * k > 8 * max(len(rows), 1):
        return None
    table = np.full((n_keys, k), pad_value, dtype=np.int32)
    table[skey, pos] = rows
    return table


def _generic_rvid(batch, layout, info):
    """Per-cost reduced-variable id for the Schur-Jacobi preconditioner on a
    two-slot batch without fast-path tables (fixed/masked → dustbin n_r)."""
    elim_slots = [
        i
        for i, m in enumerate(batch.manifolds)
        if family_name(m) == info.elim_family
    ]
    if len(elim_slots) != 1 or len(batch.manifolds) != 2:
        return None
    r_slot = 1 - elim_slots[0]
    rfam = family_name(batch.manifolds[r_slot])
    n_r = int(layout.unfixed[rfam].shape[0])
    # jnp throughout: batch.idx/mask may be traced under shard_map.
    idx = jnp.asarray(batch.idx[r_slot]).astype(jnp.int32)
    var_fixed = jnp.asarray(layout.offsets[rfam])[idx] >= layout.dof_total
    return jnp.where(
        jnp.asarray(batch.mask) & ~var_fixed, idx, jnp.int32(n_r)
    )


def _make_wpart(w_blk, rows_r, lid, fast=None, rvid=None):
    """Assemble a :class:`WPart`, with the fast-path tables when the batch
    has them."""
    obs = cam = row_base = None
    if fast is not None:
        rvid = jnp.asarray(fast.rvid) if rvid is None else rvid
        obs = None if fast.obs_table is None else jnp.asarray(fast.obs_table)
        cam = None if fast.cam_table is None else jnp.asarray(fast.cam_table)
        row_base = jnp.asarray(fast.row_base)
    return WPart(
        w_blk=w_blk,
        rows_r=rows_r,
        lid=lid,
        rvid=rvid,
        obs=obs,
        cam_obs=cam,
        row_base=row_base,
    )


def _fast_buckets(fast, info):
    """Obs-major run buckets of a fast batch (single implicit bucket for the
    uniform layout), or None when the batch is not obs-major packed."""
    if fast.buckets is not None:
        return fast.buckets
    if fast.obs_k is not None:
        return ((0, info.num_elim, fast.obs_k, 0),)
    return None


def build_schur_info(
    problem, layout: engine.Layout, elim_manifold, implicit: bool = False,
    batches=None, obs_meta=None,
) -> SchurInfo:
    """Derive the reduced/eliminated split from a layout built with the
    eliminated family ordered last (see ``build_layout(order_last=...)``)."""
    elim_fam = family_name(elim_manifold)
    dl = elim_manifold.dof
    offs = np.asarray(layout.offsets[elim_fam])
    unfixed = layout.unfixed[elim_fam]
    num_elim = int(unfixed.sum())
    dim_reduced = layout.dof_total - num_elim * dl
    ids = np.full(offs.shape[0], num_elim, dtype=np.int32)
    if num_elim:
        ids[unfixed] = (offs[unfixed] - dim_reduced) // dl
        assert (ids[unfixed] >= 0).all() and (ids[unfixed] < num_elim).all()
    fam_offsets = []
    if implicit:
        for name in problem.family_names():
            if name == elim_fam:
                continue
            fam_offsets.append(
                (name, layout.offsets[name], problem.manifold_of(name).dof)
            )
    info = SchurInfo(
        elim_family=elim_fam,
        dim_reduced=dim_reduced,
        num_elim=num_elim,
        dof_elim=dl,
        elim_ids={elim_fam: ids},
        implicit=implicit,
        fam_offsets=tuple(fam_offsets),
        pad=layout.pad,
    )
    if batches is not None:
        metas = obs_meta if obs_meta is not None else [None] * len(batches)
        info.fast = tuple(
            _fast_batch_data(b, layout, info, meta=m)
            for b, m in zip(batches, metas)
        )
        if implicit:
            # Mirror assemble_schur's wpart append order: one entry per
            # batch with exactly one eliminated slot; the entry is the
            # fam_offsets index of the single reduced slot's family when the
            # Schur-Jacobi correction applies (two-slot cost), else None.
            fam_index = {name: i for i, (name, _, _) in enumerate(fam_offsets)}
            wpart_fam = []
            wpart_obs_k = []
            wpart_buckets = []
            for bi, b in enumerate(batches):
                eslots = [
                    i
                    for i, m in enumerate(b.manifolds)
                    if family_name(m) == elim_fam
                ]
                if len(eslots) != 1:
                    continue
                # Must mirror the dual-path trigger in assemble_schur: the
                # cm wpart layout exists only when the dual path built it
                # (obs-major cm batch).
                f = info.fast[bi] if bi < len(info.fast) else None
                dual = (
                    f is not None
                    and getattr(b, "batched", None) == "cm"
                    and _fast_buckets(f, info) is not None
                    # Adaptive wparts would need a second (kernel-row)
                    # coupling block in the CG matvec; implicit adaptive
                    # batches keep the generic full-block wpart instead.
                    and not getattr(b, "adaptive", False)
                )
                wpart_buckets.append(
                    _fast_buckets(f, info) if dual else None
                )
                wpart_obs_k.append(f.obs_k if dual else None)
                if len(b.manifolds) == 2:
                    rfam = family_name(b.manifolds[1 - eslots[0]])
                    wpart_fam.append(fam_index.get(rfam))
                else:
                    wpart_fam.append(None)
            info.wpart_fam = tuple(wpart_fam)
            info.wpart_obs_k = tuple(wpart_obs_k)
            info.wpart_buckets = tuple(wpart_buckets)
    return info


def _w_dtype(dtype):
    """Storage dtype for the dense W coupling (``NLLSTPU_W_DTYPE`` ∈
    {auto, bf16, f16, f32}; ``auto`` = f32).  W dominates the direct
    solve's device-memory traffic (one write plus several streamed reads
    per LM iteration); a 16-bit W halves those bytes while every
    contraction consuming it still accumulates in f32.

    16-bit W is an OPT-IN, not the default: on realistic Snavely-shaped
    problems the ~2⁻⁸ bf16 W error caps convergence well above the noise
    floor (Ladybug shape, 60 LM iterations on the CPU: best cost 0.130 bf16
    vs 0.0230 f32 against a 0.0346 floor).  The knob is ignored for f64
    problems (reference 1e-15 targets)."""
    import os

    if dtype != jnp.float32:
        return dtype
    knob = os.environ.get("NLLSTPU_W_DTYPE", "auto")
    if knob == "bf16":
        return jnp.bfloat16
    if knob == "f16":
        # Same half-width traffic as bf16 but with a 10+1-bit mantissa
        # (relative step 4.9e-4 vs bf16's 3.9e-3), traded for range (max
        # 65504 — W entries are Jacobian products, bounded by the f-scaled
        # reprojection magnitudes).
        return jnp.float16
    return dtype


def _onehot_reduced_tail(jac, g0, d1m, d2m, rvid, robust_block, sel_r, fast,
                         row_idx, dtype, a_rr, b_r):
    """a_rr/b_r contributions of a column range via the chunked one-hot
    contraction over the reduced-variable id (dustbin rvid drops masked and
    fixed-camera costs); lands with the unique row_base scatter."""
    ha = robust_block(jac, g0, d1m, d2m, sel_r, sel_r)  # [Sr, Sr, B]
    gr = g0[sel_r] * d1m  # [Sr, B]
    bsz = rvid.shape[0]
    a_parts, b_parts = [], []
    for cstart, width in _onehot_chunks(fast.n_r, _FAST_MAX_ONEHOT, bsz):
        oh = (
            (cstart + jnp.arange(width, dtype=jnp.int32))[:, None]
            == rvid[None, :]
        ).astype(dtype)  # [width, B]
        a_parts.append(
            jnp.einsum("vb,pqb->vpq", oh, ha, precision="highest")
        )
        b_parts.append(jnp.einsum("vb,pb->vp", oh, gr, precision="highest"))
    a_rr = a_rr.at[row_idx[:, :, None], row_idx[:, None, :]].add(
        jnp.concatenate(a_parts, axis=0)
    )
    b_r = b_r.at[row_idx].add(jnp.concatenate(b_parts, axis=0))
    return a_rr, b_r


def _assemble_fast_dual(
    batch, variables, layout, info, fast, e, dtype,
    a_rr, b_r, h_ll, g_l, w,
):
    """Dual-sorted direct assembly of one BA-shaped cm batch (the
    speed-of-light path): every reduction is either a contiguous
    reshape + minor-axis sum or a unique-index scatter.

    * The obs-major leg (landmark runs of length K) produces h_ll, g_l and
      the W coupling: robustified blocks are composed per OUTPUT directly
      from the Jacobian — the shared [S, S, B] per-cost Hessian is never
      materialized — and W lands via a one-hot contraction over the run
      slots plus a unique-row permutation scatter.
    * The camera-major leg (``fast.cam_batch``, runs of length Kc) re-
      evaluates the Jacobian in camera order so a_rr/b_r are also pure
      reshape-sums, at twice the residual work.

    Returns ``(cost, sys)`` or None when the batch is not components-major
    batched (caller falls back)."""
    buckets = _fast_buckets(fast, info)
    raw = engine.batch_res_jac_cm(
        batch, variables, dtype,
        runs=(e, buckets),
    )
    if raw is None:
        return None
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    # Jacobian tangent space excludes the kernel slot of adaptive batches
    # (its blocks come from rho_dkernel_cm, placed separately below).
    jac_manifolds = batch.manifolds[1:] if batch.adaptive else batch.manifolds
    e_jac = e - 1 if batch.adaptive else e
    dofs = [m.dof for m in jac_manifolds]
    start = sum(dofs[:e_jac])
    sel_e = np.arange(start, start + dl)
    sel_r = np.array(
        [i for i in range(sum(dofs)) if not (start <= i < start + dl)],
        dtype=np.int64,
    )
    dr_s = len(sel_r)

    def robust_block(jac, g0, d1m, d2m, sa, sb):
        """[len(sa), len(sb), B] robustified Hessian sub-block, composed
        fresh per output so it fuses into that output's reduction."""
        ja = jac[:, sa, :]
        jb = jac[:, sb, :]
        jj = jnp.einsum("npb,nqb->pqb", ja, jb)
        return jj * d1m + d2m * (g0[sa][:, None, :] * g0[sb][None, :, :])

    # --- obs-major leg: cost, h_ll, g_l, W --------------------------------
    cost_sum, r, jac, g0, d1, d2, kern = raw
    mval = jnp.asarray(batch.mask).astype(dtype)
    d1m = d1 * mval
    d2m = 2.0 * d2 * mval

    def runs_sum(x, out):
        """Accumulate per-landmark run sums of ``x [..., B]`` into ``out``
        (landmark-minor) via bucketed reshape + minor-axis sums — the
        static bucket slices keep every reduction contiguous."""
        for (l0, lb, kb, c0) in buckets:
            seg = x[..., c0 : c0 + lb * kb].reshape(
                x.shape[:-1] + (lb, kb)
            ).sum(axis=-1)
            out = out.at[..., l0 : l0 + lb].add(seg)
        return out

    wpart = None
    identity_rows = False
    if not info.implicit:
        n_r = fast.n_r
        row_flat = (
            np.asarray(fast.row_base)[:, None]
            + np.arange(dr_s, dtype=np.int32)[None, :]
        ).reshape(-1)
        identity_rows = np.array_equal(
            row_flat, np.arange(n_r * dr_s, dtype=np.int32)
        )
    he = robust_block(jac, g0, d1m, d2m, sel_e, sel_e)
    h_ll = runs_sum(he, h_ll)
    g_l = runs_sum(g0[sel_e] * d1m, g_l)

    if info.implicit:
        # Implicit: keep the per-cost coupling blocks components-major
        # [Sr, dl, B] (masked columns are exactly zero via the masked
        # d1/d2) — the CG matvecs consume this layout directly
        # (SchurCGOps.wpart_obs_k), no batch-major transpose materialized.
        w_cm = robust_block(jac, g0, d1m, d2m, sel_r, sel_e)
        rows = engine._batch_rows(batch, layout)
        rows_r = jnp.where(rows[:, sel_r] >= dr, dr, rows[:, sel_r])
        lid = jnp.asarray(info.elim_ids[info.elim_family])[batch.idx[e]]
        lid = jnp.where(batch.mask, lid, jnp.int32(L))
        lid = jnp.where(rows[:, sel_e[0]] >= layout.dof_total, jnp.int32(L), lid)
        wpart = WPart(
            w_blk=w_cm,
            rows_r=rows_r,
            lid=lid,
            rvid=jnp.asarray(fast.rvid),
            obs=None,
            cam_obs=None if fast.cam_table is None else jnp.asarray(fast.cam_table),
            row_base=jnp.asarray(fast.row_base),
        )
    else:
        # W: one-hot contraction over the run slots, landing with a
        # permutation scatter of unique rows — or a plain contiguous add
        # when every camera is unfixed (the permutation is the identity).
        # One contraction per bucket; chunked heavy landmarks simply
        # accumulate into the same W rows.
        we_full = robust_block(jac, g0, d1m, d2m, sel_r, sel_e)
        rvid_np = jnp.asarray(fast.rvid)
        for (l0, lb, kb, c0) in buckets:
            we = we_full[:, :, c0 : c0 + lb * kb].reshape(
                dr_s, dl, lb, kb
            )
            vc = rvid_np[c0 : c0 + lb * kb].reshape(lb, kb)
            w_parts = []
            for cstart, width in _onehot_chunks(
                n_r, _FAST_MAX_ONEHOT, lb * kb
            ):
                oh_w = (
                    vc[:, :, None]
                    == (cstart + jnp.arange(width, dtype=jnp.int32))[None, None, :]
                ).astype(dtype)  # [L_b, K_b, width]
                w_parts.append(
                    jnp.einsum(
                        "pdlk,lkv->dlvp", we, oh_w, precision="highest"
                    )
                )
            w_blocks = jnp.concatenate(w_parts, axis=2)
            if identity_rows:
                w = w.at[:, l0 : l0 + lb, : n_r * dr_s].add(
                    w_blocks.reshape(dl, lb, n_r * dr_s)
                )
            else:
                w_add = jnp.zeros((dl, lb, w.shape[-1]), dtype=dtype)
                w_add = w_add.at[:, :, jnp.asarray(row_flat)].add(
                    w_blocks.reshape(dl, lb, n_r * dr_s)
                )
                w = w.at[:, l0 : l0 + lb].add(w_add)

    if kern is not None and not info.implicit:
        # Adaptive-kernel blocks (reference src/residual.jl:103-107 layout,
        # unhalved, unweighted-gradient cross), each via a SINGLE reduction
        # instead of B duplicate scatters into the same rows:
        #   kk / g_k    : plain sums over the batch;
        #   kernel-cam  : chunked one-hot contraction per camera;
        #   kernel-pt   : per-bucket run reshape-sums into W's kernel
        #                 columns (the kernel is a REDUCED variable, so its
        #                 point coupling is ordinary W data).
        dgrad, dhess = kern
        kdof = dgrad.shape[0] - 1
        kr = jnp.asarray(fast.kernel_rows)
        dga = dgrad[:kdof] * mval
        dha = dhess[:kdof, :kdof] * mval
        dcross = dhess[:kdof, kdof] * mval  # [k, B]
        a_rr = a_rr.at[kr[:, None], kr[None, :]].add(jnp.sum(dha, axis=-1))
        b_r = b_r.at[kr].add(jnp.sum(dga, axis=-1))
        m_b = g0[sel_r][:, None, :] * dcross[None, :, :]  # [dr_s, k, B]
        rvid_j = jnp.asarray(fast.rvid)
        parts = []
        for cstart, width in _onehot_chunks(
            fast.n_r, _FAST_MAX_ONEHOT, rvid_j.shape[0]
        ):
            oh = (
                (cstart + jnp.arange(width, dtype=jnp.int32))[:, None]
                == rvid_j[None, :]
            ).astype(dtype)
            parts.append(
                jnp.einsum("vb,pkb->vpk", oh, m_b, precision="highest")
            )
        cr = jnp.concatenate(parts, axis=0)  # [n_r, dr_s, k]
        row_idx_k = (
            jnp.asarray(fast.row_base)[:, None]
            + jnp.arange(dr_s, dtype=jnp.int32)[None, :]
        )
        a_rr = a_rr.at[row_idx_k[:, :, None], kr[None, None, :]].add(cr)
        a_rr = a_rr.at[kr[None, None, :], row_idx_k[:, :, None]].add(cr)
        m_e = g0[sel_e][:, None, :] * dcross[None, :, :]  # [dl, k, B]
        for (l0, lb, kb, c0) in buckets:
            seg = (
                m_e[..., c0 : c0 + lb * kb]
                .reshape(dl, kdof, lb, kb)
                .sum(-1)
            )  # [dl, k, L_b]
            w = w.at[:, l0 : l0 + lb, kr].add(seg.transpose(0, 2, 1))

    if fast.cam_batch is not None:
        return cost_sum, _fast_dual_cam_leg(
            fast, variables, dtype, robust_block, sel_r, dr_s,
            a_rr, b_r, h_ll, g_l, w,
        ), wpart
    # No camera-major repack (skewed camera degrees, or a bucketed batch):
    # a_rr/b_r via the chunked one-hot contraction over the SAME
    # obs-major Jacobian — no second Jacobian evaluation, one transient
    # [width, B] one-hot per chunk (extras and pad columns ride along via
    # the dustbin rvid).
    row_idx = (
        jnp.asarray(fast.row_base)[:, None]
        + jnp.arange(dr_s, dtype=jnp.int32)[None, :]
    )  # [n_r, dr_s]; fixed vars point at the pad row dr
    a_rr, b_r = _onehot_reduced_tail(
        jac, g0, d1m, d2m, jnp.asarray(fast.rvid), robust_block, sel_r,
        fast, row_idx, dtype, a_rr, b_r,
    )
    return cost_sum, (a_rr, b_r, h_ll, g_l, w), wpart


def _fast_dual_cam_leg(fast, variables, dtype, robust_block, sel_r, dr_s,
                       a_rr, b_r, h_ll, g_l, w):
    """Camera-major leg of the dual-sorted assembly: a_rr and b_r as pure
    reshape-sums over camera runs (cost NOT re-counted; the Jacobian is
    evaluated a second time in camera order — docstring above).  The
    camera slot gather broadcasts over the camera runs (one gather per
    camera instead of per cost)."""
    raw2 = engine.batch_res_jac_cm(
        fast.cam_batch, variables, dtype,
        runs=(fast.r_slot, ((0, fast.n_r, fast.cam_k, 0),)),
    )
    _, _, jac2, g02, d1_2, d2_2, _ = raw2
    m2 = jnp.asarray(fast.cam_batch.mask).astype(dtype)
    d1m2 = d1_2 * m2
    d2m2 = 2.0 * d2_2 * m2
    n_r, kc = fast.n_r, fast.cam_k

    def cam_runs(x):
        return x[..., : n_r * kc].reshape(x.shape[:-1] + (n_r, kc))

    ha = robust_block(jac2, g02, d1m2, d2m2, sel_r, sel_r)
    a_blocks = jnp.sum(cam_runs(ha), axis=-1)  # [Sr, Sr, n_r]
    b_blocks = jnp.sum(cam_runs(g02[sel_r] * d1m2), axis=-1)  # [Sr, n_r]
    row_idx = (
        jnp.asarray(fast.row_base)[:, None]
        + jnp.arange(dr_s, dtype=jnp.int32)[None, :]
    )  # [n_r, dr_s]; fixed vars point at the pad row dr
    a_rr = a_rr.at[row_idx[:, :, None], row_idx[:, None, :]].add(
        jnp.transpose(a_blocks, (2, 0, 1))
    )
    b_r = b_r.at[row_idx].add(b_blocks.T)
    return (a_rr, b_r, h_ll, g_l, w)


def assemble_schur(batches, variables, layout: engine.Layout, info: SchurInfo,
                   dtype, w_dtype=None):
    """Assemble ``(cost, (a_rr, b_r, h_ll, g_l, w))``.

    ``w_dtype`` overrides the dense-W storage dtype (None → the
    ``NLLSTPU_W_DTYPE`` knob via :func:`_w_dtype`); the sharded callers pin
    it to ``dtype`` because their per-device W contributions are psum-reduced
    and a pre-reduction downcast would stack rounding error across devices.

    Reuses the per-batch block computation of the dense path
    (``engine.batch_grad_hess``) and splits each cost's block into
    reduced-reduced (scatter-add), landmark-diagonal and gradient pieces
    (segment-sum keyed by landmark id) and the W coupling (two-index
    scatter-add) — the replacement for the reference's per-block BSM
    scatter (src/linearsystem.jl:132-175)."""
    dr, L, dl = info.dim_reduced, info.num_elim, info.dof_elim
    pad = layout.pad
    a_rr = jnp.zeros((dr + pad, dr + pad), dtype=dtype)
    b_r = jnp.zeros(dr + pad, dtype=dtype)
    # Eliminated blocks accumulate components-major (see module docstring):
    # the landmark axis stays minor.
    h_ll = jnp.zeros((dl, dl, L + 1), dtype=dtype)
    g_l = jnp.zeros((dl, L + 1), dtype=dtype)
    w = (
        None
        if info.implicit
        else jnp.zeros((dl, L + 1, dr + pad), dtype=dtype)
    )
    wparts = []
    total = jnp.zeros((), dtype=dtype)
    wi = -1  # index into info.wpart_* (single-elim-slot batches, in order)

    for bi, batch in enumerate(batches):
        elim_slots = [
            i for i, m in enumerate(batch.manifolds)
            if family_name(m) == info.elim_family
        ]
        if len(elim_slots) == 1:
            wi += 1
        fast0 = info.fast[bi] if bi < len(info.fast) else None
        buckets0 = _fast_buckets(fast0, info) if fast0 is not None else None
        # Every obs-major cm batch takes the dual path — a_rr/b_r come from
        # the camera-major leg when the repack qualified, from the
        # chunked one-hot fallback (skewed camera degrees never disqualify
        # the obs-major leg).  The implicit backend takes it exactly when
        # build_schur_info mirrored a cm wpart layout for this batch
        # (SchurCGOps.wpart_buckets) — the sharded local infos pin that
        # mirror empty because their ops consume batch-major wparts.
        if (
            len(elim_slots) == 1
            and fast0 is not None
            and buckets0 is not None
            and (
                not info.implicit
                or (
                    wi < len(info.wpart_buckets)
                    and info.wpart_buckets[wi] is not None
                )
            )
        ):
            c = _assemble_fast_dual(
                batch, variables, layout, info, fast0, elim_slots[0],
                dtype, a_rr, b_r, h_ll, g_l, w,
            )
            if c is not None:
                total = total + c[0]
                a_rr, b_r, h_ll, g_l, w = c[1]
                if c[2] is not None:
                    wparts.append(c[2])
                continue
        # Per-cost blocks arrive components-major ([S, B] / [S, S, B]), the
        # batch axis minor.
        c, g_cm, h_cm, rows = engine.batch_grad_hess_cm(
            batch, variables, layout, dtype
        )
        total = total + c
        if not elim_slots:
            # Pure-reduced batch: rows are already reduced offsets (< dr) or
            # dustbin; the dustbin (layout.dof_total = dr + L·dl) must be
            # remapped into this system's pad region.  Block scatters need
            # batch-major operands; these batches are small by construction.
            rows = jnp.where(rows >= dr, dr, rows)
            a_rr = a_rr.at[rows[:, :, None], rows[:, None, :]].add(
                jnp.moveaxis(h_cm, -1, 0)
            )
            b_r = b_r.at[rows].add(g_cm.T)
            continue
        if len(elim_slots) > 1:
            raise ValueError(
                "Schur elimination requires at most one eliminated variable "
                "per cost (reference src/problem.jl:185)"
            )
        e = elim_slots[0]
        # Static positions of the eliminated segment within the block.
        dofs = [m.dof for m in batch.manifolds]
        start = sum(dofs[:e])
        sel_e = np.arange(start, start + dl)
        sel_r = np.array(
            [i for i in range(sum(dofs)) if not (start <= i < start + dl)],
            dtype=np.int64,
        )
        # Landmark ids per cost (masked/fixed → dustbin L).
        lid = jnp.asarray(info.elim_ids[info.elim_family])[batch.idx[e]]
        lid = jnp.where(batch.mask, lid, jnp.int32(L))
        # Reduced rows per cost: drop the eliminated segment; remap any
        # global/dustbin index >= dr into the pad region.
        rows_r = rows[:, sel_r]
        rows_r = jnp.where(rows_r >= dr, dr, rows_r)

        h_rr_cm = h_cm[sel_r[:, None], sel_r[None, :], :]  # [Sr, Sr, B]
        h_le_cm = h_cm[sel_e[:, None], sel_e[None, :], :]  # [dl, dl, B]
        w_blk_cm = h_cm[sel_r[:, None], sel_e[None, :], :]  # [Sr, dl, B]
        g_r_cm = g_cm[sel_r]  # [Sr, B]
        g_e_cm = g_cm[sel_e]  # [dl, B]
        # If the eliminated variable of a cost is FIXED, its h_le/w/g_e parts
        # must be dropped (its rows were already dustbinned in `rows`, so
        # detect via the original row of the eliminated segment).
        elim_fixed = rows[:, sel_e[0]] >= layout.dof_total
        lid = jnp.where(elim_fixed, jnp.int32(L), lid)

        fast = info.fast[bi] if bi < len(info.fast) else None
        # The gather/one-hot branch below assumes 2-slot row geometry
        # (row_base + contiguous dr_s); 3-slot adaptive batches that didn't
        # take the dual path (implicit backend) use the generic scatters.
        if fast is not None and len(batch.manifolds) == 2:
            # Gather/one-hot fast path (see _FastBatch), in place of
            # duplicate-index scatters:
            #  * camera-keyed sums are a one-hot matmul over the
            #    reduced-variable id, then land with a UNIQUE-index scatter;
            #  * landmark-keyed sums become gathers through the [L, K]
            #    observation table plus a dense axis-sum.
            # All reductions contract over the minor [B] axis of the cm
            # blocks — nothing batch-major is ever materialized.
            dr_s = len(sel_r)
            # One-hot matmuls chunked over the variable axis so transient
            # [chunk, B] memory stays bounded at BAL scale.
            rvid = jnp.asarray(fast.rvid)
            bsz = rvid.shape[0]
            a_parts, b_parts = [], []
            for start, width in _onehot_chunks(fast.n_r, _FAST_MAX_ONEHOT, bsz):
                oh = (
                    (start + jnp.arange(width, dtype=jnp.int32))[:, None]
                    == rvid[None, :]
                ).astype(dtype)  # [width, B]; dustbin columns are all-zero
                a_parts.append(
                    jnp.einsum("vb,pqb->vpq", oh, h_rr_cm, precision="highest")
                )
                b_parts.append(
                    jnp.einsum("vb,pb->vp", oh, g_r_cm, precision="highest")
                )
            a_blocks = jnp.concatenate(a_parts, axis=0)
            b_blocks = jnp.concatenate(b_parts, axis=0)
            row_idx = (
                jnp.asarray(fast.row_base)[:, None]
                + jnp.arange(dr_s, dtype=jnp.int32)[None, :]
            )  # [n_r, dr_s]; fixed vars point at the pad row dr
            a_rr = a_rr.at[row_idx[:, :, None], row_idx[:, None, :]].add(a_blocks)
            b_r = b_r.at[row_idx].add(b_blocks)

            k = fast.obs_k or (
                fast.obs_table.shape[1] if fast.obs_table is not None else None
            )
            fbuckets = _fast_buckets(fast, info)
            if fbuckets is not None:
                # Obs-major batch: each bucket's landmark runs are a pure
                # reshape, NO gather (uniform batches are one bucket).
                # Padding columns hold garbage (copied row-0 values) and
                # must be zeroed via the mask; the camera one-hot needs no
                # masking (masked rvid is the all-zero dustbin column).
                mval = jnp.asarray(batch.mask).astype(dtype)

                def landmark_runs_add(x, out, masked=True):
                    if masked:
                        x = x * mval
                    for (l0, lb, kb, c0) in fbuckets:
                        seg = x[..., c0 : c0 + lb * kb].reshape(
                            x.shape[:-1] + (lb, kb)
                        ).sum(axis=-1)
                        out = out.at[..., l0 : l0 + lb].add(seg)
                    return out

                h_ll = landmark_runs_add(h_le_cm, h_ll)
                g_l = landmark_runs_add(g_e_cm, g_l)
            else:
                tk = jnp.asarray(fast.obs_table.reshape(-1))

                def table_gather_cm(x):
                    # x [..., B] → [..., L, k]; gather along the minor axis
                    # so the whole reduction stays components-major.
                    flat = jnp.take(x, tk, axis=-1, mode="fill", fill_value=0)
                    return flat.reshape(x.shape[:-1] + (L, k))

                h_ll = h_ll.at[:, :, :L].add(
                    jnp.sum(table_gather_cm(h_le_cm), axis=-1)
                )
                g_l = g_l.at[:, :L].add(
                    jnp.sum(table_gather_cm(g_e_cm), axis=-1)
                )
            if info.implicit:
                wparts.append(
                    _make_wpart(
                        jnp.transpose(w_blk_cm, (2, 0, 1)),  # [B, Sr, dl]
                        rows_r, lid, fast=fast,
                    )
                )
            else:
                if fbuckets is not None:
                    # Masked costs need no zeroing here: their rvid is the
                    # all-zero dustbin one-hot column.
                    rvid_j = jnp.asarray(fast.rvid)
                    flat_rows = row_idx.reshape(-1)  # unique per (v, p)
                    for (l0, lb, kb, c0) in fbuckets:
                        wc = w_blk_cm[:, :, c0 : c0 + lb * kb].reshape(
                            dr_s, dl, lb, kb
                        )
                        vc = rvid_j[c0 : c0 + lb * kb].reshape(lb, kb)
                        w_parts = []
                        for start, width in _onehot_chunks(
                            fast.n_r, _FAST_MAX_ONEHOT, lb * kb
                        ):
                            oh_w = (
                                vc[:, :, None]
                                == (start + jnp.arange(width, dtype=jnp.int32))[None, None, :]
                            ).astype(dtype)  # [L_b, K_b, width]
                            w_parts.append(
                                jnp.einsum(
                                    "pdlk,lkv->dlvp", wc, oh_w,
                                    precision="highest",
                                )
                            )  # [dl, L_b, width, dr_s]
                        w_blocks = jnp.concatenate(w_parts, axis=2)
                        w_add = jnp.zeros((dl, lb, dr + pad), dtype=dtype)
                        w_add = w_add.at[:, :, flat_rows].add(
                            w_blocks.reshape(dl, lb, fast.n_r * dr_s)
                        )
                        w = w.at[:, l0 : l0 + lb].add(w_add)
                    continue
                wc = table_gather_cm(w_blk_cm)  # [Sr, dl, L, K]
                vc = jnp.take(
                    jnp.asarray(fast.rvid), tk, mode="fill",
                    fill_value=fast.n_r,
                ).reshape(L, k)
                w_parts = []
                for start, width in _onehot_chunks(
                    fast.n_r, _FAST_MAX_ONEHOT, L * k
                ):
                    oh_w = (
                        vc[:, :, None]
                        == (start + jnp.arange(width, dtype=jnp.int32))[None, None, :]
                    ).astype(dtype)  # [L, K, width]
                    w_parts.append(
                        jnp.einsum(
                            "pdlk,lkv->dlvp", wc, oh_w, precision="highest"
                        )
                    )  # [dl, L, width, dr_s]
                w_blocks = jnp.concatenate(w_parts, axis=2)
                w_add = jnp.zeros((dl, L, dr + pad), dtype=dtype)
                flat_rows = row_idx.reshape(-1)  # unique per (v, p)
                w_add = w_add.at[:, :, flat_rows].add(
                    w_blocks.reshape(dl, L, fast.n_r * dr_s)
                )
                w = w.at[:, :L].add(w_add)
            continue

        # Generic fallback: block scatter-adds need batch-major operands.
        a_rr = a_rr.at[rows_r[:, :, None], rows_r[:, None, :]].add(
            jnp.moveaxis(h_rr_cm, -1, 0)
        )
        b_r = b_r.at[rows_r].add(g_r_cm.T)
        h_ll = h_ll.at[:, :, lid].add(h_le_cm)
        g_l = g_l.at[:, lid].add(g_e_cm)
        if info.implicit:
            # Keep the coupling blocks per cost; masked costs are neutralized
            # by zeroing (their lid points at the dustbin anyway).
            wparts.append(
                _make_wpart(
                    jnp.transpose(w_blk_cm, (2, 0, 1)),  # [B, Sr, dl]
                    rows_r, lid,
                    rvid=_generic_rvid(batch, layout, info),
                )
            )
        else:
            # [Sr, dl, B] → [dl, B, Sr] scatter into the components-major W.
            w = w.at[:, lid[:, None], rows_r].add(
                jnp.transpose(w_blk_cm, (1, 2, 0))
            )

    if info.implicit:
        w_out = tuple(wparts)
    else:
        w_out = w[:, :L, :dr].astype(_w_dtype(dtype) if w_dtype is None else w_dtype)
    return total, (
        a_rr[:dr, :dr],
        b_r[:dr],
        h_ll[:, :, :L],
        g_l[:, :L],
        w_out,
    )
