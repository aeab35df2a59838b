"""Matrix-free preconditioned conjugate-gradient linear system.

Third linear-system backend (after dense and Schur): for problems whose
variable-cost graph is sparse but not bipartite — pose graphs, deformable
meshes — a materialized Hessian wastes memory and a landmark elimination does
not apply.  Here H is never formed: ``H @ x`` is computed batch-wise
(gather rows of x per cost → per-cost block multiply → per-variable
reduction), a stream of small batched matmuls.  The
per-variable reduction inside the CG loop uses host-precomputed key tables
(gather + dense sum + unique-row scatter) because XLA scatter-adds with
duplicate indices serialize on some backends — the same concern that shaped
the Schur assembly.  The preconditioner is block-Jacobi over variable blocks (batched
small-block inverses) with a contiguous fast path when a family's tangent
rows are a dense range, and the CG iteration is a ``lax.while_loop`` so the
whole damped solve stays inside jit.

Replaces the reference's sparse LDLᵀ for general sparsity
(src/linearsolver.jl:29; SURVEY.md §2 native table recommends
"Schur-complement elimination + batched dense Cholesky / PCG").
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from ..core import engine
from ..core.linearsolver import batched_inv_spd
from ..core.problem import family_name

#: Per-variable key-table skew cap (max costs per variable for the dense
#: table); beyond it the slot falls back to the scatter-add path.
_CG_MAX_K = 4096


@dataclasses.dataclass(frozen=True)
class CGOps:
    """Linear-system ops over
    ``sys = (b, hs, rows, pre_blocks, diag)`` where ``hs``/``rows`` are
    per-batch block Hessians [B,S,S] and global row indices [B,S],
    ``pre_blocks`` a dict family → [n, dof, dof] diagonal blocks, and
    ``diag`` the assembled H diagonal.  Implements the same protocol as
    DenseOps/SchurOps."""

    dim: int
    pad: int
    # Static per-family layout for the block-Jacobi preconditioner:
    # tuples of (family name, offsets [n] (dustbin=dim), dof, contig_base)
    # where contig_base is the start of a dense offset range (or None).
    fam_offsets: tuple
    # Per-batch tuple of per-slot (table [n,K], row_base [n], dof, sel)
    # key tables turning the matvec's per-variable reduction into
    # gather + sum + unique-row scatter; None entries fall back to a
    # duplicate-index scatter-add.
    slot_tables: tuple = ()
    # None = dtype default: 1e-14 for f64, 1e-5 for f32 (an f64 tolerance is
    # unreachable in f32 and forces every solve to burn max_iters).
    tol: object = None
    max_iters: int = 2000

    def _tol(self, dtype):
        if self.tol is not None:
            return self.tol
        return 1e-5 if jnp.dtype(dtype).itemsize <= 4 else 1e-14

    def grad(self, sys):
        return sys[0]

    def diag_max(self, sys):
        return jnp.max(jnp.abs(sys[4]))

    def _matvec(self, sys, x, lam):
        _, hs, rows, _, _ = sys
        xp = jnp.concatenate([x, jnp.zeros(self.pad, dtype=x.dtype)])
        y = jnp.zeros(self.dim + self.pad, dtype=x.dtype)
        for bi, (h, r) in enumerate(zip(hs, rows)):
            xg = xp[r]  # [B, S]
            # full f32/f64 precision: a reduced-precision matmul (bf16,
            # TF32) makes the matvec effectively nonsymmetric and CG diverges to NaN.
            t = jnp.einsum("bst,bt->bs", h, xg, precision="highest")
            st = (
                self.slot_tables[bi]
                if bi < len(self.slot_tables)
                else None
            )
            if st is None:
                y = y.at[r].add(t)
                continue
            for table, row_base, dof, sel in st:
                ts = t[:, sel]  # [B, dof]
                n, k = table.shape
                g = jnp.take(
                    ts, jnp.asarray(table).reshape(-1), axis=0,
                    mode="fill", fill_value=0,
                ).reshape(n, k, dof).sum(axis=1)
                idx = (
                    jnp.asarray(row_base)[:, None]
                    + jnp.arange(dof, dtype=jnp.int32)[None, :]
                )
                y = y.at[idx].add(g)  # unique rows per variable
        return y[: self.dim] + lam * x

    def quad(self, sys, x):
        zero = jnp.zeros((), dtype=x.dtype)
        return x @ self._matvec(sys, x, zero)

    def _precond_apply(self, inv_blocks, r):
        rp = jnp.concatenate([r, jnp.zeros(self.pad, dtype=r.dtype)])
        z = jnp.zeros(self.dim + self.pad, dtype=r.dtype)
        for (name, offs, dof, contig), inv in zip(self.fam_offsets, inv_blocks):
            n = inv.shape[0]
            if contig is not None and n:
                # Dense offset range (no fixed variables in the family):
                # the gather/scatter degenerates to contiguous reshapes.
                rg = jax.lax.dynamic_slice_in_dim(
                    rp, contig, n * dof
                ).reshape(n, dof)
                out = jnp.einsum(
                    "nst,nt->ns", inv, rg, precision="highest"
                ).reshape(-1)
                z = jax.lax.dynamic_update_slice_in_dim(
                    z,
                    jax.lax.dynamic_slice_in_dim(z, contig, n * dof) + out,
                    contig,
                    0,
                )
                continue
            idx = offs[:, None] + jnp.arange(dof, dtype=jnp.int32)[None, :]
            rg = rp[idx]  # [n, dof]
            z = z.at[idx].add(
                jnp.einsum("nst,nt->ns", inv, rg, precision="highest")
            )
        return z[: self.dim]

    def solve(self, sys, lam):
        b, hs, rows, pre_blocks, diag = sys
        dtype = b.dtype
        inv_blocks = []
        for name, offs, dof, contig in self.fam_offsets:
            blocks = pre_blocks[name]
            damped = blocks + lam * jnp.eye(dof, dtype=dtype)
            inv_blocks.append(batched_inv_spd(damped))

        def matvec(x):
            return self._matvec(sys, x, lam)

        x0 = jnp.zeros(self.dim, dtype=dtype)
        r0 = b  # r = b - A·0
        z0 = self._precond_apply(inv_blocks, r0)
        p0 = z0
        rz0 = r0 @ z0
        bnorm2 = b @ b
        tol2 = jnp.asarray(self._tol(dtype), dtype) ** 2 * bnorm2

        def cond(st):
            x, r, z, p, rz, k = st
            return (r @ r > tol2) & (k < self.max_iters)

        def body(st):
            x, r, z, p, rz, k = st
            ap = matvec(p)
            denom = p @ ap
            alpha = rz / jnp.where(denom == 0, jnp.ones_like(denom), denom)
            x2 = x + alpha * p
            r2 = r - alpha * ap
            z2 = self._precond_apply(inv_blocks, r2)
            rz2 = r2 @ z2
            beta = rz2 / jnp.where(rz == 0, jnp.ones_like(rz), rz)
            p2 = z2 + beta * p
            return (x2, r2, z2, p2, rz2, k + 1)

        x, *_ = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, jnp.int32(0)))
        return x


def _slot_key_table(batch, layout, slot, start):
    """Per-variable key table for one dependency slot: batch rows grouped
    by (unfixed) variable id, plus the variable's global row base (fixed
    variables map to the dustbin row ``dof_total``).  None on excessive
    skew."""
    from .schur import _key_table

    man = batch.manifolds[slot]
    name = family_name(man)
    offs = np.asarray(layout.offsets[name])
    n = offs.shape[0]
    idx = np.asarray(batch.idx[slot])
    mask = np.asarray(batch.mask)
    unfixed = offs[idx] < layout.dof_total
    keys = np.where(mask & unfixed, idx, n)
    table = _key_table(keys, n, batch.n_padded, _CG_MAX_K)
    if table is None:
        return None
    row_base = np.minimum(offs, layout.dof_total).astype(np.int32)
    sel = np.arange(start, start + man.dof)
    return table, row_base, man.dof, sel


def build_cg_ops(
    problem, layout: engine.Layout, tol=None, max_iters=2000, batches=None
) -> CGOps:
    fam_offsets = []
    for name in problem.family_names():
        man = problem.manifold_of(name)
        offs = np.asarray(layout.offsets[name])
        contig = None
        if offs.size and np.array_equal(
            offs, offs[0] + np.arange(offs.size) * man.dof
        ) and offs[-1] + man.dof <= layout.dof_total:
            contig = int(offs[0])
        fam_offsets.append((name, layout.offsets[name], man.dof, contig))
    slot_tables = []
    for b in batches or ():
        start = 0
        tables = []
        for slot, man in enumerate(b.manifolds):
            tables.append(_slot_key_table(b, layout, slot, start))
            start += man.dof
        slot_tables.append(
            tuple(tables) if all(t is not None for t in tables) else None
        )
    return CGOps(
        dim=layout.dof_total,
        pad=layout.pad,
        fam_offsets=tuple(fam_offsets),
        slot_tables=tuple(slot_tables),
        tol=tol,
        max_iters=max_iters,
    )


def assemble_cg(batches, variables, layout: engine.Layout, problem_manifolds, dtype):
    """Assemble ``(cost, (b, hs, rows, pre_blocks, diag))`` — the gradient,
    the per-batch Hessian blocks kept unscattered (the matrix-free
    representation), the block-Jacobi diagonal blocks per family, and the
    assembled diagonal."""
    size = layout.padded_size
    b = jnp.zeros(size, dtype=dtype)
    diag = jnp.zeros(size, dtype=dtype)
    total = jnp.zeros((), dtype=dtype)
    hs, rows_list = [], []
    pre = {
        name: jnp.zeros(
            (int(layout.unfixed[name].shape[0]) + 1, man.dof, man.dof),
            dtype=dtype,
        )
        for name, man in problem_manifolds.items()
    }
    for batch in batches:
        c, g, h, rows = engine.batch_grad_hess(batch, variables, layout, dtype)
        total = total + c
        b = b.at[rows].add(g)
        diag = diag.at[rows].add(
            jnp.diagonal(h, axis1=-2, axis2=-1)
        )
        hs.append(h)
        rows_list.append(rows)
        # Per-slot diagonal blocks into the block-Jacobi preconditioner,
        # keyed by variable index within the family (dustbin = n).
        start = 0
        for slot, man in enumerate(batch.manifolds):
            dof = man.dof
            name = family_name(man)
            n = int(layout.unfixed[name].shape[0])
            sel = np.arange(start, start + dof)
            h_ss = h[:, sel[:, None], sel[None, :]]
            vid = jnp.asarray(batch.idx[slot])
            # Fixed variables and padding costs go to the dustbin block n.
            off = jnp.asarray(layout.offsets[name])[vid]
            vid = jnp.where(
                batch.mask & (off < layout.dof_total), vid, jnp.int32(n)
            )
            pre[name] = pre[name].at[vid].add(h_ss)
            start += dof
    pre_blocks = {name: blocks[:-1] for name, blocks in pre.items()}
    return total, (b[: layout.dof_total], tuple(hs), tuple(rows_list), pre_blocks, diag[: layout.dof_total])
