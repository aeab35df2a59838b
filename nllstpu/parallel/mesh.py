"""Multi-device execution: residual batches sharded over a device mesh.

The reference is single-threaded/single-process (SURVEY.md §5: no MPI/NCCL).
The scaling strategy (SURVEY.md §2 parallelism table, §7 step 8) is **data
parallelism over residual blocks**: each cost-type batch is sharded on its
batch dimension across the mesh's ``data`` axis, every device computes the
cost/gradient/Hessian contributions of its shard, and the (small) normal
equations are ``psum``-reduced over the interconnect so the reduced solve
runs replicated.  Works for both the dense and the Schur-reduced backends
because the system pytree is just summed blockwise.

The mesh is 1-D: the cards of one host are joined all to all, so the mesh
follows the algorithm alone.  Tests use
``--xla_force_host_platform_device_count=N`` CPU meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import jax
import jax.tree_util as jtu
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import engine, iterators
from ..core.optimize import CompiledProblem
from ..core.problem import CostBatch

DATA_AXIS = "data"


def make_mesh(n_devices: int = None, devices=None) -> Mesh:
    """1-D ``data`` mesh over the first ``n_devices`` available devices."""
    devs = list(devices) if devices is not None else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (DATA_AXIS,))


def _repad_batch(batch: CostBatch, multiple: int) -> CostBatch:
    """Re-pad a batch so its padded length divides the device count."""
    b = batch.n_padded
    target = -(-b // multiple) * multiple
    if target == b:
        return batch
    extra = target - b

    def pad_leaf(l):
        pad_width = [(0, extra)] + [(0, 0)] * (np.asarray(l).ndim - 1)
        return np.pad(np.asarray(l), pad_width)

    return dataclasses.replace(
        batch,
        idx=tuple(pad_leaf(i) for i in batch.idx),
        params=None if batch.params is None else jtu.tree_map(pad_leaf, batch.params),
        mask=pad_leaf(batch.mask),
    )


@dataclasses.dataclass
class ParallelCompiled:
    """Drop-in replacement for :class:`CompiledProblem` whose ``cost`` and
    ``assemble`` run under ``shard_map`` with batch data sharded on the mesh
    and psum-reduced outputs."""

    base: CompiledProblem
    mesh: Mesh
    batches: list  # re-padded batches (arrays live host-side until sharded)
    batch_args: Any  # pytree of sharded device arrays
    fast_args: Any = None  # per-shard Schur fast tables: list of
    # (obs_table [ndev, L, K], rvid [ndev, B_local]) or None per batch
    fast_meta: Any = None  # list of per-batch _FastBatch templates or None

    @property
    def layout(self):
        return self.base.layout

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def manifolds(self):
        return self.base.manifolds

    @property
    def schur_info(self):
        return self.base.schur_info

    def _rebuild(self, batch_args):
        return [
            dataclasses.replace(b, idx=tuple(i), params=p, mask=m)
            for b, (i, p, m) in zip(self.batches, batch_args)
        ]

    def _local_cost(self, variables, batch_args):
        c = engine.total_cost(self._rebuild(batch_args), variables, self.dtype)
        return jax.lax.psum(c, DATA_AXIS)

    def _local_assemble(self, variables, batch_args, fast_args):
        bs = self._rebuild(batch_args)
        if self.schur_info is not None:
            from ..ops import schur

            # Per-shard fast tables (row indices local to the shard) arrive
            # as sharded arguments with a leading device axis of size 1.
            fast = []
            for meta, fa in zip(self.fast_meta or [None] * len(bs), fast_args):
                if meta is None or fa is None:
                    fast.append(None)
                else:
                    obs_table, rvid = fa
                    fast.append(
                        dataclasses.replace(
                            meta,
                            obs_table=obs_table[0],
                            rvid=rvid[0],
                            # Shard-0's camera table rows are invalid for the
                            # other shards; the sharded path never runs the
                            # implicit solve, so drop it rather than ship it.
                            cam_table=None,
                            # Dual/obs-major fields are shard-0 host data.
                            obs_k=None,
                            cam_batch=None,
                            cam_k=None,
                        )
                    )
            local_info = dataclasses.replace(
                self.schur_info, fast=tuple(fast)
            )
            # Pin w_dtype: the per-device W contributions are psum-summed
            # below and a pre-reduction bf16 downcast would stack error.
            c, sys = schur.assemble_schur(
                bs, variables, self.layout, local_info, self.dtype,
                w_dtype=self.dtype,
            )
        else:
            c, a, g = engine.assemble_dense(bs, variables, self.layout, self.dtype)
            sys = (a, g)
        return jax.lax.psum((c, sys), DATA_AXIS)

    def cost(self, variables):
        f = jax.shard_map(
            self._local_cost,
            mesh=self.mesh,
            in_specs=(P(), P(DATA_AXIS)),
            out_specs=P(),
        )
        return f(variables, self.batch_args)

    def assemble(self, variables):
        f = jax.shard_map(
            self._local_assemble,
            mesh=self.mesh,
            in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
            out_specs=P(),
        )
        return f(variables, self.batch_args, self.fast_args)

    def apply(self, variables, x):
        return self.base.apply(variables, x)

    def ctx(self, options=None) -> iterators.IterCtx:
        return dataclasses.replace(self.base.ctx(options), cost=self.cost)

    def run_loop_jit(self, opts, vars0):
        """Fully-jitted sharded optimization, safe under MULTI-PROCESS
        meshes: the globally-sharded batch data enter the program as jit
        ARGUMENTS.  (``jax.jit(lambda v: run_loop(self.assemble, ...))``
        closes over ``batch_args``, and a closed-over array becomes a
        compile-time constant — unmaterializable when its shards span
        processes.)  Returns the ``run_loop`` final-state dict; replicated
        leaves are addressable on every process."""
        from ..core.optimize import run_loop

        def fn(v, batch_args, fast_args):
            def cost(vv):
                return jax.shard_map(
                    self._local_cost,
                    mesh=self.mesh,
                    in_specs=(P(), P(DATA_AXIS)),
                    out_specs=P(),
                )(vv, batch_args)

            def assemble(vv):
                return jax.shard_map(
                    self._local_assemble,
                    mesh=self.mesh,
                    in_specs=(P(), P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=P(),
                )(vv, batch_args, fast_args)

            ctx = dataclasses.replace(self.base.ctx(opts), cost=cost)
            return run_loop(assemble, cost, ctx, opts, v)

        return jax.jit(fn)(vars0, self.batch_args, self.fast_args)


def _per_shard_fast(compiled, batches, n):
    """Build per-shard Schur fast tables: slice each batch into its n
    device shards, run the host-side table builder per shard, and stack —
    a batch qualifies only if every shard qualifies (one program for all
    devices).  Returns (fast_meta, fast_args_host)."""
    from ..ops import schur

    info = compiled.schur_info
    metas, args = [], []
    for b in batches:
        b_pad = b.n_padded
        per = b_pad // n
        shard_fast = []
        for s in range(n):
            sl = slice(s * per, (s + 1) * per)
            shard_batch = dataclasses.replace(
                b,
                idx=tuple(np.asarray(i)[sl] for i in b.idx),
                params=None
                if b.params is None
                else jtu.tree_map(lambda l: np.asarray(l)[sl], b.params),
                mask=np.asarray(b.mask)[sl],
            )
            shard_fast.append(
                schur._fast_batch_data(shard_batch, compiled.layout, info)
            )
        if any(f is None for f in shard_fast):
            metas.append(None)
            args.append(None)
            continue
        k_max = max(f.obs_table.shape[1] for f in shard_fast)
        tables = np.stack(
            [
                np.pad(
                    f.obs_table,
                    ((0, 0), (0, k_max - f.obs_table.shape[1])),
                    constant_values=per,
                )
                for f in shard_fast
            ]
        )  # [n, L, k_max]
        rvids = np.stack([f.rvid for f in shard_fast])  # [n, per]
        metas.append(shard_fast[0])
        args.append((tables, rvids))
    return metas, args


def parallelize(compiled: CompiledProblem, mesh: Mesh) -> ParallelCompiled:
    """Shard a compiled problem's cost batches across ``mesh``."""
    if compiled.schur_info is not None and compiled.schur_info.implicit:
        # The psum-everything strategy would sum the implicit system's
        # per-cost coupling pytree (w_blk / index arrays) across shards —
        # silently wrong.  The landmark-sharded path handles implicit.
        raise ValueError(
            "parallelize() does not support the implicit (schur_cg) "
            "backend; use parallel.schur_shard.parallelize_schur / "
            "optimize_sharded"
        )
    n = int(np.prod(mesh.devices.shape))
    batches = [_repad_batch(b, n) for b in compiled.batches]
    sharding = NamedSharding(mesh, P(DATA_AXIS))

    def shard_leaf(l):
        return jax.device_put(np.asarray(l), sharding)

    batch_args = [
        (
            tuple(shard_leaf(i) for i in b.idx),
            None if b.params is None else jtu.tree_map(shard_leaf, b.params),
            shard_leaf(b.mask),
        )
        for b in batches
    ]
    fast_meta = None
    fast_args = [None] * len(batches)
    if compiled.schur_info is not None:
        fast_meta, fast_host = _per_shard_fast(compiled, batches, n)
        fast_args = [
            None if fh is None else tuple(shard_leaf(x) for x in fh)
            for fh in fast_host
        ]
    return ParallelCompiled(
        base=compiled,
        mesh=mesh,
        batches=batches,
        batch_args=batch_args,
        fast_args=fast_args,
        fast_meta=fast_meta,
    )
