"""Multi-host execution helpers.

The reference is single-process (SURVEY.md §5: no MPI/NCCL/Gloo).  Here
``jax.distributed.initialize`` joins the hosts, the data mesh spans every
device of every host, cost batches shard over it, and the ``psum``
reductions in :mod:`nllstpu.parallel.mesh` become collectives (NCCL on
GPUs) — no explicit communication code.

On a single host (or in tests with ``--xla_force_host_platform_device_count``)
everything works unchanged; ``initialize`` is only needed when several
processes share one mesh, where each process calls it with the
coordinator's address, the process count and its own id before any jax
computation.

Tested by a REAL 2-process job (tests/test_distributed.py): two CPU
processes with gloo TCP collectives
(``jax.config.update("jax_cpu_collectives_implementation", "gloo")``) join
through this module, shard a BA problem over the 4-device global mesh, and
run a fully-jitted LM optimization whose psums cross the process boundary.
Multi-process caveat baked into the sharded runners: globally-sharded batch
data must enter jitted programs as ARGUMENTS (see
``ParallelCompiled.run_loop_jit``) — a closed-over global array becomes a
jit constant, which cannot be materialized when its shards span processes.
"""

from __future__ import annotations

import jax

from .mesh import DATA_AXIS, make_mesh, parallelize  # noqa: F401


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Join a multi-process job (thin wrapper over
    ``jax.distributed.initialize``).  Pass ``coordinator_address``
    (``host:port``), ``num_processes`` and ``process_id`` unless the
    launcher's environment provides them.  Call once per process before
    building meshes."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def global_mesh():
    """1-D data mesh over every device of every participating host."""
    return make_mesh()


def local_batch_slice(n_total: int):
    """The [start, stop) slice of a globally-sharded batch that this host's
    process owns (for host-local data loading before ``jax.device_put`` with
    a global sharding)."""
    nproc = jax.process_count()
    pid = jax.process_index()
    per = -(-n_total // nproc)
    return slice(pid * per, min((pid + 1) * per, n_total))
