"""Worker for tests/test_distributed.py: one process of a 2-process
``jax.distributed`` CPU job (gloo TCP collectives).  Run as

    python tests/_distributed_worker.py <coordinator> <nproc> <pid>

Prints one JSON line with the values the test asserts on.  Exercises the
real multi-process initialization path (nllstpu.parallel.distributed) that
multi-host jobs use — SURVEY.md §5 distributed-comm equivalent — on a
4-device global mesh (2 processes x 2 local CPU devices).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Two local CPU devices per process; MUST be set before jax import.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np


def main():
    coordinator, nproc, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import nllstpu as nt
    from nllstpu.parallel import distributed
    from nllstpu.models.ba import make_pinhole_ba, perturb_ba

    distributed.initialize(
        coordinator_address=coordinator, num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc
    assert jax.device_count() == 2 * nproc
    assert jax.local_device_count() == 2

    # 1. Cross-process collective smoke test: psum of per-device ranks.
    mesh = distributed.global_mesh()
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard_map = jax.shard_map

    n_dev = jax.device_count()
    ranks = jax.device_put(
        np.arange(n_dev, dtype=np.float64),
        NamedSharding(mesh, P(distributed.DATA_AXIS)),
    )
    total = jax.jit(
        shard_map(
            lambda x: jax.lax.psum(jnp.sum(x), distributed.DATA_AXIS),
            mesh=mesh,
            in_specs=P(distributed.DATA_AXIS),
            out_specs=P(),
        )
    )(ranks)
    psum_val = float(total.addressable_data(0))

    # 2. Deterministic BA problem, identical on every process.
    problem, cams, lmks = make_pinhole_ba(
        ncameras=4, nlandmarks=24, prop_visible=0.7, noise=1e-3,
        dtype=jnp.float64,
    )
    perturb_ba(problem, lmks, 0.03, seed=5)

    # Local single-device reference (plain jit on this process's device 0).
    ref = nt.cost(problem)

    # 3+4. Sharded assembly + a fully-jitted LM optimization across the
    # 2-process mesh (batch data as jit arguments — multi-process safe).
    from nllstpu.core.optimize import compile_problem
    from nllstpu.parallel import parallelize

    compiled = parallelize(
        compile_problem(problem, solver="schur", schur_family=nt.Euclidean(3)),
        mesh,
    )
    opts = nt.Options(iterator=nt.LEVENBERG_MARQUARDT, max_iters=8)
    final = compiled.run_loop_jit(opts, problem.stacked_variables())
    best = float(np.asarray(final["bestcost"].addressable_data(0)))
    start = float(np.asarray(final["startcost"].addressable_data(0)))
    sharded_cost = start  # cost of the initial variables over the mesh

    # 5. LANDMARK-SHARDED optimization (optimize_sharded — the actual
    # scaling design: per-device landmark ownership, psum-reduced camera
    # system) across the 2-process mesh, direct AND implicit backends.
    # The single-process 8-device tests can't catch cross-process issues
    # in its axis_index slicing / global device_put logic.
    from nllstpu.parallel import optimize_sharded

    def fresh():
        p, _, lm = make_pinhole_ba(
            ncameras=4, nlandmarks=24, prop_visible=0.7, noise=1e-3,
            dtype=jnp.float64,
        )
        perturb_ba(p, lm, 0.03, seed=5)
        return p

    # Local single-device reference optimum for both backends.
    p_ref = fresh()
    r_ref = nt.optimize(
        p_ref,
        nt.Options(
            iterator=nt.LEVENBERG_MARQUARDT, max_iters=8,
            solver="schur", schur_family=nt.Euclidean(3),
        ),
    )
    p_dir = fresh()
    r_dir = optimize_sharded(
        p_dir, mesh,
        nt.Options(
            iterator=nt.LEVENBERG_MARQUARDT, max_iters=8,
            solver="schur", schur_family=nt.Euclidean(3),
        ),
    )
    p_imp = fresh()
    r_imp = optimize_sharded(
        p_imp, mesh,
        nt.Options(
            iterator=nt.LEVENBERG_MARQUARDT, max_iters=8,
            solver="schur_cg", schur_family=nt.Euclidean(3),
        ),
    )

    print(
        json.dumps(
            {
                "pid": pid,
                "process_count": jax.process_count(),
                "device_count": jax.device_count(),
                "psum": psum_val,
                "ref_cost": ref,
                "sharded_cost": sharded_cost,
                "start": start,
                "best": best,
                "ref_best": r_ref.best_cost,
                "lmshard_direct_best": r_dir.best_cost,
                "lmshard_direct_start": r_dir.start_cost,
                "lmshard_implicit_best": r_imp.best_cost,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
