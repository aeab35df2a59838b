#!/usr/bin/env python
"""REALISTIC (skewed-degree) BAL end-to-end on the default JAX backend.

Usage:  python scripts/bal_realistic.py [ladybug|bench] [direct|implicit] [iters]

Shapes:
  ladybug  49 cams / 7776 pts,  power-law tracks → ~32k obs (BAL Ladybug-49)
  bench    128 cams / 8192 pts, power-law tracks → ~100k obs (headline-scale)

Prints ONE JSON line with iters/sec, converged costs, the device, the bucket
plan and its padding ratio.  Each timed call is waited for with
``jax.block_until_ready``.
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import nllstpu as nt
from nllstpu.core.optimize import compile_problem, run_loop
from nllstpu.models import bal
from nllstpu.models.ba import perturb_ba
from nllstpu.utils.compile_cache import configure_compile_cache

SHAPE = sys.argv[1] if len(sys.argv) > 1 else "ladybug"
BACKEND = sys.argv[2] if len(sys.argv) > 2 else "direct"
ITERS = int(sys.argv[3]) if len(sys.argv) > 3 else 30


def main():
    configure_compile_cache()
    if SHAPE == "ladybug":
        data = bal.make_realistic_bal(
            ncameras=49, npoints=7776, seed=1, noise=1e-3, track_alpha=2.3
        )
    else:  # bench-scale: mean track ~12 → ~100k obs at 8192 points
        data = bal.make_realistic_bal(
            ncameras=128, npoints=8192, seed=1, noise=1e-3,
            track_alpha=1.6, max_track=96,
        )
    nobs = len(data["pt_idx"])
    tracks = np.bincount(data["pt_idx"], minlength=data["points"].shape[0])
    cams = np.bincount(data["cam_idx"], minlength=data["cameras"].shape[0])

    problem, cam_h, pt_h = bal.make_bal_problem(data, dtype=jnp.float32)
    perturb_ba(problem, pt_h, 0.05, seed=5)
    solver = "schur" if BACKEND == "direct" else "schur_cg"
    compiled = compile_problem(
        problem, solver=solver, schur_family=bal.PT
    )
    info = compiled.schur_info
    fast = info.fast[0]
    buckets = fast.buckets or (
        ((0, info.num_elim, fast.obs_k, 0),) if fast.obs_k else None
    )
    padded_cols = (
        sum(lb * kb for (_, lb, kb, _) in buckets) if buckets else None
    )
    opts = nt.Options(
        iterator=nt.LEVENBERG_MARQUARDT,
        max_iters=ITERS,
        rel_dcost=0.0,
        abs_dcost=0.0,
        dstep=1e-12,
        max_fails=1 << 30,
        store_trajectory=True,
        linear_tol=1e-2 if BACKEND == "implicit" else None,
    )

    def run(v):
        final = run_loop(
            compiled.assemble, compiled.cost, compiled.ctx(opts), opts, v
        )
        head = jnp.stack(
            [
                final["iternum"].astype(jnp.float32),
                final["startcost"].astype(jnp.float32),
                final["bestcost"].astype(jnp.float32),
                final["nsolve"].astype(jnp.float32),
                final["converged"].astype(jnp.float32),
                final["lastcost"].astype(jnp.float32),
            ]
        )
        return jnp.concatenate([head, final["trace"].astype(jnp.float32)])

    runner = jax.jit(run)
    vars0 = problem.stacked_variables()
    t0 = time.perf_counter()
    jax.block_until_ready(runner(vars0))
    compile_s = time.perf_counter() - t0
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = jax.block_until_ready(runner(vars0))
        wall = min(wall, time.perf_counter() - t0)
    stats = np.asarray(out, dtype=np.float64)
    best_rate = stats[0] / wall
    n_iter, start, best = int(stats[0]), float(stats[1]), float(stats[2])
    term, lastc = int(stats[4]), float(stats[5])
    trace = stats[6 : 6 + n_iter]
    # Noise-floor target: E[cost] = nobs * noise^2 (2 residual dims, 1/2).
    target = nobs * 1e-6
    tt = None
    for i, c in enumerate(trace):
        if c <= 2.0 * target:
            tt = wall * (i + 1) / n_iter
            break
    print(
        json.dumps(
            {
                "shape": SHAPE,
                "backend": BACKEND,
                "platform": jax.devices()[0].platform,
                "device_kind": jax.devices()[0].device_kind,
                "w_dtype": os.environ.get("NLLSTPU_W_DTYPE", "auto"),
                "nobs": nobs,
                "track_mean": round(float(tracks.mean()), 2),
                "track_max": int(tracks.max()),
                "cam_deg_max_over_mean": round(
                    float(cams.max() / cams.mean()), 2
                ),
                "n_buckets": None if buckets is None else len(buckets),
                "bucket_plan": None
                if buckets is None
                else [[int(x) for x in b] for b in buckets],
                "pad_ratio": None
                if padded_cols is None
                else round(padded_cols / nobs, 3),
                "iters_per_sec": best_rate,
                "iters": n_iter,
                "wall_s": wall,
                "compile_s": compile_s,
                "start_cost": start,
                "best_cost": best,
                "termination_bits": bin(term),
                "last_cost": lastc,
                "trace_tail": [float(v) for v in trace[-4:]],
                "noise_floor_target": target,
                "time_to_2x_floor_s": tt,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
