#!/usr/bin/env python
"""Headline benchmark: Levenberg-Marquardt iterations/sec on synthetic
SE(3)+pinhole bundle adjustment with the Schur-complement backend, on one
GPU.

Usage:  python bench.py                       # the GPU measurement
        python bench.py --cpu-baseline ITERS  # the plain-CPU reference run

The reference publishes no numbers (BASELINE.md), so the recorded baseline
is a CPU running the identical workload (``scripts/cpu_ref.json``, written by
``scripts/measure_cpu_ref.py``); ``vs_baseline`` is the GPU/CPU rate ratio.
Prints ONE JSON line whose metric name carries the platform and the device
kind that produced the number.  Without a GPU the measurement fails with a
non-zero exit; it never falls back to the CPU.

Workload: 128 SE(3) cameras (768 reduced dims), 8192 landmarks, ~105k
observations (10% banded visibility), float32, measurement noise 1e-3,
landmarks perturbed 0.05.

Timing: one compile-and-run call, then ``BENCH_RUNS`` timed calls on the same
inputs, each waited for with ``jax.block_until_ready``; the fastest counts.
"""

import json
import os
import sys
import time

import numpy as np

NCAM = int(os.environ.get("BENCH_NCAM", 128))
NLMK = int(os.environ.get("BENCH_NLMK", 8192))
VIS = float(os.environ.get("BENCH_VIS", 0.1))
ITERS = int(os.environ.get("BENCH_ITERS", 30))
RUNS = int(os.environ.get("BENCH_RUNS", 3))
_REPO = os.path.dirname(os.path.abspath(__file__))
_CPU_REF_PATH = os.path.join(_REPO, "scripts", "cpu_ref.json")


def metric_name(platform, device_kind, w_dtype="f32"):
    """The metric name: workload, W storage dtype, and the device that
    produced the number (``device_kind`` with spaces folded)."""
    kind = device_kind.strip().replace(" ", "_")
    return (
        f"lm_iters_per_sec_pinhole_ba_{NCAM}cam_{NLMK}lmk_f32_schur"
        f"_w{w_dtype}_{platform}_{kind}"
    )


#: bf16-W acceptance gate: the bf16 run's best cost must stay within this
#: factor of the committed f32 cost at the same iteration budget, else the
#: bench reports the gate as failed — a storage-precision "win" that breaks
#: LM convergence must never become the headline number.
BF16_COST_GATE = 2.0


def bf16_cost_ok(best_cost, ref_best_cost, gate=BF16_COST_GATE):
    """True when a bf16-W run's converged cost is acceptable vs the f32
    reference at the same iteration budget (unit-tested in
    tests/test_bench.py)."""
    if ref_best_cost is None or not np.isfinite(best_cost):
        return np.isfinite(best_cost)
    return best_cost <= gate * max(ref_best_cost, 1e-12)


def measure(iters: int, w_dtype: str = "f32", runs: int = RUNS):
    """LM iterations/sec on the default JAX backend; returns a stats dict."""
    import jax
    import jax.numpy as jnp

    import nllstpu as nt
    from nllstpu.core.optimize import compile_problem, run_loop
    from nllstpu.models.ba import make_pinhole_ba, perturb_ba

    # Read when the assembly is traced (nllstpu.ops.schur._w_dtype).
    os.environ["NLLSTPU_W_DTYPE"] = w_dtype
    problem, cams, lmks = make_pinhole_ba(
        ncameras=NCAM, nlandmarks=NLMK, prop_visible=VIS,
        noise=1e-3, dtype=jnp.float32, batched="cm",
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    compiled = compile_problem(problem, solver="schur", schur_family=nt.Euclidean(3))
    opts = nt.Options(
        iterator=nt.LEVENBERG_MARQUARDT,
        max_iters=iters,
        rel_dcost=0.0,
        abs_dcost=0.0,
        dstep=1e-12,
        max_fails=1 << 30,
        # In-loop per-iteration cost trace: time-to-target comes from it.
        store_trajectory=True,
    )

    def run(v):
        final = run_loop(compiled.assemble, compiled.cost, compiled.ctx(), opts, v)
        head = jnp.stack(
            [
                final["iternum"].astype(jnp.float32),
                final["startcost"].astype(jnp.float32),
                final["bestcost"].astype(jnp.float32),
                final["nsolve"].astype(jnp.float32),
            ]
        )
        return jnp.concatenate([head, final["trace"].astype(jnp.float32)])

    runner = jax.jit(run)
    vars0 = problem.stacked_variables()
    t0 = time.perf_counter()
    jax.block_until_ready(runner(vars0))
    compile_s = time.perf_counter() - t0
    wall = float("inf")
    for _ in range(runs):
        t0 = time.perf_counter()
        out = jax.block_until_ready(runner(vars0))
        wall = min(wall, time.perf_counter() - t0)
    stats = np.asarray(out, dtype=np.float64)
    n_iter, start, best, solves = (
        int(stats[0]), float(stats[1]), float(stats[2]), int(stats[3]),
    )
    assert best < start, (start, best)  # sanity: LM actually descends
    return {
        "w_dtype": w_dtype,
        "iters_per_sec": n_iter / wall,
        "iters": n_iter,
        "wall_s": wall,
        "compile_s": compile_s,
        "start_cost": start,
        "best_cost": best,
        "solves": solves,
        "cost_trace": stats[4 : 4 + n_iter].tolist(),
    }


def load_cpu_ref():
    """Committed CPU reference (scripts/cpu_ref.json) — iters/s for
    vs_baseline plus the f32 cost targets for the bf16 gate and
    time-to-target — valid only when it was measured at the current
    workload shape AND iteration budget (a 30-iteration rate divided by a
    5-iteration rate mixes fixed-cost amortization)."""
    try:
        with open(_CPU_REF_PATH) as f:
            ref = json.load(f)
        if (
            ref.get("ncam") == NCAM
            and ref.get("nlmk") == NLMK
            and ref.get("vis") == VIS
            and ref.get("iters") == ITERS
            and ref.get("iters_per_sec", 0) > 0
        ):
            return ref
    except (OSError, ValueError):
        pass
    return None


def time_to_target(stats, target_cost):
    """Approximate wall seconds for the measured run to reach
    ``1.1 x target_cost``: per-iteration costs come from the jitted loop's
    trace; wall per iteration is uniform (the loop body is one fused
    program — finer attribution isn't observable from outside it).  None
    when the run never reaches the target."""
    if not stats or target_cost is None:
        return None
    trace = stats.get("cost_trace") or []
    n = stats.get("iters", len(trace))
    wall = stats.get("wall_s")
    if not trace or not n or wall is None:
        return None
    for i, c in enumerate(trace):
        if c <= 1.1 * target_cost:
            return wall * (i + 1) / n
    return None


def main():
    import jax

    from nllstpu.utils.compile_cache import configure_compile_cache

    if len(sys.argv) > 2 and sys.argv[1] == "--cpu-baseline":
        jax.config.update("jax_platforms", "cpu")
        configure_compile_cache()
        stats = measure(int(sys.argv[2]), runs=1)
        print(json.dumps(dict(stats, platform="cpu")), flush=True)
        return
    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX backend {dev.platform!r})")

    stats = measure(ITERS)
    cpu_ref = load_cpu_ref()
    ref_best = cpu_ref.get("best_cost") if cpu_ref else None
    target_cost = cpu_ref.get("target_cost") if cpu_ref else None
    bf16 = measure(ITERS, w_dtype="bf16")
    value = stats["iters_per_sec"]
    line = {
        "metric": metric_name(dev.platform, dev.device_kind),
        "value": value,
        "unit": "iter/s",
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        # Ratio to the committed plain-CPU run of the same workload.
        "vs_baseline": value / cpu_ref["iters_per_sec"] if cpu_ref else None,
        "start_cost": stats["start_cost"],
        "best_cost": stats["best_cost"],
        "iters": stats["iters"],
        "wall_s": stats["wall_s"],
        "compile_s": stats["compile_s"],
        "target_cost": target_cost,
        "time_to_target_s": time_to_target(stats, target_cost),
        # Secondary gated bf16-W measurement (opt-in config; the headline
        # above is the library default).
        "bf16_iters_per_sec": bf16["iters_per_sec"],
        "bf16_best_cost": bf16["best_cost"],
        "bf16_gate_ok": bool(
            bf16_cost_ok(
                bf16["best_cost"],
                ref_best if ref_best is not None else stats["best_cost"],
            )
        ),
    }
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
