#!/usr/bin/env python
"""Re-measure and WRITE the committed CPU baseline used by bench.py
(scripts/cpu_ref.json): the vs_baseline rate at the SAME iteration budget
as the GPU run (a mixed budget would mix fixed-cost amortization), the f32
best_cost at that budget (the bf16 accuracy gate reference), and the
converged target_cost driving time-to-target.  Runs on the CPU; run from
anywhere; respects BENCH_NCAM/BENCH_NLMK/BENCH_VIS/BENCH_ITERS."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")
OUT = os.path.join(REPO, "scripts", "cpu_ref.json")
ITERS = int(os.environ.get("BENCH_ITERS", 30))
#: Iteration budget for the "converged" target-cost leg: LM on the bench
#: workload plateaus well before this.
TARGET_ITERS = int(os.environ.get("BENCH_TARGET_ITERS", 150))


def leg(iters):
    proc = subprocess.run(
        [sys.executable, BENCH, "--cpu-baseline", str(iters)],
        capture_output=True, text=True, timeout=3600, cwd=REPO,
    )
    for line in proc.stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            stats = json.loads(line)
            stats.pop("cost_trace", None)
            return stats
    raise RuntimeError(
        f"cpu worker produced no stats (rc={proc.returncode}):\n"
        f"{proc.stderr[-2000:]}"
    )


def main():
    main_stats = leg(ITERS)
    target_stats = leg(TARGET_ITERS)
    ref = {
        "comment": (
            "CPU baseline for bench.py: vs_baseline rate at the GPU run's "
            f"iteration budget ({ITERS}), f32 best_cost at that budget "
            "(bf16 gate reference), and the converged target_cost "
            f"({TARGET_ITERS} iters) for time-to-target.  Re-measure with "
            "scripts/measure_cpu_ref.py when the workload shape changes."
        ),
        "ncam": int(os.environ.get("BENCH_NCAM", 128)),
        "nlmk": int(os.environ.get("BENCH_NLMK", 8192)),
        "vis": float(os.environ.get("BENCH_VIS", 0.1)),
        # The BUDGET, not the realized count (the LM loop may terminate on
        # its own small-step test a couple of iterations early): bench.py
        # validates budget-to-budget so both legs amortize fixed costs the
        # same way.
        "iters": ITERS,
        "iters_measured": main_stats["iters"],
        "iters_per_sec": round(main_stats["iters_per_sec"], 4),
        "wall_s": round(main_stats["wall_s"], 3),
        "compile_s": round(main_stats["compile_s"], 2),
        "start_cost": main_stats["start_cost"],
        "best_cost": main_stats["best_cost"],
        "target_iters": target_stats["iters"],
        "target_cost": target_stats["best_cost"],
    }
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=2)
        f.write("\n")
    print(json.dumps(ref, indent=2))


if __name__ == "__main__":
    main()
