#!/usr/bin/env python
"""Device-time breakdown of the direct Schur LM iteration on one GPU, and
the precision of its f32 reduced-system GEMM.

Usage:  python scripts/trace_direct.py [--out chiprun_out/trace_direct]

On the Ladybug-49-shaped problem of ``chip_smoke.py`` (f32, direct Schur,
Levenberg-Marquardt for a fixed number of iterations through
``nt.optimize``):

1. ``timing``: warm solves with the profiler off, each ended by the
   driver's own result readback (host clock).
2. ``trace``: one more solve under ``jax.profiler``; the device events are
   reduced by named scope (``assemble``, ``schur_damped_solve``, ``cost``;
   the rest is ``other``) through the ``op_name`` metadata of the compiled
   loop.  Device time per scope, per iteration and as a share of busy time,
   and the window's busy and idle shares.
3. ``standalone``: each phase jitted alone and timed with
   ``jax.block_until_ready`` — a cross-check of the trace attribution.
4. ``precision``: the f32 S = (W·H⁻¹)·Wᵀ GEMM at DEFAULT, HIGH and HIGHEST
   against an f64 product of the same operands, its time at each, and for
   each the damped step's cosine with the f64 dense step and the 20-iteration
   best cost over the f64 run's (the checks of ``chip_smoke.py`` phase 2).

Prints one JSON line per part.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402

SCOPES = ("assemble", "schur_damped_solve", "cost")
_OP_NAME = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"", re.M
)


def op_names(hlo_text):
    """HLO instruction name → ``op_name`` metadata (the jax name stack)."""
    return {m.group(1): m.group(2) for m in _OP_NAME.finditer(hlo_text)}


def scope_of(op_name):
    """Innermost of :data:`SCOPES` on an ``op_name`` path, else ``other``."""
    for part in reversed(op_name.split("/")):
        if part in SCOPES:
            return part
    return "other"


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path, names, device_prefix="/device:GPU"):
    """Device time by scope from one ``.xplane.pb``.

    Events on the device planes' stream lines carry an ``hlo_op`` stat (or
    a kernel name that is the HLO name with ``_`` for ``.``); it is looked
    up in ``names`` (see :func:`op_names`) and its time charged to
    :func:`scope_of` its op_name.  Only the ``Stream`` lines count where a
    plane has them (otherwise the lines with ``hlo_op`` events), so derived
    summary lines do not count twice."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    by_scope = collections.defaultdict(float)
    by_op = collections.defaultdict(float)
    calls = collections.Counter()
    lines_seen = collections.Counter()
    spans = []
    unmapped = 0
    for plane in pd.planes:
        if not plane.name.startswith(device_prefix):
            continue
        lines = list(plane.lines)
        streams = any(line.name.startswith("Stream") for line in lines)
        for line in lines:
            events = list(line.events)
            stats = [dict(ev.stats) for ev in events]
            keep = (
                line.name.startswith("Stream") if streams
                else any("hlo_op" in s for s in stats)
            )
            tag = f"{plane.name}|{line.name}" + ("" if keep else "|skipped")
            lines_seen[tag] += len(events)
            if not keep:
                continue
            for ev, st in zip(events, stats):
                spans.append((ev.start_ns, ev.end_ns))
                # Inside a command buffer the stat names the buffer, not
                # the op; the kernel name then stands in for it.
                op = st.get("hlo_op")
                if op not in names:
                    op = re.sub(r"_(\d+)$", r".\1", ev.name)
                name = names.get(op)
                if name is None:
                    unmapped += 1
                    scope = "other"
                else:
                    scope = scope_of(name)
                by_scope[scope] += ev.duration_ns
                by_op[(scope, op, ev.name[:80])] += ev.duration_ns
                calls[(scope, op, ev.name[:80])] += 1
    busy = _union(spans)
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:25]
    return {
        "events": len(spans),
        "unmapped_events": unmapped,
        "lines": dict(lines_seen),
        "window_ns": window,
        "busy_ns": busy,
        "idle_share": (1 - busy / window) if window else None,
        "by_scope_ns": dict(by_scope),
        "top": [[s, op, k, ns, calls[(s, op, k)]] for (s, op, k), ns in top],
    }


def _problem(dtype):
    return cs._bal_problem(cs.LADYBUG, dtype)


def _opts(iters):
    return cs._fixed_options(iters, solver="schur", schur_family=cs._pt())


def part_timing_and_trace(dev, iters, reps, out_dir):
    import jax
    import jax.numpy as jnp

    import nllstpu as nt
    from nllstpu.core import optimize as opt

    problem, nobs = _problem(jnp.float32)
    v0 = problem.stacked_variables()
    opts = _opts(iters)
    walls = []
    with jax.default_device(dev):
        first = nt.optimize(problem, opts)
        for _ in range(reps):
            problem.set_values(v0)
            t0 = time.perf_counter()
            res = nt.optimize(problem, opts)
            walls.append(time.perf_counter() - t0)
    entry = next(e for e, ref in opt._runner_cache.values() if ref() is problem)
    hlo = entry.runner()._start.as_text()
    print(json.dumps({
        "part": "timing", "observations": nobs, "iterations": iters,
        "compile_s": first.time_init, "wall_s": walls,
        "per_iter_ms": [w / res.num_iterations * 1e3 for w in walls],
        "best_cost": res.best_cost, "start_cost": res.start_cost,
        "peak_bytes_in_use": cs._peak_bytes(dev),
    }))

    trace_dir = os.path.join(out_dir, "xplane")
    with jax.default_device(dev):
        problem.set_values(v0)
        with jax.profiler.trace(trace_dir):
            t0 = time.perf_counter()
            res = nt.optimize(problem, opts)
            wall = time.perf_counter() - t0
    path = sorted(glob.glob(
        os.path.join(trace_dir, "plugins", "profile", "*", "*.xplane.pb")
    ))[-1]
    red = reduce_trace(path, op_names(hlo))
    n = res.num_iterations
    busy = red["busy_ns"] or 1
    red["per_iter_ms"] = {
        k: v / n / 1e6 for k, v in red["by_scope_ns"].items()
    }
    red["share_of_busy"] = {
        k: v / busy for k, v in red["by_scope_ns"].items()
    }
    print(json.dumps({"part": "trace", "iterations": n, "wall_s": wall,
                      "xplane": os.path.relpath(path, HERE), **red}))
    return problem, v0


def _best_of(fn, args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def part_standalone(dev, problem, v0):
    """Each phase of one iteration jitted alone, best-of-20 wall time."""
    import jax
    import jax.numpy as jnp

    from nllstpu.core.optimize import compile_problem

    c = compile_problem(problem, solver="schur", schur_family=cs._pt())
    ops = c.schur_info.ops()
    with jax.default_device(dev):
        v = jax.device_put(v0, dev)
        assemble = jax.jit(c.assemble)
        _, sys_ = assemble(v)
        lam = jnp.asarray(1e-4, jnp.float32) * ops.diag_max(sys_)
        solve = jax.jit(ops.solve)
        x = solve(sys_, lam)
        step_cost = jax.jit(lambda v, x: c.cost(c.apply(v, -x)))
        out = {
            "assemble_ms": _best_of(assemble, (v,)) * 1e3,
            "schur_damped_solve_ms": _best_of(solve, (sys_, lam)) * 1e3,
            "apply_and_cost_ms": _best_of(step_cost, (v, x)) * 1e3,
        }
    print(json.dumps({"part": "standalone", **out}))


def part_precision(dev, iters):
    """S GEMM error and time at each precision, and phase 2's step and
    best-cost checks with the S GEMM at that precision."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from nllstpu.core.linearsolver import batched_inv_spd_cm
    from nllstpu.core.optimize import compile_problem
    from nllstpu.ops import schur

    p64, _ = _problem(jnp.float64)
    v64 = p64.stacked_variables()
    with jax.default_matmul_precision("highest"):
        _, f64 = cs._optimize(p64, _opts(iters), dev)
        p64.set_values(v64)
        s64, lam = cs._damped_steps(p64, dev)
    xd = s64["dense"]

    p32, _ = _problem(jnp.float32)
    c = compile_problem(p32, solver="schur", schur_family=cs._pt())
    with jax.default_device(dev):
        _, (a_rr, b_r, h_ll, g_l, w) = jax.jit(c.assemble)(
            p32.stacked_variables()
        )
        eye = jnp.eye(h_ll.shape[0], dtype=h_ll.dtype)[:, :, None]
        h_inv = batched_inv_spd_cm(h_ll + jnp.float32(lam) * eye)
        y = jnp.einsum("dlr,del->elr", w, h_inv, precision="highest")
        s_ref = np.asarray(jnp.einsum(
            "elr,els->rs", y.astype(jnp.float64), w.astype(jnp.float64),
            precision="highest",
        ))
        saved = schur.F32_S_PRECISION
        try:
            for prec in (jax.lax.Precision.DEFAULT, jax.lax.Precision.HIGH,
                         jax.lax.Precision.HIGHEST):
                gemm = jax.jit(lambda y, w, prec=prec: jnp.einsum(
                    "elr,els->rs", y, w, precision=prec))
                s = np.asarray(gemm(y, w), np.float64)
                err = np.linalg.norm(s - s_ref) / np.linalg.norm(s_ref)
                schur.F32_S_PRECISION = prec
                s32, _ = cs._damped_steps(p32, dev, lam=lam)
                xs = s32["schur"]
                cos = float(xs @ xd / (np.linalg.norm(xs) * np.linalg.norm(xd)))
                p_run, _ = _problem(jnp.float32)
                _, f32 = cs._optimize(p_run, _opts(iters), dev)
                print(json.dumps({
                    "part": "precision", "precision": prec.name,
                    "s_rel_err": float(err),
                    "s_gemm_ms": _best_of(gemm, (y, w)) * 1e3,
                    "s_shape": list(s.shape), "k": int(y.shape[0] * y.shape[1]),
                    "step_cos_vs_dense64": cos,
                    "best_cost_over_f64": f32["best_cost"] / f64["best_cost"],
                    "solve_s": f32["solve_s"],
                }))
        finally:
            schur.F32_S_PRECISION = saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "trace_direct"))
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--no-precision", action="store_true",
                    help="skip the precision part")
    args = ap.parse_args(argv)

    dev = cs.require_gpu()
    card = cs.query_card()

    import jax

    import nllstpu  # noqa: F401  (enables x64)
    from nllstpu.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    os.makedirs(args.out, exist_ok=True)
    print(card)
    print(json.dumps({"nvidia_smi": card, "device_kind": dev.device_kind,
                      "jax": jax.__version__,
                      "xla_flags": os.environ.get("XLA_FLAGS", "")}))
    problem, v0 = part_timing_and_trace(dev, args.iters, args.reps, args.out)
    part_standalone(dev, problem, v0)
    if not args.no_precision:
        part_precision(dev, args.iters)


if __name__ == "__main__":
    main()
