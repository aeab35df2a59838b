#!/usr/bin/env python
"""Smoke run of the solver on one NVIDIA GPU, through its public entry points.

Usage:  python chip_smoke.py          # one card: phases 1-5
        python chip_smoke.py --four   # four cards: landmark-sharded phases only

All data is generated from a seed by ``nllstpu.models.bal.make_realistic_bal``
(or ``make_pinhole_ba``) at shapes of the BAL table (Agarwal et al., "Bundle
Adjustment in the Large", ECCV 2010); no file is read.

One card:
  1. Ladybug-49 shape (49 cameras, 7,776 points, ~34k observations), direct
     Schur, f32, 20 Levenberg-Marquardt iterations via ``nt.optimize``.
  2. The same problem in f64 under ``jax.default_matmul_precision("highest")``
     — the reference run — and one damped LM step at the same λ through the
     direct Schur solve and through the dense normal equations (the plain
     reference for the Schur math), in f64 and in f32.
  3. The same problem through the implicit Schur solve (``schur_cg``), f32.
  4. Flagship pinhole BA (128 SE(3) cameras, 8,192 landmarks, ~105k
     observations), direct Schur, f32.
  5. Dubrovnik-356 shape (356 cameras, 226,730 points, ~1.26M observations),
     ``solver="schur"``, f32, 5 iterations: its dense W is past
     ``DENSE_W_BYTE_LIMIT``, so the compile routes it to the implicit solve.

Four cards (``--four``): the realistic 128-camera / 8,192-point shape through
``optimize_sharded`` with direct and with implicit landmark sharding, in f64,
each against the same solve on device 0 of this process, and the per-card W
and ``H_ll`` shards checked to be a quarter of the global arrays.

Each phase prints one JSON line; a failed check makes the exit code non-zero.
The last line is the result object ``{"ok": true, "device": {...}}``.  Without
a GPU, or without ``nvidia-smi``, or outside a checkout of this repository,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))

#: Shapes (BAL table rows, ECCV 2010) — generator arguments.
LADYBUG = dict(ncameras=49, npoints=7776, seed=1, noise=1e-3, track_alpha=2.3)
FLAGSHIP = dict(ncameras=128, nlandmarks=8192, prop_visible=0.1, noise=1e-3)
DUBROVNIK = dict(ncameras=356, npoints=226730, seed=1, noise=1e-3,
                 track_alpha=2.0)
REALISTIC = dict(ncameras=128, npoints=8192, seed=1, noise=1e-3,
                 track_alpha=1.6, max_track=96)

FULL = dict(ladybug=LADYBUG, flagship=FLAGSHIP, dubrovnik=DUBROVNIK,
            realistic=REALISTIC, iters=20, large_iters=5, shard_iters=10)

#: Phase-2 tolerances, each with the reason it is what it is.
TOLERANCES = {
    "schur64_vs_dense64_rel": (
        1e-6,
        "same linear system solved two ways in f64; differences are "
        "round-off amplified by the damped system's conditioning",
    ),
    "schur32_vs_dense64_cos": (
        0.999,
        "f32 assembly and solve against the f64 reference: direction must "
        "agree, magnitudes carry f32 round-off of an ill-conditioned system",
    ),
    "start_cost_f32_vs_f64_rel": (
        1e-5,
        "one f32 cost pass over ~34k residuals: ~sqrt(n) * 2^-24 relative",
    ),
    "best_cost_f32_over_f64": (
        1.1,
        "f32 LM must reach within 10% of the f64 optimum in the same "
        "iteration budget",
    ),
    "implicit_over_direct": (
        1.5,
        "inexact CG steps may converge more slowly than the direct solve",
    ),
    "sharded_vs_single_rel": (
        1e-6,
        "same f64 solve, partial sums reduced across cards in another order",
    ),
}


def require_gpu():
    """The first JAX device, which must be a GPU; exits non-zero otherwise
    (no CPU fallback)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(
            f"chip_smoke: no GPU found (JAX's first device is "
            f"{dev.platform!r}); this script measures the card only"
        )
    return dev


def query_card():
    """``nvidia-smi``'s name and power limit for the card(s), from a child
    process that stays off JAX; exits non-zero when nvidia-smi is missing
    or fails instead of assuming a card."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        sys.exit("chip_smoke: nvidia-smi not found; cannot identify the card")
    proc = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        sys.exit(f"chip_smoke: nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def result_line(devices):
    """The contract's last line for the devices a run used."""
    d = devices[0]
    return {
        "ok": True,
        "device": {
            "platform": d.platform,
            "kind": d.device_kind,
            "count": len(devices),
        },
    }


def _peak_bytes(dev):
    """The process's peak device memory so far (JAX cannot reset it, so a
    later phase reports the largest of all earlier ones)."""
    stats = dev.memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")


def _fixed_options(iters, **kw):
    """LM for exactly ``iters`` iterations: every early-termination test
    off; a finite ``max_time`` so the driver compiles before its clock."""
    import nllstpu as nt

    return nt.Options(
        iterator=nt.LEVENBERG_MARQUARDT, max_iters=iters, rel_dcost=0.0,
        abs_dcost=0.0, dstep=0.0, max_fails=1 << 30, max_time=1e9, **kw,
    )


def _bal_problem(shape, dtype):
    from nllstpu.models import bal
    from nllstpu.models.ba import perturb_ba

    data = bal.make_realistic_bal(**shape)
    problem, _, pts = bal.make_bal_problem(data, dtype=dtype)
    perturb_ba(problem, pts, 0.05, seed=5)
    return problem, len(data["pt_idx"])


def _optimize(problem, options, dev):
    """``nt.optimize`` on ``dev``; returns the result fields every phase
    prints.  ``setup_s`` is the host-side compile of the problem (layout,
    repacks), ``compile_s`` the XLA compile of the loop, ``solve_s`` the
    run itself."""
    import jax

    import nllstpu as nt

    with jax.default_device(dev):
        t0 = time.perf_counter()
        res = nt.optimize(problem, options)
        wall = time.perf_counter() - t0
    return res, {
        "start_cost": res.start_cost,
        "best_cost": res.best_cost,
        "iterations": res.num_iterations,
        "setup_s": wall - res.time_total,
        "compile_s": res.time_init,
        "solve_s": res.time_total - res.time_init,
        "peak_bytes_in_use": _peak_bytes(dev),
    }


def _record(name, shape, dtype, dev, fields, checks):
    return {
        "phase": name,
        "shape": shape,
        "dtype": dtype,
        "backend": dev.platform,
        **fields,
        "checks": checks,
        "ok": all(c["ok"] for c in checks.values()),
    }


def _check(value, limit, kind, key=None):
    ok = bool(value <= limit) if kind == "max" else bool(value >= limit)
    out = {"value": float(value), kind: limit, "ok": ok}
    if key is not None:
        out["why"] = TOLERANCES[key][1]
    return out


def _shape_desc(shape, nobs):
    out = {k: v for k, v in shape.items() if k in (
        "ncameras", "npoints", "nlandmarks")}
    out["observations"] = int(nobs)
    return out


def variable_order(compiled):
    """Indices that put a flat step vector of ``compiled``'s layout into a
    layout-independent order: family name, then variable index, then
    tangent dof (fixed variables omitted), so vectors from differently
    ordered layouts (direct Schur vs dense) compare entrywise."""
    import numpy as np

    parts = []
    for fam in sorted(compiled.layout.offsets):
        offs = np.asarray(compiled.layout.offsets[fam])
        offs = offs[offs < compiled.layout.dof_total]
        dof = compiled.manifolds[fam].dof
        parts.append((offs[:, None] + np.arange(dof)[None, :]).reshape(-1))
    return np.concatenate(parts)


def step_by_variable(compiled, x):
    """Step vector ``x`` in :func:`variable_order`."""
    import numpy as np

    return np.asarray(x, dtype=np.float64)[variable_order(compiled)]


def phase_direct_f32(dev, shape, iters):
    """Phase 1: direct Schur, f32."""
    import jax.numpy as jnp

    problem, nobs = _bal_problem(shape, jnp.float32)
    _, f = _optimize(problem, _fixed_options(iters, solver="schur",
                                             schur_family=_pt()), dev)
    checks = {"decreased": {"value": f["best_cost"], "max": f["start_cost"],
                            "ok": f["best_cost"] < f["start_cost"]}}
    return _record("1_ladybug_direct_f32", _shape_desc(shape, nobs),
                   "float32", dev, f, checks)


def _pt():
    from nllstpu.models import bal

    return bal.PT


def _damped_steps(problem, dev, lam=None, rel=1e-4):
    """One damped LM step through the direct Schur solve and through the
    dense normal equations, in layout-independent order.  λ is ``lam``, or
    ``rel`` times the system's largest diagonal entry (LM's scale-aware
    damping; the Schur and dense systems share that entry).  Returns
    ``({solver: step}, λ)``."""
    import jax
    import jax.numpy as jnp

    from nllstpu.core.iterators import DenseOps
    from nllstpu.core.optimize import compile_problem

    v = problem.stacked_variables()
    dtype = problem.dtype
    out = {}
    with jax.default_device(dev):
        for solver in ("schur", "dense"):
            c = compile_problem(problem, solver=solver, schur_family=_pt())
            ops = (
                c.schur_info.ops() if solver == "schur"
                else DenseOps(c.layout.dof_total)
            )

            def step(vars_, c=c, ops=ops):
                _, sys_ = c.assemble(vars_)
                lam_ = (
                    jnp.asarray(lam, dtype) if lam is not None
                    else rel * ops.diag_max(sys_)
                )
                return ops.solve(sys_, lam_), lam_

            x, lam_used = jax.jit(step)(v)
            out[solver] = step_by_variable(c, x)
            if lam is None:
                lam = float(lam_used)
            del x
    return out, lam


def phase_reference_f64(dev, shape, iters, f32_record):
    """Phase 2: the f64 reference run and the Schur-vs-dense step checks."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    p64, nobs = _bal_problem(shape, jnp.float64)
    v0 = p64.stacked_variables()
    with jax.default_matmul_precision("highest"):
        _, f = _optimize(p64, _fixed_options(iters, solver="schur",
                                             schur_family=_pt()), dev)
        p64.set_values(v0)
        s64, lam = _damped_steps(p64, dev)
    p32, _ = _bal_problem(shape, jnp.float32)
    s32, _ = _damped_steps(p32, dev, lam=lam)
    xd, xs64, xs32 = s64["dense"], s64["schur"], s32["schur"]
    rel = np.linalg.norm(xs64 - xd) / np.linalg.norm(xd)
    cos = float(xs32 @ xd / (np.linalg.norm(xs32) * np.linalg.norm(xd)))
    start_rel = abs(f32_record["start_cost"] - f["start_cost"]) / f["start_cost"]
    best_ratio = f32_record["best_cost"] / f["best_cost"]
    t = TOLERANCES
    checks = {
        "schur64_vs_dense64_rel": _check(
            rel, t["schur64_vs_dense64_rel"][0], "max",
            "schur64_vs_dense64_rel"),
        "schur32_vs_dense64_cos": _check(
            cos, t["schur32_vs_dense64_cos"][0], "min",
            "schur32_vs_dense64_cos"),
        "start_cost_f32_vs_f64_rel": _check(
            start_rel, t["start_cost_f32_vs_f64_rel"][0], "max",
            "start_cost_f32_vs_f64_rel"),
        "best_cost_f32_over_f64": _check(
            best_ratio, t["best_cost_f32_over_f64"][0], "max",
            "best_cost_f32_over_f64"),
    }
    f["lambda"] = lam
    f["dense_dim"] = int(xd.shape[0])
    return _record("2_ladybug_reference_f64", _shape_desc(shape, nobs),
                   "float64", dev, f, checks)


def phase_implicit_f32(dev, shape, iters, direct_record):
    """Phase 3: implicit Schur (``schur_cg``), f32."""
    import jax.numpy as jnp

    problem, nobs = _bal_problem(shape, jnp.float32)
    _, f = _optimize(problem, _fixed_options(iters, solver="schur_cg",
                                             schur_family=_pt()), dev)
    ratio = f["best_cost"] / direct_record["best_cost"]
    checks = {
        "decreased": {"value": f["best_cost"], "max": f["start_cost"],
                      "ok": f["best_cost"] < f["start_cost"]},
        "implicit_over_direct": _check(
            ratio, TOLERANCES["implicit_over_direct"][0], "max",
            "implicit_over_direct"),
    }
    return _record("3_ladybug_implicit_f32", _shape_desc(shape, nobs),
                   "float32", dev, f, checks)


def phase_flagship_f32(dev, shape, iters):
    """Phase 4: flagship SE(3)+pinhole BA, direct Schur, f32."""
    import jax.numpy as jnp

    import nllstpu as nt
    from nllstpu.models.ba import make_pinhole_ba, perturb_ba

    problem, _, lmks = make_pinhole_ba(
        dtype=jnp.float32, batched="cm", **shape
    )
    perturb_ba(problem, lmks, 0.05, seed=5)
    nobs = sum(int(b.mask.sum()) for b in problem.batches())
    _, f = _optimize(problem, _fixed_options(
        iters, solver="schur", schur_family=nt.Euclidean(3)), dev)
    checks = {"decreased": {"value": f["best_cost"], "max": f["start_cost"],
                            "ok": f["best_cost"] < f["start_cost"]}}
    return _record("4_flagship_pinhole_direct_f32", _shape_desc(shape, nobs),
                   "float32", dev, f, checks)


def phase_large_f32(dev, shape, iters):
    """Phase 5: Dubrovnik shape through ``solver="schur"``; the dense-W
    budget routes it to the implicit solve."""
    import jax.numpy as jnp

    from nllstpu.core import optimize as opt

    problem, nobs = _bal_problem(shape, jnp.float32)
    _, f = _optimize(problem, _fixed_options(iters, solver="schur",
                                             schur_family=_pt()), dev)
    # The compiled problem optimize() cached for this problem says which
    # backend actually ran.
    implicit = any(
        ref() is problem and entry.compiled.schur_info.implicit
        for entry, ref in opt._runner_cache.values()
    )
    checks = {
        "decreased": {"value": f["best_cost"], "max": f["start_cost"],
                      "ok": f["best_cost"] < f["start_cost"]},
        "routed_implicit": {"value": implicit, "ok": implicit},
    }
    return _record("5_dubrovnik_schur_auto_implicit_f32",
                   _shape_desc(shape, nobs), "float32", dev, f, checks)


def run_single(dev, shapes, emit=print):
    """Phases 1-5 on ``dev``; returns their records."""
    recs = []

    def done(r):
        recs.append(r)
        emit(json.dumps(r))
        return r

    r1 = done(phase_direct_f32(dev, shapes["ladybug"], shapes["iters"]))
    done(phase_reference_f64(dev, shapes["ladybug"], shapes["iters"], r1))
    done(phase_implicit_f32(dev, shapes["ladybug"], shapes["iters"], r1))
    done(phase_flagship_f32(dev, shapes["flagship"], shapes["iters"]))
    done(phase_large_f32(dev, shapes["dubrovnik"], shapes["large_iters"]))
    return recs


def phase_sharded_f64(devs, shape, iters, solver):
    """Landmark-sharded ``optimize_sharded`` over ``devs`` against the same
    f64 solve on ``devs[0]``."""
    import jax
    import jax.numpy as jnp

    from nllstpu.parallel.mesh import make_mesh
    from nllstpu.parallel.schur_shard import optimize_sharded

    opts = _fixed_options(iters, solver=solver, schur_family=_pt())
    p_ref, nobs = _bal_problem(shape, jnp.float64)
    with jax.default_matmul_precision("highest"):
        _, f_ref = _optimize(p_ref, opts, devs[0])
        p_sh, _ = _bal_problem(shape, jnp.float64)
        t0 = time.perf_counter()
        res = optimize_sharded(p_sh, make_mesh(len(devs), devices=devs), opts)
        wall = time.perf_counter() - t0
    rel = abs(res.best_cost - f_ref["best_cost"]) / f_ref["best_cost"]
    f = {
        "start_cost": res.start_cost,
        "best_cost": res.best_cost,
        "single_best_cost": f_ref["best_cost"],
        "iterations": res.num_iterations,
        "seconds": wall,
        "single_solve_s": f_ref["solve_s"],
    }
    checks = {
        "sharded_vs_single_rel": _check(
            rel, TOLERANCES["sharded_vs_single_rel"][0], "max",
            "sharded_vs_single_rel"),
        "decreased": {"value": res.best_cost, "max": res.start_cost,
                      "ok": res.best_cost < res.start_cost},
    }
    return _record(f"four_sharded_{solver}_f64", _shape_desc(shape, nobs),
                   "float64", devs[0], f, checks)


def phase_shard_shapes(devs, shape):
    """Per-card W and H_ll shards are exactly 1/n of the global arrays."""
    import jax.numpy as jnp

    from nllstpu.core.optimize import compile_problem
    from nllstpu.parallel.mesh import make_mesh
    from nllstpu.parallel.schur_shard import parallelize_schur

    n = len(devs)
    problem, nobs = _bal_problem(shape, jnp.float64)
    c = compile_problem(problem, solver="schur", schur_family=_pt())
    par = parallelize_schur(c, make_mesh(n, devices=devs))
    _, (_, _, h_ll, _, w) = par.assemble(problem.stacked_variables())
    checks = {}
    for name, arr, axis in (("h_ll", h_ll, 2), ("w", w, 1)):
        shard = arr.addressable_shards[0].data
        expect = tuple(
            s // n if ax == axis else s for ax, s in enumerate(arr.shape)
        )
        ok = (
            shard.shape == expect
            and shard.nbytes * n == arr.nbytes
            and len(arr.sharding.device_set) == n
        )
        checks[f"{name}_shard_is_1/{n}"] = {
            "value": list(shard.shape), "global": list(arr.shape), "ok": ok,
        }
    return _record("four_shard_shapes", _shape_desc(shape, nobs), "float64",
                   devs[0], {"landmark_slots": int(h_ll.shape[-1])}, checks)


def run_four(devs, shapes, emit=print):
    """The landmark-sharded phases over ``devs``; returns their records."""
    recs = []
    for r in (
        phase_shard_shapes(devs, shapes["realistic"]),
        phase_sharded_f64(devs, shapes["realistic"], shapes["shard_iters"],
                          "schur"),
        phase_sharded_f64(devs, shapes["realistic"], shapes["shard_iters"],
                          "schur_cg"),
    ):
        recs.append(r)
        emit(json.dumps(r))
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the landmark-sharded phases on 4 cards")
    args = ap.parse_args(argv)

    if not os.path.isfile(os.path.join(_HERE, "nllstpu", "__init__.py")):
        sys.exit("chip_smoke: run from a checkout of the repository "
                 "(nllstpu/ not found beside this script)")
    sys.path.insert(0, _HERE)
    dev = require_gpu()
    card = query_card()

    import jax

    import nllstpu  # noqa: F401  (enables x64)
    from nllstpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache()
    print(card)
    print(json.dumps({
        "nvidia_smi": card, "device_kind": dev.device_kind,
        "jax": jax.__version__, "devices": len(jax.devices()),
        "compile_cache": cache,
    }))
    if args.four:
        devs = jax.devices()[:4]
        if len(devs) < 4:
            sys.exit(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}")
        recs = run_four(devs, FULL)
    else:
        devs = [dev]
        recs = run_single(dev, FULL)
    failed = [r["phase"] for r in recs if not r["ok"]]
    if failed:
        sys.exit(f"chip_smoke: failed phases: {failed}")
    print(json.dumps(result_line(devs)))


if __name__ == "__main__":
    main()
