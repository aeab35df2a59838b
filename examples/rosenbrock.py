"""Rosenbrock optimization with all four iterators — the reference's
examples/rosenbrock.jl without the GLMakie interactivity: prints the cost
trajectory per optimizer and writes an optional matplotlib contour plot.

Run:  python examples/rosenbrock.py [--plot out.png]
"""

import sys

sys.path.insert(0, ".")
sys.path.insert(0, __file__.rsplit("/", 1)[0] if "/" in __file__ else ".")

import numpy as np

import nllstpu as nt
from nllstpu.models.rosenbrock import make_rosenbrock


def main():
    trajectories = {}
    for iterator in (nt.NEWTON, nt.LEVENBERG_MARQUARDT, nt.DOGLEG,
                     nt.GRADIENT_DESCENT):
        start = (1.0 - 1e-2, 1.0) if iterator == nt.GRADIENT_DESCENT else (-0.5, 2.5)
        p, x, y = make_rosenbrock(x0=start[0], y0=start[1])
        ct = nt.CostTrajectory()
        result = nt.optimize(
            p, nt.Options(iterator=iterator), callback=nt.store_costs_callback(ct)
        )
        trajectories[iterator] = (ct, result, float(p.get_value(x)), float(p.get_value(y)))
        print(f"\n=== {iterator} ===")
        print(result)
        print(f"solution: ({trajectories[iterator][2]:.10f}, "
              f"{trajectories[iterator][3]:.10f})")
        print("costs:", " ".join(f"{c:.3e}" for c in ct.costs[:10]),
              "..." if len(ct.costs) > 10 else "")

    if "--html" in sys.argv:
        # Interactive trajectory viz (reference examples/rosenbrock.jl is a
        # GLMakie slider app; this emits a dependency-free HTML equivalent).
        out = sys.argv[sys.argv.index("--html") + 1]
        from _htmlviz import write_rosenbrock_html

        x0g, x1g, y0g, y1g = -1.6, 1.6, -0.6, 2.8
        xs = np.linspace(x0g, x1g, 160)
        ys = np.linspace(y0g, y1g, 120)
        xx, yy = np.meshgrid(xs, ys)
        a, b = 1.0, 10.0
        cost_grid = 0.5 * (
            (a * (1.0 - xx)) ** 2 + (b * (yy - xx * xx)) ** 2
        )
        paths, costs = {}, {}
        for name, (ct, result, _, _) in trajectories.items():
            p0 = np.array(
                [(1.0 - 1e-2, 1.0) if name == nt.GRADIENT_DESCENT
                 else (-0.5, 2.5)][0]
            )
            steps = np.array([np.asarray(s).reshape(-1) for s in ct.trajectory])
            pts = np.vstack([p0, p0 + np.cumsum(steps, axis=0)])
            paths[name] = pts.tolist()
            c0 = 0.5 * (
                (a * (1.0 - p0[0])) ** 2 + (b * (p0[1] - p0[0] ** 2)) ** 2
            )
            costs[name] = [c0] + list(ct.costs)
        write_rosenbrock_html(
            out, np.log10(np.maximum(cost_grid, 1e-12)),
            (x0g, x1g, y0g, y1g), paths, costs,
        )
        print(f"wrote {out}")

    if "--plot" in sys.argv:
        out = sys.argv[sys.argv.index("--plot") + 1]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(6, 4))
            for name, (ct, _, _, _) in trajectories.items():
                ax.semilogy(np.maximum(ct.costs, 1e-30), label=name)
            ax.set_xlabel("iteration")
            ax.set_ylabel("cost")
            ax.legend()
            fig.savefig(out, dpi=120, bbox_inches="tight")
            print(f"wrote {out}")
        except ImportError:
            print("matplotlib not available; skipping plot")


if __name__ == "__main__":
    main()
