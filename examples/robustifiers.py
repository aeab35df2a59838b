"""Robust kernel ρ / ρ′ / ρ″ sweep — the reference's examples/robustifiers.jl
as a table (and optional plot) instead of a GLMakie window.

Run:  python examples/robustifiers.py [--plot out.png]
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp
import numpy as np

import nllstpu as nt


def main():
    kernels = {
        "NoRobust": nt.NoRobust(),
        "Huber(1.5)": nt.Huber(1.5),
        "Huber2o(1.5)": nt.Huber2o(1.5),
        "GemanMcclure(1.5)": nt.GemanMcclure(1.5),
        "Scaled(Huber, 2)": nt.Scaled(nt.Huber(1.5), 2.0),
    }
    s = jnp.linspace(0.0, 16.0, 9)
    for name, k in kernels.items():
        rho, d1, d2 = k.rho_dc(s)
        print(f"\n=== {name} ===")
        print("s   :", " ".join(f"{v:8.3f}" for v in s))
        print("rho :", " ".join(f"{v:8.3f}" for v in rho))
        print("rho':", " ".join(f"{v:8.3f}" for v in d1))
        print('rho"', " ".join(f"{v:8.4f}" for v in d2))

    cg = nt.ContaminatedGaussian()
    kp = nt.ContaminatedGaussian.make_params(1.0, 10.0, 0.8)
    rho = jnp.stack([cg.rho(kp, si) for si in s])
    print("\n=== ContaminatedGaussian(1, 10, 0.8) ===")
    print("rho :", " ".join(f"{v:8.3f}" for v in rho))

    if "--plot" in sys.argv:
        out = sys.argv[sys.argv.index("--plot") + 1]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            ss = jnp.linspace(0.0, 16.0, 200)
            fig, ax = plt.subplots(figsize=(6, 4))
            for name, k in kernels.items():
                ax.plot(np.sqrt(ss), [float(k.rho(v)) for v in ss], label=name)
            ax.set_xlabel("|r|")
            ax.set_ylabel("rho(|r|^2)")
            ax.legend()
            fig.savefig(out, dpi=120, bbox_inches="tight")
            print(f"wrote {out}")
        except ImportError:
            print("matplotlib not available; skipping plot")


if __name__ == "__main__":
    main()
