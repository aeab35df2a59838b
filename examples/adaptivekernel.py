"""Adaptive ContaminatedGaussian kernel fitting — the reference's
examples/adaptivekernel.jl: jointly optimize the mixture parameters and a
mean over a contaminated sample, then compare against the EM fit.

Run:  python examples/adaptivekernel.py
"""

import sys

sys.path.insert(0, ".")
sys.path.insert(0, __file__.rsplit("/", 1)[0] if "/" in __file__ else ".")

import numpy as np
import jax.numpy as jnp

import nllstpu as nt

KERNEL = nt.ContaminatedGaussian()


def measurement(d, m):
    """One shared residual function: costs added with the SAME function
    object group into one padded batch (a fresh lambda per data point would
    compile 500 single-cost batches)."""
    return m - d


def main():
    rng = np.random.default_rng(0)
    inliers = rng.normal(3.0, 1.0, 450)
    outliers = rng.normal(3.0, 12.0, 50)
    data = np.concatenate([inliers, outliers])

    p = nt.Problem()
    kvar = p.add_variable(
        KERNEL.manifold, nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.5)
    )
    mean = p.add_variable(nt.Scalar(), 0.0)
    for d in data:
        p.add_cost(measurement, (kvar, mean), params=d, kernel=KERNEL)

    result = nt.optimize(p, nt.Options(iterator=nt.LEVENBERG_MARQUARDT))
    sw = np.asarray(
        nt.ContaminatedGaussian.sigmas_weight(jnp.asarray(p.get_value(kvar)))
    )
    print(result)
    print(f"\njoint LM fit: sigma1={sw[0]:.3f} sigma2={sw[1]:.3f} "
          f"w={sw[2]:.3f} mean={float(p.get_value(mean)):.3f}")
    print("ground truth: sigma1=1.0  sigma2=12.0  w=0.9  mean=3.0")

    # Pure EM on the residuals at the fitted mean.
    sq = jnp.asarray((data - float(p.get_value(mean))) ** 2)
    em = nt.em_fit(nt.ContaminatedGaussian.make_params(0.5, 5.0, 0.5), sq, 50)
    ew = np.asarray(nt.ContaminatedGaussian.sigmas_weight(em))
    print(f"EM fit:       sigma1={ew[0]:.3f} sigma2={ew[1]:.3f} w={ew[2]:.3f}")

    if "--html" in sys.argv:
        # Interactive slider app (reference examples/adaptivekernel.jl):
        # the slider interpolates the kernel parameters from the initial
        # guess to the converged fit, redrawing the implied mixture
        # density over the data histogram and the robust loss ρ.
        out = sys.argv[sys.argv.index("--html") + 1]
        from _htmlviz import write_adaptive_html

        m_fit = float(p.get_value(mean))
        sw0 = np.array([0.5, 5.0, 0.5])
        sw1 = sw
        xs = np.linspace(data.min() - 2, data.max() + 2, 241)
        frames, labels = [], []
        n_frames = 25
        for t in np.linspace(0.0, 1.0, n_frames):
            s1 = sw0[0] * (sw1[0] / sw0[0]) ** t  # log interp (positive)
            s2 = sw0[1] * (sw1[1] / sw0[1]) ** t
            w = (1 - t) * sw0[2] + t * sw1[2]
            r = xs - m_fit
            dens = w * np.exp(-0.5 * (r / s1) ** 2) / (
                s1 * np.sqrt(2 * np.pi)
            ) + (1 - w) * np.exp(-0.5 * (r / s2) ** 2) / (
                s2 * np.sqrt(2 * np.pi)
            )
            kp = nt.ContaminatedGaussian.make_params(s1, s2, w)
            rho = np.asarray(KERNEL.rho(kp, jnp.asarray(r * r)))
            rho = rho - rho.min()
            frames.append(
                {
                    "sw": [float(s1), float(s2), float(w)],
                    "mean": m_fit,
                    "density": [float(v) for v in dens],
                    "rho": [float(v) for v in rho],
                }
            )
            labels.append(
                f"t={t:.2f}  σ₁={s1:.2f} σ₂={s2:.2f} w={w:.2f}"
                + ("  (initial guess)" if t == 0 else "")
                + ("  (converged fit)" if t == 1 else "")
            )
        write_adaptive_html(out, data, frames, xs, labels)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
