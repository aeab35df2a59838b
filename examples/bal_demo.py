"""BAL bundle-adjustment demo: build (or load) a BAL problem, optimize with
the Schur backend, print the result breakdown.

Run:  python examples/bal_demo.py [path/to/problem.txt]

Without a path a synthetic BAL-format problem is generated (measurements from
ground truth + noise).  With a real BAL file (grail.cs.washington.edu/projects/bal)
the native C++ loader parses it at memory speed.
"""

import sys

sys.path.insert(0, ".")

import numpy as np

import nllstpu as nt
from nllstpu.models import bal


def main():
    if len(sys.argv) > 1:
        data = bal.load_bal(sys.argv[1])
        print(
            f"loaded {data['cameras'].shape[0]} cameras, "
            f"{data['points'].shape[0]} points, "
            f"{data['cam_idx'].shape[0]} observations"
        )
    else:
        data = bal.make_synthetic_bal(16, 512, obs_per_point=6, noise=0.5)
        print("synthetic BAL problem (16 cameras, 512 points)")

    problem, cams, pts = bal.make_bal_problem(data, robust_width=2.0)
    print(problem)
    print(f"initial cost: {nt.cost(problem):.6e}")

    result = nt.optimize(
        problem,
        nt.Options(
            iterator=nt.LEVENBERG_MARQUARDT,
            solver="schur",
            schur_family=bal.PT,
            max_iters=50,
        ),
    )
    print(result)


if __name__ == "__main__":
    main()
