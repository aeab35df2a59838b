"""SE(3) pose-graph optimization demo with the matrix-free CG backend.

Run:  python examples/posegraph_demo.py
"""

import sys

sys.path.insert(0, ".")

import numpy as np

import nllstpu as nt
from nllstpu.models.posegraph import make_pose_graph


def main():
    problem, poses, truth = make_pose_graph(
        n_poses=64, n_loops=16, noise=0.005, perturb=0.1
    )
    print(problem)
    print(f"initial cost: {nt.cost(problem):.6e}")
    result = nt.optimize(
        problem,
        nt.Options(iterator=nt.LEVENBERG_MARQUARDT, solver="cg"),
        unfixed=poses[1:],  # anchor the gauge at pose 0
    )
    print(result)
    final = np.stack([problem.get_value(h) for h in poses])
    err = np.linalg.norm(final[:, :, 3] - truth[:, :, 3], axis=1)
    print(f"translation error: mean {err.mean():.2e}, max {err.max():.2e}")


if __name__ == "__main__":
    main()
