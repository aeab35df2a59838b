"""Built-in problem families (the reference's examples/tests as library
models, plus BAL-scale families)."""

from .rosenbrock import make_rosenbrock
from .ba import make_affine_ba, make_pinhole_ba, perturb_ba, affine_project, pinhole_project
from .bal import (
    make_bal_problem,
    make_synthetic_bal,
    load_bal,
    write_bal,
    snavely_residual,
)
from .posegraph import make_pose_graph, relative_pose_residual
from .simple_error import measurement_residual
