"""Checkpoint / resume for optimization state.

The reference has no checkpointing (SURVEY.md §5); its nearest analogs are
the ``varbest`` snapshot and callback-driven problem mutation.  For
long-running solves this module saves/restores the variable state (and
optionally iterator scalars) as a plain ``.npz``, so a run can resume from
the best-known variables after preemption.
"""

from __future__ import annotations

import numpy as np


def save_variables(path: str, problem, extra: dict = None):
    """Save all variable families of ``problem`` (plus optional extra float
    scalars, e.g. the current LM lambda) to ``path``."""
    payload = {}
    for name, fam in problem._families.items():
        payload[f"var::{name}"] = np.asarray(fam.values)
    for key, val in (extra or {}).items():
        payload[f"extra::{key}"] = np.asarray(val)
    np.savez(path, **payload)


def load_variables(path: str, problem) -> dict:
    """Restore variable values saved by :func:`save_variables` into
    ``problem`` (families must match by name and shape); returns the extras
    dict."""
    data = np.load(path)
    extras = {}
    for key in data.files:
        if key.startswith("var::"):
            name = key[len("var::"):]
            fam = problem._families.get(name)
            if fam is None:
                raise KeyError(f"problem has no variable family {name!r}")
            arr = data[key]
            if arr.shape != fam.values.shape:
                raise ValueError(
                    f"family {name!r}: saved shape {arr.shape} != current "
                    f"{fam.values.shape}"
                )
            fam.values[:] = arr
        elif key.startswith("extra::"):
            extras[key[len("extra::"):]] = data[key]
    problem._dirty = True
    return extras
