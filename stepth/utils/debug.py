"""Numerical-safety debugging helpers (SURVEY.md §5 "race detection /
sanitizers" row: the functional recast of the reference's Rust safety net).

Pure-functional JAX has no data races; what replaces the sanitizer story is
*numerical* checking — NaN/Inf surfacing:

* ``checked(fn)``      — wrap a jittable fn with ``checkify`` so NaN/Inf/OOB
                         raise structured errors instead of propagating junk;
* ``assert_finite``    — host-side pytree NaN/Inf assertion for tests.
"""

from __future__ import annotations

from typing import Any, Callable

import jax
import numpy as np
from jax.experimental import checkify


def checked(fn: Callable, errors=None) -> Callable:
    """Return a wrapped ``fn`` that raises on NaN/Inf/div-by-zero/OOB-index.

    The wrapper jit-compiles the checkified function; call it exactly like
    ``fn`` — it raises ``checkify.JaxRuntimeError`` on the first failed check.
    """
    if errors is None:
        errors = checkify.float_checks | checkify.index_checks | checkify.div_checks
    cfn = jax.jit(checkify.checkify(fn, errors=errors))

    def wrapped(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapped


def assert_finite(tree: Any, name: str = "value") -> None:
    """Host-side: raise AssertionError if any leaf holds NaN/Inf."""
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.isfinite(arr).all():
            bad = (~np.isfinite(arr)).sum()
            raise AssertionError(f"{name}: leaf {i} has {bad} non-finite values")
