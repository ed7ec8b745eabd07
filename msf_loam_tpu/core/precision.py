"""One precision rule for every matmul on the frame path: true float32.

An f32 ``dot_general`` left at DEFAULT precision may run with reduced-
precision inputs on an accelerator (TF32 on Hopper keeps ~3 decimal
digits). The frame cannot afford that anywhere:

* the odometry distance ``|q|^2 + |r|^2 - 2 q.r`` flips nearest-neighbour
  picks between near-equidistant candidates;
* ``Pose.apply`` at 50 m range rounds to centimetres;
* the GN normal equations and the pose-graph block-tridiagonal and
  Woodbury solves are ill-conditioned enough to diverge.

``f32_matmuls`` wraps a function so that it traces under
``jax.default_matmul_precision("highest")``: every ``dot_general`` it emits
(including those of nested jitted functions it calls) carries HIGHEST
precision, and the setting is part of jit's cache key. On the CPU this
changes nothing.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    """Run ``fn`` (and everything it traces) with f32 matmul precision."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)
    return wrapped
