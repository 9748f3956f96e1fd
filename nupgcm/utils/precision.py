"""Scoped matmul-precision policy.

At JAX's default precision an f32 dot or einsum may run in TF32 on the
GPU's tensor cores, which keeps about three decimal digits.  The FE
element contractions and Krylov basis products need true f32 to hold
the reference's 1e-3 golden bar (reference
test/bowl_mixing_tests.jl:101-103), so a model traces its functions
under ``jax.default_matmul_precision("float32")`` (HIGHEST).

The policy is scoped, never process-global: every function a model
traces is wrapped with :func:`scoped_precision`, which enters
``jax.default_matmul_precision`` only for the duration of that trace
(the setting participates in jit's trace context, so caching stays
correct).
"""

from __future__ import annotations

import contextlib
import functools


def precision_ctx(precision):
    """Context manager applying ``jax.default_matmul_precision`` when
    ``precision`` is a string; a no-op for ``None``."""
    import jax

    if precision is None:
        return contextlib.nullcontext()
    return jax.default_matmul_precision(precision)


def scoped_precision(fn, precision):
    """Wrap ``fn`` so its body runs (and hence traces) under the given
    matmul precision.  Identity for ``precision=None``."""
    if precision is None:
        return fn

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision_ctx(precision):
            return fn(*args, **kwargs)

    return wrapped
