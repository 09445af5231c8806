"""Accuracy-controlled distance / inner-product tiles.

Reduced-precision matmul inputs are not a benign speed knob for kernel
matrices: the ||x||^2 + ||y||^2 - 2 x.y expansion CANCELS, so rounding
the inputs puts absolute error on the squared distances of close points
and can break the PSD-ness that Cholesky-based logML needs.

Two remedies, both here:
  * small d (<= config.direct_sqdist_max_d): evaluate the difference
    form sum_i (x_i - y_i)^2 directly, unrolled over the static d —
    EXACT in f32 (no cancellation: subtract first); XLA fuses it into
    the MVM's row reduction.
  * larger d: keep the matmul expansion at a configurable precision.
    On an H100: "highest" = IEEE f32 (EQ MVM rel err ~1e-7 at
    d = 64..1024); "high" and "default" = TF32 (~3e-5), several times
    faster through cuBLAS or the fused Triton kernel.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .. import config as _config

_PREC = {"default": jax.lax.Precision.DEFAULT,
         "high": jax.lax.Precision.HIGH,
         "highest": jax.lax.Precision.HIGHEST}


def resolve_precision(precision=None):
    p = _config.DEFAULT.matmul_precision if precision is None else precision
    return _PREC.get(p, p)


def matmul_p(a, b, precision=None):
    """a @ b at the configured matmul precision. Output-side
    contractions (k1 @ A, W @ y, ...) have no cancellation, but reduced
    input precision still truncates kernel entries to ~3 digits — the
    reference's README touts machine precision, so accuracy is the
    default here too."""
    return jnp.matmul(a, b, precision=resolve_precision(precision))


def inner_tile(xb, y, precision=None):
    """(B, m) inner-product tile x_i . y_j at the configured precision."""
    return jax.lax.dot_general(
        xb, y, (((1,), (1,)), ((), ())), precision=resolve_precision(precision)
    )


def sqdist_tile(xb, y, precision=None, direct_max_d=None):
    """(B, m) squared-distance tile ||x_i - y_j||^2, exact at small d
    (unrolled difference form), matmul expansion otherwise."""
    d = xb.shape[1]
    dmax = _config.DEFAULT.direct_sqdist_max_d if direct_max_d is None else direct_max_d
    if d <= dmax:
        D = None
        for i in range(d):
            t = xb[:, i, None] - y[None, :, i]
            t = t * t
            D = t if D is None else D + t
        return D
    S = inner_tile(xb, y, precision)
    D = (jnp.sum(xb * xb, axis=1)[:, None]
         + jnp.sum(y * y, axis=1)[None, :] - 2.0 * S)
    return jnp.maximum(D, 0.0)
