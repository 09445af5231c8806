"""Test oracles and property probes.

Rebuild of reference src/util.jl:91-149 (`ispsd`, `iscov`, randomized
`isstationary`/`isisotropic` numeric probes) plus the dense nested-vmap
pairwise oracle used throughout the test suite (the analogue of the
reference's generic-fallback-as-oracle pattern, SURVEY.md §4.1)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def _pairwise(k, x, y):
    return jax.vmap(lambda xi: jax.vmap(lambda yj: k(xi, yj))(y))(x)


def pairwise(k, x, y=None):
    """Dense kernel matrix by direct per-pair evaluation (oracle; O(n m)
    memory — test use only)."""
    x = jnp.asarray(x)
    y = x if y is None else jnp.asarray(y)
    return _pairwise(k, x, y)


def ispsd(A, tol: float = 1e-8) -> bool:
    ev = np.linalg.eigvalsh(np.asarray(A))
    return bool(ev.min() > -tol)


def iscov(A, tol: float = 1e-8) -> bool:
    A = np.asarray(A)
    return bool(np.allclose(A, A.T, atol=tol)) and ispsd(A, tol)


def isstationary_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check that k(x+s, y+s) == k(x, y) (src/util.jl:103-126)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, d)))
    y = jnp.asarray(rng.standard_normal((n, d)))
    s = jnp.asarray(rng.standard_normal((1, d)))
    a = pairwise_xy(k, x, y)
    b = pairwise_xy(k, x + s, y + s)
    return bool(np.allclose(np.asarray(a), np.asarray(b), atol=tol))


def isisotropic_probe(k, d: int = 3, n: int = 16, seed: int = 0, tol=1e-8) -> bool:
    """Randomized check of rotation invariance (src/util.jl:128-149)."""
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((n, d)))
    y = jnp.asarray(rng.standard_normal((n, d)))
    Q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    Q = jnp.asarray(Q)
    a = pairwise_xy(k, x, y)
    b = pairwise_xy(k, x @ Q.T, y @ Q.T)
    return isstationary_probe(k, d, n, seed, tol) and bool(
        np.allclose(np.asarray(a), np.asarray(b), atol=tol)
    )


@jax.jit
def pairwise_xy(k, x, y):
    return jax.vmap(lambda xi: jax.vmap(lambda yj: k(xi, yj))(y))(x)


def round_mantissa(x, bits: int) -> np.ndarray:
    """x as f32, rounded to nearest with `bits` explicit mantissa bits
    (TF32: 10, bf16: 7), returned in f64: the operand a tensor-core dot
    at that input precision multiplies."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    u = ((u + (1 << (drop - 1))) >> drop) << drop
    return u.astype(np.uint32).view(np.float32).astype(np.float64)
