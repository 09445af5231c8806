"""Small linear-algebra utilities mirroring reference src/util.jl and
src/givens.jl capabilities in JAX form."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def perfect_shuffle_indices(d: int, m: int = None) -> np.ndarray:
    """Permutation p with vec(X)[p] == vec(X^T) for X (d, m) row-major —
    the reference's lazy PerfectShuffle S vec(X) = vec(X') (src/util.jl:155-192)
    as an index vector (a gather, no matrix ever built)."""
    m = d if m is None else m
    idx = np.arange(d * m).reshape(d, m)
    return idx.T.reshape(-1).copy()


def perfect_shuffle(v, d: int, m: int = None):
    """Apply the perfect shuffle to a flat vector: returns vec(X^T)."""
    m = d if m is None else m
    return jnp.asarray(v).reshape(d, m).T.reshape(-1)


def exchange_matrix(n: int):
    """Anti-diagonal exchange matrix J (src/util.jl:195-201). Prefer
    jnp.flip over multiplying by this."""
    return jnp.eye(n)[::-1]


def leave_one_out_products(x):
    """p_i = prod_{j != i} x_j without division (src/util.jl:209-221):
    exclusive prefix * exclusive suffix cumulative products."""
    x = jnp.asarray(x)
    ones = jnp.ones_like(x[:1])
    prefix = jnp.concatenate([ones, jnp.cumprod(x)[:-1]])
    suffix = jnp.concatenate([jnp.cumprod(x[::-1])[:-1][::-1], ones])
    return prefix * suffix


def givens_rotation(f, g):
    """Differentiable Givens rotation: (c, s, r) with [c s; -s c] [f; g] =
    [r; 0]. The reference patches LinearAlgebra.givensAlgorithm for
    ForwardDiff duals (src/givens.jl:1-67); under JAX the smooth branch
    formulas below differentiate out of the box."""
    f = jnp.asarray(f)
    g = jnp.asarray(g)
    r = jnp.hypot(f, g)
    safe = jnp.where(r > 0, r, 1.0)
    c = jnp.where(r > 0, f / safe, 1.0)
    s = jnp.where(r > 0, g / safe, 0.0)
    return c, s, r


def nth_derivatives(f, x, m: int):
    """All derivatives of scalar f at x up to order m (reference
    `derivatives`, src/derivatives.jl:9-29, which uses TaylorSeries):
    repeated jax.grad, returning (f(x), f'(x), ..., f^(m)(x))."""
    fns = [f]
    for _ in range(m):
        fns.append(jax.grad(fns[-1]))
    x = jnp.asarray(x, dtype=jnp.result_type(float))
    return tuple(fn(x) for fn in fns)


def jet_derivatives(f, x, m: int):
    """Same via jax.experimental.jet Taylor propagation (one pass, better
    for large m than nested grad)."""
    from jax.experimental.jet import jet

    x = jnp.asarray(x, dtype=jnp.result_type(float))
    series = [jnp.ones_like(x)] + [jnp.zeros_like(x)] * (m - 1)
    f0, coeffs = jet(f, (x,), ((*series,),))
    # with input series (1, 0, ...), jax's jet terms are the (unnormalized)
    # derivatives f^(k)(x) directly
    return (f0, *coeffs[:m])
