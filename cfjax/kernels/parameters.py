"""Hyperparameter plumbing.

JAX rebuild of reference src/parameters.jl (`parameters`,
`nparameters`, `Base.similar`): kernels are pytrees, so the flat
hyperparameter vector is just the concatenated leaves and reconstruction
is `tree_unflatten` — no `@functor` annotations or stripped-type
machinery needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def parameters(k) -> jnp.ndarray:
    """Flat vector of all hyperparameters of kernel (pytree) k."""
    leaves = jax.tree_util.tree_leaves(k)
    if not leaves:
        return jnp.zeros((0,))
    return jnp.concatenate([jnp.ravel(jnp.asarray(l)) for l in leaves])


def nparameters(k) -> int:
    return int(sum(np.size(l) for l in jax.tree_util.tree_leaves(k)))


def similar(k, theta):
    """Rebuild a kernel of the same structure from a flat parameter vector
    (reference `Base.similar(k, θ)`, src/parameters.jl:21-37)."""
    leaves, treedef = jax.tree_util.tree_flatten(k)
    theta = jnp.asarray(theta)
    if theta.size != sum(np.size(l) for l in leaves):
        raise ValueError(
            f"parameter vector has {theta.size} entries, kernel needs "
            f"{sum(np.size(l) for l in leaves)}"
        )
    new_leaves = []
    i = 0
    for l in leaves:
        n = int(np.size(l))
        chunk = theta[i : i + n].reshape(jnp.shape(l))
        if jnp.ndim(l) == 0 and not isinstance(l, jnp.ndarray):
            chunk = chunk.reshape(())
        new_leaves.append(chunk)
        i += n
    return jax.tree_util.tree_unflatten(treedef, new_leaves)
