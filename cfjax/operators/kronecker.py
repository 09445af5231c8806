"""Lazy Kronecker-product operator.

Rebuild of the reference's KroneckerProducts.jl capability (used by
separable-product gramians on lazy grids, src/algebra.jl:91-95 and
src/separable.jl:29-42). The MVM is the vec-trick: reshape to the tensor
grid and contract each factor along its own axis — a chain of
matmuls, O(n * sum n_i) instead of O(n^2). Solves factor per-dimension
(dense Cholesky/eigh of each small factor)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tiles import resolve_precision
from .linop import DenseOperator, LinearOperator


@jax.jit
def _kron_matvec_einsum(mats, v):
    """(A_1 ⊗ ... ⊗ A_k) v as a chain of per-mode einsum contractions.
    Unlike moveaxis+reshape (which materializes a transposed copy of the
    whole tensor per mode), each einsum is one dot_general whose layout
    shuffling XLA folds into the matmul itself."""
    lo = "abcdefgh"
    hi = "ABCDEFGH"
    dims = [A.shape[1] for A in mats]
    X = v.reshape(dims)
    subs = list(lo[: len(mats)])
    for i, A in enumerate(mats):
        out = subs.copy()
        out[i] = hi[i]
        X = jnp.einsum(f"{hi[i]}{lo[i]},{''.join(subs)}->{''.join(out)}", A, X,
                       precision=resolve_precision())
        subs = out
    return X.reshape(-1)


def _dims(factors):
    return [f.shape for f in factors]


class KroneckerOperator(LinearOperator):
    """K = F_1 ⊗ F_2 ⊗ ... ⊗ F_d (row-major vec: last factor's axis
    fastest, matching LazyGrid.points ordering)."""

    def __init__(self, factors):
        self.factors = tuple(
            f if isinstance(f, LinearOperator) else DenseOperator(jnp.asarray(f))
            for f in factors
        )
        n = m = 1
        for f in self.factors:
            n *= f.shape[0]
            m *= f.shape[1]
        self.shape = (n, m)
        self.dtype = self.factors[0].dtype

    @property
    def is_symmetric(self):
        return all(f.is_symmetric for f in self.factors)

    @property
    def is_psd(self):
        return all(f.is_psd for f in self.factors)

    def _apply_modes(self, v, op_per_factor, in_dims=None):
        """vec-trick: contract each factor along its own tensor axis.
        op_per_factor entries are LinearOperators (kept lazy) or dense
        matrices."""
        in_dims = in_dims or [f.shape[1] for f in self.factors]
        X = v.reshape(in_dims)
        for i, A in enumerate(op_per_factor):
            X = jnp.moveaxis(X, i, -1)
            shp = X.shape
            X2 = X.reshape(-1, shp[-1])
            if isinstance(A, LinearOperator):
                Y2 = A._matmat(X2.T).T
            else:
                Y2 = X2 @ A.T
            X = jnp.moveaxis(Y2.reshape(shp[:-1] + (Y2.shape[-1],)), -1, i)
        return X.reshape(-1)

    def _dense_mats(self):
        """Cached dense factor matrices when every factor is small enough
        to materialize (m_i^2 floats — for 128^3 grids that's 64 KB per
        factor). Enables the fused einsum mode chain."""
        if not hasattr(self, "_dense_cache"):
            mats = []
            for f in self.factors:
                if isinstance(f, (jnp.ndarray, np.ndarray)):
                    mats.append(jnp.asarray(f))
                elif max(f.shape) <= 2048:
                    mats.append(f.todense())
                else:
                    mats = None
                    break
            self._dense_cache = mats
        return self._dense_cache

    def _matvec(self, v):
        mats = self._dense_mats()
        if mats is not None:
            return _kron_matvec_einsum(tuple(mats), v)
        return self._apply_modes(v, list(self.factors))

    def _matmat(self, V):
        return jax.vmap(self._matvec, in_axes=1, out_axes=1)(V)

    def todense(self):
        out = self.factors[0].todense()
        for f in self.factors[1:]:
            out = jnp.kron(out, f.todense())
        return out

    def diagonal(self):
        out = self.factors[0].diagonal()
        for f in self.factors[1:]:
            out = jnp.outer(out, f.diagonal()).reshape(-1)
        return out

    def cholesky(self):
        return KroneckerCholesky(self)

    def solve(self, b, **kw):
        from .. import config as _config
        from .solvers import cg

        if all(f.shape[0] <= _config.DEFAULT.max_cholesky_size for f in self.factors):
            return self.cholesky().solve(b)
        from .solvers import cached_jit

        f = cached_jit(self, ("cg",), lambda: (lambda bb: cg(self._matvec, bb, **kw)[0]))
        return f(b)

    def logdet(self):
        n_each = [f.shape[0] for f in self.factors]
        n_total = int(np.prod(n_each))
        out = 0.0
        for f, ni in zip(self.factors, n_each):
            A = f.todense()
            sign, ld = jnp.linalg.slogdet(A)
            out = out + (n_total // ni) * ld
        return out


from functools import partial


@partial(jax.jit, static_argnames=("fns",))
def _chol_factors(fns, arrs, jitter):
    """Materialize every factor (via its dense recipe) and Cholesky-factor
    it in ONE device dispatch instead of one eager dispatch per factor
    and primitive."""
    Ls = []
    for fn, a in zip(fns, arrs):
        A = fn(*a)
        n = A.shape[0]
        scale = jnp.mean(jnp.diagonal(A))
        Ls.append(jnp.linalg.cholesky(A + jitter * scale * jnp.eye(n, dtype=A.dtype)))
    return tuple(Ls)


@jax.jit
def _kron_chol_solve(Ls, b):
    """x = (⊗_i A_i)^{-1} b from the factor Choleskys, fully fused:
    per-factor explicit inverse + vec-trick mode contractions."""
    mats = []
    for L in Ls:
        I = jnp.eye(L.shape[0], dtype=L.dtype)
        Linv = jax.scipy.linalg.solve_triangular(L, I, lower=True)
        mats.append(Linv.T @ Linv)

    def solve1(v):
        X = v.reshape([m.shape[0] for m in mats])
        for i, A in enumerate(mats):
            X = jnp.moveaxis(X, i, -1)
            shp = X.shape
            Y2 = X.reshape(-1, shp[-1]) @ A  # A symmetric: A.T == A
            X = jnp.moveaxis(Y2.reshape(shp), -1, i)
        return X.reshape(-1)

    if b.ndim == 1:
        return solve1(b)
    return jax.vmap(solve1, in_axes=1, out_axes=1)(b)


class KroneckerCholesky:
    """Per-factor Cholesky of a Kronecker operator (reference
    `cholesky(G::KroneckerProduct)` demo, README.md:194-198): factorizing
    d small n_i x n_i matrices instead of one prod(n_i)^2 matrix."""

    def __init__(self, K: KroneckerOperator, jitter: float = 1e-10):
        self.K = K
        fns, arrs = zip(*(f._dense_recipe() for f in K.factors))
        self.Ls = list(_chol_factors(tuple(fns), tuple(arrs), jitter))
        self.shape = K.shape

    def solve(self, b):
        return _kron_chol_solve(tuple(self.Ls), jnp.asarray(b))

    def logdet(self):
        n_each = [L.shape[0] for L in self.Ls]
        n_total = int(np.prod(n_each))
        out = 0.0
        for L, ni in zip(self.Ls, n_each):
            out = out + (n_total // ni) * 2 * jnp.sum(jnp.log(jnp.diagonal(L)))
        return out
