"""Lazy Gramian operator: O(1)-memory kernel matrix with blocked,
trait-specialized MVMs.

JAX rebuild of the reference's Gramian core (src/gramian.jl). The
reference's hot loop is a threaded+SIMD per-element loop
(src/gramian.jl:78-99); here row-blocks of the kernel matrix are produced
as `profile(distance-tile)`, where the distance tile is the exact
difference form at small d and one matmul (||x||^2 + ||y||^2 - 2 X Y^T)
above it, the scalar profile is fused elementwise by XLA, and the tile is
immediately contracted against the vector. Memory stays O(block * m);
`lax.map` over row blocks keeps the compiled graph static.

On the GPU, single-RHS MVMs on the matmul path at the TF32 precision
tiers (16 < d <= 512) go to a fused Triton kernel (cfjax.ops.pallas_mvm)
that keeps each distance tile on chip.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .. import config as _config
from ..kernels.base import InputTrait, Kernel, input_trait
from .linop import LinearOperator


def _cdiv(a, b):
    return -(-a // b)


def _pad_rows(x, block):
    n = x.shape[0]
    nb = _cdiv(n, block)
    pad = nb * block - n
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.reshape(nb, block, x.shape[1])


def slf_vector(k):
    """Extract the linear-functional direction c from an SLF-trait kernel
    (Cosine possibly wrapped in Constant products/sums/powers)."""
    from ..kernels.stationary import Constant, Cosine
    from ..kernels.algebra import Power, Product, Sum
    from ..kernels.transforms import Chained

    if isinstance(k, Cosine):
        return jnp.atleast_1d(jnp.asarray(k.c))
    if isinstance(k, (Sum, Product)):
        for a in k.args:
            if not isinstance(a, Constant):
                return slf_vector(a)
    if isinstance(k, Power):
        return slf_vector(k.k)
    if isinstance(k, Chained):
        return slf_vector(k.k)
    raise ValueError(f"cannot extract linear functional from {type(k).__name__}")


def kernel_tile(k, xb, y, mode: str, c=None):
    """Evaluate a (B, m) kernel-matrix tile for row-block xb against all y.

    The trait-specialized modes route all O(B m d) work through a matmul:
      iso : profile(||x||^2 + ||y||^2 - 2 x.y)
      dot : profile(x.y)
      slf : profile(<c, x> - <c, y>)
    and only GENERIC kernels pay the per-pair vmap fallback (the analogue
    of the reference's getindex loop, src/gramian.jl:37-52)."""
    from ..ops.tiles import inner_tile, sqdist_tile

    if mode == "iso":
        return k.profile_value(sqdist_tile(xb, y))
    if mode == "dot":
        return k.profile_value(inner_tile(xb, y))
    if mode == "slf":
        t = (xb @ c)[:, None] - (y @ c)[None, :]
        return k.profile_value(t)
    # generic per-pair evaluation
    return jax.vmap(lambda xi: jax.vmap(lambda yj: k(xi, yj))(y))(xb)


@partial(jax.jit, static_argnames=("mode", "block"))
def gramian_matvec(k, x, y, a, mode: str = "iso", block: int = 512):
    """b = K a for the lazy Gramian, K_ij = k(x_i, y_j). a: (m,) or (m, r)."""
    n = x.shape[0]
    c = slf_vector(k) if mode == "slf" else None
    xb = _pad_rows(x, block)
    from ..ops.tiles import matmul_p

    def body(xblk):
        K = kernel_tile(k, xblk, y, mode, c)
        # single RHS: elementwise multiply + row reduction, exact f32. A
        # matrix-vector product at reduced input precision (bf16 or TF32)
        # would truncate kernel ENTRIES to ~3 digits — a ~1e-3 matvec
        # error that stalls PCG at GP noise levels.
        if a.ndim == 1:
            return jnp.sum(K * a[None, :], axis=1)
        # matrix RHS: matmul at the configured precision
        return matmul_p(K, a)

    # checkpoint PER BLOCK: under reverse AD (the Hutchinson/quadform
    # VJPs differentiate this MVM in the kernel params), lax.map's
    # transpose otherwise saves each step's kernel-tile intermediates —
    # O(n m) residual memory that OOMs at n = 2^18 (measured r5). With
    # remat the residual per step is just the (block, d) points; tiles
    # recompute during the backward sweep. Forward cost unchanged.
    out = lax.map(jax.checkpoint(body), xb)
    return out.reshape((-1,) + a.shape[1:])[:n]


@partial(jax.jit, static_argnames=("mode", "block"))
def gramian_dense(k, x, y, mode: str = "iso", block: int = 512):
    """Materialize the full kernel matrix blockwise (reference `Matrix!`,
    src/gramian.jl:102-114)."""
    n = x.shape[0]
    c = slf_vector(k) if mode == "slf" else None
    xb = _pad_rows(x, block)
    out = lax.map(lambda xblk: kernel_tile(k, xblk, y, mode, c), xb)
    return out.reshape(-1, y.shape[0])[:n]


def _contains_matern_nu(k) -> bool:
    from ..kernels.stationary import Matern
    from ..kernels.algebra import Power, Product, Sum
    from ..kernels.transforms import Chained, Lengthscale

    if isinstance(k, Matern):
        return True
    if isinstance(k, (Sum, Product)):
        return any(_contains_matern_nu(a) for a in k.args)
    if isinstance(k, (Power, Chained, Lengthscale)):
        return _contains_matern_nu(k.k)
    return False


def mvm_mode(k) -> str:
    t = input_trait(k)
    if t == InputTrait.ISOTROPIC:
        return "iso"
    if t == InputTrait.DOT:
        return "dot"
    if t == InputTrait.STATIONARY_LINEAR_FUNCTIONAL:
        try:
            slf_vector(k)
            return "slf"
        except ValueError:
            return "generic"
    return "generic"


class Gramian(LinearOperator):
    """Lazy kernel matrix K_ij = k(x_i, y_j) (reference Gramian,
    src/gramian.jl:10-21). O(n d) storage; matvec/dense are blocked jitted
    kernels chosen by input trait at construction."""

    def __init__(self, k: Kernel, x, y=None, block: int = None):
        from ..utils.grids import as_points

        self.k = k
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None or (self.x is self.y)
        self.shape = (self.x.shape[0], self.y.shape[0])
        self.dtype = jnp.result_type(self.x.dtype, float)
        self.mode = mvm_mode(k)
        # real-nu Matern profiles expand every tile element by the Bessel
        # quadrature's node count
        self.has_quadrature_profile = _contains_matern_nu(k)
        if block is None:
            block = _config.DEFAULT.mvm_block_rows if self.mode != "generic" else 128
            if self.has_quadrature_profile:
                block = min(block, 32)
        self.block = min(block, self.shape[0])

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and self.k.is_mercer

    def _matvec(self, v):
        from ..ops.pallas_mvm import pallas_decline_reason

        if v.ndim == 1 and pallas_decline_reason(self) is None:
            from ..ops.pallas_mvm import pallas_gramian_matvec

            return pallas_gramian_matvec(self.k, self.x, self.y, v, self.mode)
        return gramian_matvec(self.k, self.x, self.y, v, self.mode, self.block)

    def _matmat(self, V):
        # multi-RHS stays on the XLA path: it reuses each kernel tile
        # across all columns, which the single-RHS fused kernel cannot.
        return gramian_matvec(self.k, self.x, self.y, V, self.mode, self.block)

    def _rmatvec(self, v):
        if self._same:
            return self._matvec(v)
        return gramian_matvec(self.k, self.y, self.x, v, self.mode, self.block)

    def todense(self):
        return gramian_dense(self.k, self.x, self.y, self.mode, self.block)

    def diagonal(self):
        if self.mode == "iso":
            z = jnp.zeros((min(self.shape),))
            return self.k.profile_value(z)
        n = min(self.shape)
        return jax.vmap(lambda xi, yi: self.k(xi, yi))(self.x[:n], self.y[:n])
