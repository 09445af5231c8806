"""The smart `gramian()` constructor: automatic structure detection.

Rebuild of the reference's central dispatch (src/gramian.jl:144-189 plus
the per-kernel gramian specializations in stationary.jl/mercer.jl/
algebra.jl/transformation.jl). Julia does this with multiple dispatch on
types; here it is one explicit decision tree over (kernel metadata,
input-container type), run once at operator construction — so every
returned operator's matvec is shape/structure-static and jit-compiles
once (SURVEY.md §7 design stance).

Decision order (mirroring src/gramian.jl:144-163 and SURVEY.md §3.1):
  1. matrix-valued kernels          -> block operators (derivative layer)
  2. Constant                       -> lazy Fill (rank-1)
  3. FiniteBasis with n > rank      -> low-rank U V^T
  4. SeparableProduct on LazyGrid   -> Kronecker of per-axis gramians
  5. input-transforms (ARD/Energetic/Warped/ScaledInput/Periodic)
                                    -> pre-transform points once, recurse
  6. VerticalRescaling              -> D G D lazy product
  7. Sum with Delta terms (x is y)  -> diagonal split + recurse
  8. uniform 1-D grid + stationary  -> SymmetricToeplitz / Toeplitz;
     periodic kernel on grid        -> Circulant
  9. fallback                       -> lazy Gramian (blocked XLA or fused Triton MVM)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config as _config
from ..kernels.algebra import Product, SeparableProduct, SeparableSum, Sum
from ..kernels.base import InputTrait, Kernel, MultiKernel, input_trait, kernel_pytree
from ..kernels.mercer import FiniteBasis
from ..kernels.stationary import Constant, Delta
from ..kernels.transforms import (
    ARDKernel,
    Energetic,
    Periodic,
    ScaledInputKernel,
    VerticalRescaling,
    Warped,
)
from ..utils.grids import LazyGrid, UniformGrid, as_points, detect_uniform_grid
from .gramian import Gramian
from .kronecker import KroneckerOperator
from .linop import (
    DiagonalOperator,
    FillOperator,
    LowRankOperator,
    ProductOperator,
    SumOperator,
)
from .toeplitz import CirculantOperator, ToeplitzOperator


@kernel_pytree(static=("fn",))
class LambdaKernel(Kernel):
    """Wrap a plain callable as a GENERIC-trait kernel — the analogue of
    the reference tests' closure-wrapping trick that erases structure so
    the dense fallback is exercised (test/gradient.jl:38-45)."""

    fn: object = None

    def __call__(self, x, y):
        return self.fn(x, y)


def _as_kernel(k):
    if isinstance(k, (Kernel, MultiKernel)):
        return k
    if callable(k):
        return LambdaKernel(k)
    raise TypeError(f"not a kernel: {k!r}")


def _delta_amplitude(k):
    """If k is Delta or Constant*...*Delta, return its scalar amplitude
    (for the exact white-noise diagonal split); else None."""
    if isinstance(k, Delta):
        return jnp.asarray(1.0)
    if isinstance(k, Product):
        amp = jnp.asarray(1.0)
        seen_delta = False
        for a in k.args:
            if isinstance(a, Delta):
                if seen_delta:
                    return None
                seen_delta = True
            elif isinstance(a, Constant):
                amp = amp * a.c
            else:
                return None
        return amp if seen_delta else None
    return None


def gramian(k, x, y=None, **opts):
    """Build the structure-detected covariance operator K with
    K[i, j] = k(x_i, y_j) (reference `gramian`, src/gramian.jl:144-163)."""
    k = _as_kernel(k)
    same = y is None

    # 1. matrix-valued (derivative / separable multi-output) kernels
    if isinstance(k, MultiKernel):
        from ..derivative.dispatch import gramian_multikernel

        return gramian_multikernel(k, x, y, **opts)

    # 2. constant kernel -> lazy fill (src/stationary.jl:34)
    if isinstance(k, Constant):
        xp, yp = as_points(x), as_points(x) if same else as_points(y)
        return FillOperator(jnp.asarray(k.c), (xp.shape[0], yp.shape[0]))

    # 2b. discrete-input matrix kernel: K = A[ix][:, iy]
    from ..kernels.mercer import MatrixKernel

    if isinstance(k, MatrixKernel):
        import numpy as _np

        ix = jnp.asarray(_np.asarray(x).reshape(-1), dtype=jnp.int32)
        iy = ix if same else jnp.asarray(_np.asarray(y).reshape(-1), dtype=jnp.int32)
        A = jnp.asarray(k.A)
        from .linop import DenseOperator

        return DenseOperator(A[ix][:, iy], symmetric=same)

    # 3. finite basis -> low-rank (src/mercer.jl:61-70)
    if isinstance(k, FiniteBasis):
        xp = as_points(x)
        yp = xp if same else as_points(y)
        r = k.rank
        if xp.shape[0] > r and yp.shape[0] > r:
            U = jax.vmap(k.features)(xp)
            V = U if same else jax.vmap(k.features)(yp)
            return LowRankOperator(U, V.T, psd=same)
        return Gramian(k, xp, None if same else yp, **opts)

    # 4. separable product on a lazy grid -> Kronecker (src/algebra.jl:91-95)
    if isinstance(k, SeparableProduct) and isinstance(x, LazyGrid):
        ygrid = x if same else y
        if not isinstance(ygrid, LazyGrid) or len(ygrid.axes) != len(x.axes):
            raise ValueError("SeparableProduct gramian needs LazyGrid for both inputs")
        if len(k.args) != len(x.axes):
            raise ValueError(
                f"SeparableProduct needs {len(x.axes)} kernels, has {len(k.args)}"
            )
        factors = [
            gramian(
                ki,
                x.axes[i],
                None if same else ygrid.axes[i],
                **opts,
            )
            for i, ki in enumerate(k.args)
        ]
        return KroneckerOperator(factors)

    # 5. input transforms -> pre-transform points once, recurse
    #    (src/transformation.jl:83-95, 113-121; ARD/Energetic/Periodic are
    #    reductions to the isotropic matmul path)
    if isinstance(k, ARDKernel):
        l = jnp.asarray(k.l)
        xp = as_points(x) / l
        yp = None if same else as_points(y) / l
        return gramian(k.k, xp, yp, **opts)
    if isinstance(k, Energetic):
        A = jnp.asarray(k.A)
        L = jnp.linalg.cholesky(A)
        xp = as_points(x) @ L
        yp = None if same else as_points(y) @ L
        return gramian(k.k, xp, yp, **opts)
    if isinstance(k, ScaledInputKernel):
        U = jnp.asarray(k.U)
        xp = as_points(x) @ U.T
        yp = None if same else as_points(y) @ U.T
        return gramian(k.k, xp, yp, **opts)
    if isinstance(k, Warped):
        xp = jax.vmap(k.u)(as_points(x))
        xp = xp[:, None] if xp.ndim == 1 else xp
        if same:
            yp = None
        else:
            yp = jax.vmap(k.u)(as_points(y))
            yp = yp[:, None] if yp.ndim == 1 else yp
        return gramian(k.k, xp, yp, **opts)
    if isinstance(k, Periodic):
        # circulant fast path on uniform grids handled below; otherwise
        # embed x -> (cos 2 pi x, sin 2 pi x): the MacKay warp becomes the
        # plain isotropic distance in the embedded space
        grid = _uniform_grid_of(x)
        if grid is not None and same:
            span = grid.step * grid.num
            if np.isclose(span, round(span)) and round(span) >= 1:
                g_ = grid
                return CirculantOperator(
                    lambda: _grid_col(k, g_.start, g_.step, g_.start, g_.num),
                    num=grid.num)
        xp = as_points(x)
        emb = jnp.concatenate(
            [jnp.cos(2 * jnp.pi * xp), jnp.sin(2 * jnp.pi * xp)], axis=1
        )
        if same:
            ypemb = None
        else:
            ypt = as_points(y)
            ypemb = jnp.concatenate(
                [jnp.cos(2 * jnp.pi * ypt), jnp.sin(2 * jnp.pi * ypt)], axis=1
            )
        return gramian(_EmbeddedPeriodic(k.k), emb, ypemb, **opts)

    # 6. vertical rescaling -> lazy D G D (src/transformation.jl:165-171)
    if isinstance(k, VerticalRescaling):
        xp = as_points(x)
        yp = xp if same else as_points(y)
        Dx = DiagonalOperator(jax.vmap(k.f)(xp))
        Dy = Dx if same else DiagonalOperator(jax.vmap(k.f)(yp))
        G = gramian(k.k, x, None if same else y, **opts)
        return ProductOperator((Dx, G, Dy))

    # 7. exact white-noise split: Sum with Delta terms on shared points
    if same and isinstance(k, Sum):
        deltas, rest = [], []
        for a in k.args:
            amp = _delta_amplitude(a)
            (deltas if amp is not None else rest).append((a, amp))
        if deltas:
            xp = as_points(x)
            n = xp.shape[0]
            amp = sum(a for _, a in deltas)
            diag = DiagonalOperator(jnp.full((n,), amp))
            if not rest:
                return diag
            rk = rest[0][0] if len(rest) == 1 else Sum(tuple(a for a, _ in rest))
            return SumOperator((gramian(rk, x, **opts), diag))
    if same and isinstance(k, Delta):
        xp = as_points(x)
        return DiagonalOperator(jnp.ones((xp.shape[0],)))

    # 8. uniform 1-D grid + stationary kernel -> Toeplitz (src/gramian.jl:167-183)
    trait = input_trait(k)
    gx = _uniform_grid_of(x)
    if gx is not None and trait in (
        InputTrait.ISOTROPIC,
        InputTrait.STATIONARY,
        InputTrait.STATIONARY_LINEAR_FUNCTIONAL,
    ):
        if same:
            # lazy column: construction is O(1) host work (the reference's
            # Kronecker of grid gramians constructs in 23 us because no
            # kernel is evaluated until use, src/algebra.jl:91-95)
            return ToeplitzOperator(
                lambda: _grid_col(k, gx.start, gx.step, gx.start, gx.num),
                num=gx.num)
        gy = _uniform_grid_of(y)
        if gy is not None and np.isclose(gx.step, gy.step) and gx.num == gy.num:
            return ToeplitzOperator(
                lambda: _grid_col(k, gy.start, gx.step, gx.start, gx.num),
                lambda: _grid_col(k, gx.start, gy.step, gy.start, gy.num),
                num=gx.num)

    # 9. fallback: lazy blocked Gramian (XLA or the fused Triton MVM)
    return Gramian(k, x, None if same else y, **opts)


@kernel_pytree
class _EmbeddedPeriodic(Kernel):
    """Isotropic view of a MacKay-periodic kernel on cos/sin-embedded
    points: |z_x - z_y|^2 = sum_i 4 sin^2(pi tau_i) is exactly the MacKay
    warped squared distance, so profile(s) = k.profile(s)."""

    k: Kernel = None

    @property
    def trait(self):
        return InputTrait.ISOTROPIC

    def profile(self, s):
        return self.k.profile(s)

    def profile_value(self, s):
        return self.k.profile_value(s)


def _uniform_grid_of(x):
    if isinstance(x, UniformGrid):
        return x
    if isinstance(x, LazyGrid):
        return None
    arr = np.asarray(x)
    if arr.ndim == 1 or (arr.ndim == 2 and arr.shape[1] == 1):
        return detect_uniform_grid(arr)
    return None


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("num",))
def _grid_col(k, x0, step, start, num):
    """First column k(x0, start + step*j) of a grid Gramian, evaluated in
    ONE device dispatch (eager vmap dispatches once per primitive)."""
    pts = start + step * jnp.arange(num, dtype=jnp.result_type(float))
    return jax.vmap(lambda xj: k(x0, xj))(pts)


def explain(k, x, y=None, **opts) -> str:
    """Describe the structure the dispatcher detected (the reference
    communicates this only through Julia return types; SURVEY.md §5 asks
    for explicit dispatch logging)."""
    op = gramian(k, x, y, **opts)
    parts = [f"{type(op).__name__}{op.shape}"]
    if isinstance(op, Gramian):
        parts.append(f"mvm mode = {op.mode}, block = {op.block}")
        from ..ops.pallas_mvm import pallas_decline_reason

        why = pallas_decline_reason(op)
        parts.append("fused Triton MVM" if why is None
                     else f"XLA MVM ({why})")
    if isinstance(op, KroneckerOperator):
        parts.append(
            "factors: " + " ⊗ ".join(f"{type(f).__name__}{f.shape}" for f in op.factors)
        )
    if isinstance(op, SumOperator):
        parts.append(
            "terms: " + " + ".join(type(t).__name__ for t in op.terms)
        )
    if isinstance(op, ProductOperator):
        parts.append(
            "factors: " + " @ ".join(type(f).__name__ for f in op.factors)
        )
    return " | ".join(parts)
