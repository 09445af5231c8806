"""Non-stationary (Mercer) kernels.

JAX rebuild of reference src/mercer.jl: dot-product kernels,
Brownian motion, finite-basis (low-rank) kernels and the MacKay arcsine
neural-network kernel.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import DotProductKernel, Kernel, kernel_pytree


@kernel_pytree
class Dot(DotProductKernel):
    """k(x, y) = <x, y> (reference src/mercer.jl:6-9)."""

    def profile(self, s):
        return jnp.asarray(s)


@kernel_pytree
class ExponentialDot(DotProductKernel):
    """k(x, y) = exp(<x, y>) (src/mercer.jl:19-22)."""

    def profile(self, s):
        return jnp.exp(s)


def Line(sigma=0.0) -> Kernel:
    """Dot + sigma (src/mercer.jl:12)."""
    return Dot() + sigma


def Polynomial(d: int, sigma=0.0) -> Kernel:
    """(Dot + sigma)^d (src/mercer.jl:13-14)."""
    return Line(sigma) ** d


Poly = Polynomial


@kernel_pytree
class Brownian(Kernel):
    """k(x, y) = min(x, y) for scalar inputs (src/mercer.jl:33-37)."""

    @property
    def is_mercer(self) -> bool:
        # reference src/mercer.jl: <: MercerKernel
        return True

    def __call__(self, x, y):
        return jnp.minimum(jnp.squeeze(jnp.asarray(x)), jnp.squeeze(jnp.asarray(y)))


@kernel_pytree(static=("A_shape",))
class MatrixKernel(Kernel):
    """Discrete-input kernel k(i, j) = A[i, j] (src/mercer.jl:26-30)."""

    A: jnp.ndarray = None
    A_shape: tuple = None

    @property
    def is_mercer(self) -> bool:
        # reference src/mercer.jl: <: MercerKernel
        return True

    def __call__(self, i, j):
        i = jnp.asarray(i, dtype=jnp.int32).reshape(())
        j = jnp.asarray(j, dtype=jnp.int32).reshape(())
        return self.A[i, j]


@kernel_pytree(static=("basis",))
class FiniteBasis(Kernel):
    """Finite-basis (linear regression) kernel, k(x,y) = sum_b b(x) b(y)
    (src/mercer.jl:41-70). `basis` is a static tuple of callables; when
    n > len(basis) the dispatcher builds the low-rank U V^T gramian."""

    basis: tuple = ()

    def __post_init__(self):
        if len(self.basis) < 1:
            raise ValueError("basis is empty")

    @property
    def is_mercer(self) -> bool:
        # feature-map kernel <f(x), f(y)> is PSD by construction
        return True

    @property
    def rank(self) -> int:
        return len(self.basis)

    def features(self, x):
        """Feature vector [b_1(x), ..., b_r(x)] for one point."""
        return jnp.stack([jnp.asarray(b(x)).reshape(()) for b in self.basis])

    def __call__(self, x, y):
        fx = self.features(x)
        fy = self.features(y)
        return jnp.sum(fx * fy)


@kernel_pytree
class NeuralNetwork(Kernel):
    """MacKay's arcsine neural-network kernel (src/mercer.jl:73-85):
        k(x,y) = 2/pi * asin( l(x,y) / sqrt((1 + l(x,x)) (1 + l(y,y))) )
    with l(x,y) = <x, y> + sigma."""

    sigma: float = 0.0

    @property
    def is_mercer(self) -> bool:
        # reference src/mercer.jl: <: MercerKernel
        return True

    def __call__(self, x, y):
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        s = jnp.asarray(self.sigma)
        lxy = jnp.sum(x * y) + s
        lxx = jnp.sum(x * x) + s
        lyy = jnp.sum(y * y) + s
        return 2 / jnp.pi * jnp.arcsin(lxy / jnp.sqrt((1 + lxx) * (1 + lyy)))


NN = NeuralNetwork
