"""Kernel input/output transformations.

JAX rebuild of reference src/transformation.jl: lengthscales, ARD,
custom norms, periodic (MacKay) warping, linear input scaling, generic
warping, symmetrization, scalar chaining and vertical rescaling.
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import (
    InputTrait,
    IsotropicKernel,
    Kernel,
    check,
    input_trait,
    kernel_pytree,
)


@kernel_pytree
class Lengthscale(IsotropicKernel):
    """k(r^2 / l^2) (reference src/transformation.jl:6-19)."""

    k: Kernel = None
    l: float = 1.0

    def __post_init__(self):
        check(lambda v: (v > 0).all(), self.l, "lengthscale must be positive")

    def profile(self, s):
        l = jnp.asarray(self.l)
        return self.k.profile(s / (l * l))

    def profile_value(self, s):
        l = jnp.asarray(self.l)
        return self.k.profile_value(s / (l * l))

    @property
    def is_mercer(self) -> bool:
        # input rescaling preserves PSD (reference: Lengthscale <: IsotropicKernel)
        return getattr(self.k, "is_mercer", False)


@kernel_pytree(static=("n2",))
class Normed(Kernel):
    """Stationary kernel with a custom squared norm on tau = x - y
    (src/transformation.jl:25-39). `n2` is a static callable tau -> scalar."""

    k: Kernel = None
    n2: object = None

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        return self.k.profile(self.n2(jnp.asarray(tau)))

    @property
    def is_mercer(self) -> bool:
        # PSD iff n2 is a genuine squared norm (reference Normed <: StationaryKernel)
        return getattr(self.k, "is_mercer", False)

    def __call__(self, x, y):
        return self.tau_call(jnp.asarray(x) - jnp.asarray(y))


@kernel_pytree
class ARDKernel(Kernel):
    """Automatic relevance determination: per-dimension lengthscales l
    (src/transformation.jl:42-46). l is a trainable pytree leaf (unlike a
    Normed closure, which would bake l in as a constant)."""

    k: Kernel = None
    l: jnp.ndarray = None

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        t = jnp.asarray(tau) / jnp.asarray(self.l)
        return self.k.profile(jnp.sum(t * t))

    @property
    def is_mercer(self) -> bool:
        # per-dim rescaling preserves PSD
        return getattr(self.k, "is_mercer", False)

    def __call__(self, x, y):
        return self.tau_call(jnp.asarray(x) - jnp.asarray(y))


def ARD(k, l):
    """ARD(k, vector l) or Lengthscale(k, scalar l) (src/transformation.jl:42-46)."""
    arr = jnp.asarray(l)
    if arr.ndim == 0:
        return Lengthscale(k, l)
    return ARDKernel(k, arr)


@kernel_pytree
class Energetic(Kernel):
    """Energetic norm kernel: k(tau' A tau) (src/transformation.jl:47-50)."""

    k: Kernel = None
    A: jnp.ndarray = None

    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY

    def tau_call(self, tau):
        t = jnp.atleast_1d(jnp.asarray(tau))
        return self.k.profile(t @ (jnp.asarray(self.A) @ t))

    @property
    def is_mercer(self) -> bool:
        # PSD assuming A is PSD (energetic norm)
        return getattr(self.k, "is_mercer", False)

    def __call__(self, x, y):
        return self.tau_call(jnp.asarray(x) - jnp.asarray(y))


@kernel_pytree
class Periodic(Kernel):
    """MacKay periodic warp of an isotropic kernel
    (src/transformation.jl:54-64): per coordinate,
    tau^2 -> (2 sin(pi tau))^2 (1-periodic). Carries the PERIODIC trait
    so uniform-grid gramians dispatch to the circulant fast path."""

    k: Kernel = None

    @property
    def trait(self) -> InputTrait:
        return InputTrait.PERIODIC

    def warped_sqdist(self, tau):
        t = jnp.atleast_1d(jnp.asarray(tau))
        return jnp.sum(jnp.square(2 * jnp.sin(jnp.pi * t)))

    def tau_call(self, tau):
        return self.k.profile(self.warped_sqdist(tau))

    @property
    def is_mercer(self) -> bool:
        # MacKay warp = input map u(x); PSD preserved
        return getattr(self.k, "is_mercer", False)

    def __call__(self, x, y):
        return self.tau_call(jnp.asarray(x) - jnp.asarray(y))


@kernel_pytree
class ScaledInputKernel(Kernel):
    """k(U x, U y) (src/transformation.jl:71-95). When U is square and
    non-diagonal the dispatcher pre-transforms the points once
    (O(n d^2) + O(n^2 d) instead of O(n^2 d^2))."""

    k: Kernel = None
    U: jnp.ndarray = None

    @property
    def trait(self) -> InputTrait:
        return InputTrait.GENERIC

    def __call__(self, x, y):
        U = jnp.asarray(self.U)
        return self.k(U @ jnp.atleast_1d(jnp.asarray(x)), U @ jnp.atleast_1d(jnp.asarray(y)))

    @property
    def is_mercer(self) -> bool:
        # k(Ux, Uy) is PSD when k is (provable; stronger than reference's false)
        return getattr(self.k, "is_mercer", False)


@kernel_pytree(static=("u",))
class Warped(Kernel):
    """k(u(x), u(y)) for a static callable u (src/transformation.jl:98-121).
    The dispatcher pre-maps the points through u once."""

    k: Kernel = None
    u: object = None

    def __call__(self, x, y):
        return self.k(self.u(jnp.asarray(x)), self.u(jnp.asarray(y)))

    @property
    def is_mercer(self) -> bool:
        # k(u(x), u(y)) is PSD when k is (provable; stronger than reference's false)
        return getattr(self.k, "is_mercer", False)


@kernel_pytree
class SymmetricKernel(Kernel):
    """Symmetrized kernel about center z (1-D axis symmetry,
    src/transformation.jl:126-137)."""

    k: Kernel = None
    z: float = 0.0

    def __call__(self, x, y):
        x = jnp.asarray(x) - self.z
        y = jnp.asarray(y) - self.z
        return (self.k(x, y) + self.k(-x, y)) / 2


@kernel_pytree(static=("f",))
class Chained(Kernel):
    """f(k(x, y)) for a static scalar function f (src/transformation.jl:141-150).
    Preserves the input trait of k — under JAX the chained profile stays
    closed-form differentiable, so trait fast paths keep working."""

    f: object = None
    k: Kernel = None

    @property
    def trait(self) -> InputTrait:
        return input_trait(self.k)

    # is_mercer stays False: f(k) is generally NOT PSD (reference
    # Chained <: AbstractKernel, ismercer = false)

    def profile(self, s):
        return self.f(self.k.profile(s))

    def profile_value(self, s):
        return self.f(self.k.profile_value(s))

    def tau_call(self, tau):
        return self.f(self.k.tau_call(tau))

    def __call__(self, x, y):
        return self.f(self.k(x, y))


@kernel_pytree(static=("f",))
class VerticalRescaling(Kernel):
    """f(x) k(x, y) f(y) (src/transformation.jl:156-171). The dispatcher
    builds the lazy D_f G D_f product operator."""

    k: Kernel = None
    f: object = None

    def __call__(self, x, y):
        return self.f(jnp.asarray(x)) * self.k(x, y) * self.f(jnp.asarray(y))

    @property
    def is_mercer(self) -> bool:
        # v^T D K D v = (Dv)^T K (Dv) >= 0: PSD when k is
        return getattr(self.k, "is_mercer", False)


def normalize(k: Kernel) -> Kernel:
    """Rescale so k(x, x) = 1 (src/transformation.jl:174)."""
    return VerticalRescaling(k, lambda x: 1.0 / jnp.sqrt(k(x, x)))
