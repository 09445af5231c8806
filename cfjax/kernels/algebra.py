"""Kernel algebra: sums, products, powers, separable combinations.

JAX rebuild of reference src/algebra.jl. Combined input traits are
propagated exactly as the reference's `sum_and_product_input_trait`
(src/properties.jl:47-63): Constants are trait-transparent, heterogeneous
traits collapse to GENERIC.

A major simplification vs the reference: because JAX differentiates the
*combined* scalar profile directly, a Sum/Product/Power of isotropic
kernels is itself an isotropic profile — so the derivative-kernel layer
gets closed-form fast paths for composites for free, without the
hand-derived per-combinator rules of src/gradient_algebra.jl (those are
still used for heterogeneous-trait composites).
"""

from __future__ import annotations

import jax.numpy as jnp

from .base import InputTrait, Kernel, input_trait, kernel_pytree


def _combined(args) -> InputTrait:
    from .stationary import Constant, Cosine

    non_const = [k for k in args if not isinstance(k, Constant)]
    if not non_const:
        return InputTrait.ISOTROPIC
    t = input_trait(non_const[0])
    for k in non_const[1:]:
        if input_trait(k) != t:
            return InputTrait.GENERIC
    if t == InputTrait.STATIONARY_LINEAR_FUNCTIONAL and len(non_const) > 1:
        # different linear functionals c don't share a scalar profile
        return InputTrait.GENERIC
    return t


def _flatten(cls, args):
    out = []
    for a in args:
        if isinstance(a, cls):
            out.extend(a.args)
        else:
            out.append(a)
    return tuple(out)


@kernel_pytree
class Sum(Kernel):
    """Pointwise sum of kernels (reference src/algebra.jl:28-47)."""

    args: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "args", _flatten(Sum, self.args))

    @property
    def trait(self) -> InputTrait:
        return _combined(self.args)

    @property
    def is_mercer(self) -> bool:
        # all(ismercer, args) — reference src/properties.jl:19
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def profile(self, s):
        return sum(k.profile(s) for k in self.args)

    def profile_value(self, s):
        return sum(k.profile_value(s) for k in self.args)

    def tau_call(self, tau):
        return sum(k.tau_call(tau) for k in self.args)

    def __call__(self, x, y):
        return sum(k(x, y) for k in self.args)


@kernel_pytree
class Product(Kernel):
    """Pointwise product of kernels (src/algebra.jl:5-25)."""

    args: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "args", _flatten(Product, self.args))

    @property
    def trait(self) -> InputTrait:
        return _combined(self.args)

    @property
    def is_mercer(self) -> bool:
        # Schur product theorem: products of PSD kernels are PSD
        # (reference src/properties.jl:19)
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def profile(self, s):
        out = None
        for k in self.args:
            p = k.profile(s)
            out = p if out is None else out * p
        return out

    def profile_value(self, s):
        out = None
        for k in self.args:
            p = k.profile_value(s)
            out = p if out is None else out * p
        return out

    def tau_call(self, tau):
        out = None
        for k in self.args:
            p = k.tau_call(tau)
            out = p if out is None else out * p
        return out

    def __call__(self, x, y):
        out = None
        for k in self.args:
            p = k(x, y)
            out = p if out is None else out * p
        return out


@kernel_pytree(static=("p",))
class Power(Kernel):
    """k^p with static integer exponent (src/algebra.jl:50-63)."""

    k: Kernel = None
    p: int = 1

    @property
    def trait(self) -> InputTrait:
        return input_trait(self.k)

    @property
    def is_mercer(self) -> bool:
        # integer power = repeated Schur product (src/properties.jl:20)
        return getattr(self.k, "is_mercer", False) and self.p >= 1

    def profile(self, s):
        return self.k.profile(s) ** self.p

    def profile_value(self, s):
        return self.k.profile_value(s) ** self.p

    def tau_call(self, tau):
        return self.k.tau_call(tau) ** self.p

    def __call__(self, x, y):
        return self.k(x, y) ** self.p


@kernel_pytree
class SeparableProduct(Kernel):
    """prod_i k_i(x_i, y_i) — per-dimension product (src/algebra.jl:68-95).
    On a LazyGrid the dispatcher turns its gramian into a lazy Kronecker
    product of per-dimension gramians."""

    args: tuple = ()

    @property
    def is_mercer(self) -> bool:
        # tensor product of PSD kernels is PSD (src/properties.jl:19)
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def __call__(self, x, y):
        x = jnp.atleast_1d(jnp.asarray(x))
        y = jnp.atleast_1d(jnp.asarray(y))
        out = None
        for i, k in enumerate(self.args):
            p = k(x[i], y[i])
            out = p if out is None else out * p
        return out


@kernel_pytree
class SeparableSum(Kernel):
    """sum_i k_i(x_i, y_i) — additive per-dimension kernel
    (src/algebra.jl:105-123)."""

    args: tuple = ()

    @property
    def is_mercer(self) -> bool:
        return all(getattr(k, "is_mercer", False) for k in self.args)

    def __call__(self, x, y):
        x = jnp.atleast_1d(jnp.asarray(x))
        y = jnp.atleast_1d(jnp.asarray(y))
        return sum(k(x[i], y[i]) for i, k in enumerate(self.args))


def separable(op, *kernels, d: int = None) -> Kernel:
    """Convenience constructor (src/algebra.jl:140-143):
       separable('*', k1, k2, ...) / separable('+', ...) /
       separable('^', k, d=3) for a d-fold separable power."""
    if op in ("*", "prod"):
        return SeparableProduct(tuple(kernels))
    if op in ("+", "sum"):
        return SeparableSum(tuple(kernels))
    if op in ("^", "pow"):
        (k,) = kernels
        if d is None:
            raise ValueError("separable('^', k, d=...) needs d")
        return SeparableProduct(tuple(k for _ in range(d)))
    raise ValueError(f"unknown separable op {op!r}")


def _to_kernel(v):
    from .stationary import Constant

    if isinstance(v, Kernel):
        return v
    return Constant(v)


def add(a, b) -> Kernel:
    return Sum((_to_kernel(a), _to_kernel(b)))


def mul(a, b) -> Kernel:
    return Product((_to_kernel(a), _to_kernel(b)))
