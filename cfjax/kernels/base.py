"""Kernel base types, input traits, and pytree registration.

JAX redesign of the reference's abstract type tree + trait system
(reference: src/CovarianceFunctions.jl:32-42, src/properties.jl:31-63).
Julia encodes structure in *types* and dispatches on them; here every
kernel is a frozen dataclass registered as a JAX pytree (hyperparameters
are leaves, structure is static metadata), and structure detection is
explicit: kernels carry an `InputTrait` and canonical scalar *profiles*
that the operator layer inspects at construction time to pick a jitted
fast path.

Evaluation conventions (reference src/stationary.jl:8-10, src/mercer.jl:2-3):
  - isotropic   : k(x, y) = profile(||x - y||^2)
  - dot-product : k(x, y) = profile(<x, y>)
  - stationary  : k(x, y) = tau_call(x - y)
  - stationary linear functional (Cosine): k(x, y) = profile(<c, x - y>)
  - generic     : k(x, y) arbitrary
Inputs to `__call__` are scalars or 1-D arrays; batching is done by the
operator layer (vmap / matmul expansions), never inside the kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

import jax
import jax.numpy as jnp


class InputTrait(enum.Enum):
    """What scalar summary of (x, y) the kernel depends on.

    Mirrors the reference's InputTrait hierarchy (src/properties.jl:31-37)
    as an enum inspected at operator-construction time.
    """

    GENERIC = "generic"
    ISOTROPIC = "isotropic"                  # depends on ||x-y||^2
    DOT = "dot"                              # depends on <x, y>
    STATIONARY = "stationary"                # depends on x - y
    STATIONARY_LINEAR_FUNCTIONAL = "slf"     # depends on <c, x - y>
    PERIODIC = "periodic"                    # 1-D periodic warp


def kernel_pytree(cls=None, *, static: tuple = ()):
    """Decorator: frozen dataclass + JAX pytree registration.

    Fields listed in `static` become pytree metadata (must be hashable);
    all other fields are children (hyperparameters / sub-kernels).
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        names = [f.name for f in dataclasses.fields(c)]
        data = [n for n in names if n not in static]
        jax.tree_util.register_dataclass(c, data_fields=data, meta_fields=list(static))
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def check(cond_fn, value, msg: str):
    """Validate a hyperparameter at user-construction time.

    Only plain Python scalars / numpy values are checked: JAX transforms
    (grad/jit/vmap) rebuild kernel pytrees with tracers or cotangent
    arrays as fields — e.g. a negative gradient for RQ.alpha — and those
    reconstructions must never be rejected."""
    import numpy as np

    leaves = jax.tree_util.tree_leaves(value)
    if any(isinstance(l, (jax.core.Tracer, jax.Array)) for l in leaves):
        return
    try:
        v = np.asarray(value)
    except Exception:
        return
    if v.dtype == object:
        # tree_unflatten may rebuild kernels with sentinel object() leaves
        # (e.g. inside custom_vjp machinery) — never reject those
        return
    try:
        ok = bool(cond_fn(v))
    except TypeError:
        return
    if not ok:
        raise ValueError(f"{msg}: got {value}")


def sqdist(x, y):
    """Squared euclidean distance of two points (scalar or 1-D).

    Reference `euclidean2` (src/util.jl:40-47)."""
    d = jnp.asarray(x) - jnp.asarray(y)
    return jnp.sum(jnp.square(d))


class Kernel:
    """Base class for all (scalar-valued) kernels."""

    # --- structure metadata -------------------------------------------------
    @property
    def trait(self) -> InputTrait:
        return InputTrait.GENERIC

    @property
    def is_mercer(self) -> bool:
        """Provably positive semi-definite? Defaults FALSE (reference
        src/properties.jl:2: `ismercer(::T) where T = false`) so arbitrary
        callables (LambdaKernel) are never claimed PSD; the zoo base
        classes and combinators override/propagate it. Downstream this
        gates `Gramian.is_psd` and hence the Cholesky/CG-vs-MINRES solver
        routing."""
        return False

    @property
    def is_stationary(self) -> bool:
        return self.trait in (
            InputTrait.ISOTROPIC,
            InputTrait.STATIONARY,
            InputTrait.STATIONARY_LINEAR_FUNCTIONAL,
            InputTrait.PERIODIC,
        )

    @property
    def is_isotropic(self) -> bool:
        return self.trait == InputTrait.ISOTROPIC

    @property
    def is_dot(self) -> bool:
        return self.trait == InputTrait.DOT

    # --- evaluation ---------------------------------------------------------
    def profile(self, s):
        """Canonical scalar profile: f(r^2), f(<x,y>), or f(<c,tau>) per trait."""
        raise NotImplementedError(
            f"{type(self).__name__} does not define a scalar profile"
        )

    def profile_value(self, s):
        """Fast VALUE-ONLY profile for the dense MVM hot loops.

        Contract: identical values to `profile` everywhere (including
        s = 0), but its derivative IN s may be clamped to 0 in an
        eps-neighbourhood of 0 (where `profile` carries a Taylor guard so
        jax.grad is exact). Only derivative-free evaluation paths (value
        MVMs, sparse builds, Barnes-Hut tiles) may use it; everything that
        differentiates the profile in s — the gradient/Hessian kernel
        layer via elementwise_derivatives — must use `profile`.
        Hyperparameter gradients THROUGH value MVMs stay correct: at
        s = 0 every ds/dtheta factor is itself 0, so a clamped (finite)
        profile' contributes 0 either way, while an unguarded sqrt would
        contribute inf * 0 = NaN."""
        return self.profile(s)

    def tau_call(self, tau):
        """Stationary evaluation on the difference tau = x - y."""
        raise NotImplementedError

    def __call__(self, x, y):
        t = self.trait
        if t == InputTrait.ISOTROPIC:
            return self.profile(sqdist(x, y))
        if t == InputTrait.DOT:
            return self.profile(jnp.sum(jnp.asarray(x) * jnp.asarray(y)))
        if t in (InputTrait.STATIONARY, InputTrait.STATIONARY_LINEAR_FUNCTIONAL):
            return self.tau_call(jnp.asarray(x) - jnp.asarray(y))
        raise NotImplementedError(
            f"{type(self).__name__} must implement __call__ for generic inputs"
        )

    # --- algebra (defined in algebra.py, attached there to avoid cycles) ----
    def __add__(self, other):
        from . import algebra

        return algebra.add(self, other)

    __radd__ = __add__

    def __mul__(self, other):
        from . import algebra

        return algebra.mul(self, other)

    __rmul__ = __mul__

    def __pow__(self, p):
        from . import algebra

        return algebra.Power(self, int(p))


class MercerKernel(Kernel):
    """Base for kernels that are provably PSD (reference MercerKernel,
    src/CovarianceFunctions.jl:32-35; `ismercer(::MercerKernel) = true`,
    src/properties.jl:3)."""

    @property
    def is_mercer(self) -> bool:
        return True


class IsotropicKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.ISOTROPIC

    def tau_call(self, tau):
        return self.profile(jnp.sum(jnp.square(jnp.asarray(tau))))


class StationaryKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.STATIONARY


class DotProductKernel(MercerKernel):
    @property
    def trait(self) -> InputTrait:
        return InputTrait.DOT


class MultiKernel:
    """Base for matrix-valued kernels (reference MultiKernel,
    src/CovarianceFunctions.jl:40-42). `block_shape` gives the per-pair
    output block dimensions for inputs of dimension d."""

    def block_shape(self, d: int) -> tuple:
        raise NotImplementedError

    def __call__(self, x, y):
        raise NotImplementedError


def input_trait(k) -> InputTrait:
    """Explicit replacement for the reference's `input_trait` dispatch
    (src/properties.jl:39-45)."""
    if isinstance(k, Kernel):
        return k.trait
    return InputTrait.GENERIC
