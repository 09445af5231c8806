"""Hessian kernels: cov of Hessian observations — O(n^2 d^2) block MVMs.

JAX rebuild of reference src/hessian.jl. The reference stores a
lazy per-pair element (r, r r^T, perfect-shuffle/Kronecker identities,
src/hessian.jl:72-190); here the closed-form action of the d^2 x d^2
block on a per-point d x d matrix is derived analytically and the whole
block-MVM is evaluated as batched einsums over row tiles.

Closed forms (k(x,y) = f(s), s = |x-y|^2, r = x - y, f_i = i-th
derivative of the profile; derivations independent of the reference):

  HH (hessian-hessian) 4-tensor T_{ij,kl} = d4 k / dx_i dx_j dy_k dy_l:
    T = 16 f4 r^4  +  8 f3 (6 symmetric r^2-delta terms)
        + 4 f2 (delta_ij delta_kl + delta_ik delta_jl + delta_il delta_jk)
  acting on a matrix A (col-point block):
    T(A) = (16 f4 q + 8 f3 trA) r r^T + (8 f3 q + 4 f2 trA) I
           + 8 f3 (w r^T + r w^T) + 4 f2 As
  with As = A + A^T, w = As r, q = r^T A r = (1/2) r^T As r.

Dot-product trait (s = <x,y>, row point p = x_i, col point z = y_j):
    T(A) = f4 (p^T A p) z z^T + f3 ((As p) z^T + z (As p)^T) + f2 As

The ValueGradientHessian (1+d+d^2)-block forms use the cross blocks
  VG = -2 f1 r,            GV = 2 f1 r,
  VH = 4 f2 r r^T + 2 f1 I,     HV = same,
  GH_{i,kl} = 8 f3 r_i r_k r_l + 4 f2 (d_ik r_l + d_il r_k + r_i d_kl),
  HG = -GH (by x<->y antisymmetry of odd orders).
(cf. reference src/hessian.jl:279-479.)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..kernels.base import InputTrait, Kernel, MultiKernel, input_trait
from ..kernels.derivatives import elementwise_derivatives
from ..operators.linop import LinearOperator


def _cdiv(a, b):
    return -(-a // b)


def _pad_rows(x, block):
    n = x.shape[0]
    nb = _cdiv(n, block)
    pad = nb * block - n
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.reshape(nb, block, x.shape[1])


from ..ops.tiles import inner_tile as _inner_tile
from ..ops.tiles import resolve_precision as _rp


def _es(subscripts, *ops):
    """einsum at the configured matmul precision (ops/tiles.py)."""
    return jnp.einsum(subscripts, *ops, precision=_rp())
from ..ops.tiles import sqdist_tile as _sqdist_tile


# --------------------------------------------------------------------------
# Hessian-Hessian MVM
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("block",))
def hess_matvec_iso(k, x, y, A, block=32):
    """A: (m, d, d) per-point input blocks -> (n, d, d)."""
    n, d = x.shape
    As = A + jnp.swapaxes(A, 1, 2)
    trA = jnp.trace(A, axis1=1, axis2=2)

    def body(xb):
        D = _sqdist_tile(xb, y)
        _, f1, f2, f3, f4 = elementwise_derivatives(k.profile, D, 4)
        r = xb[:, None, :] - y[None, :, :]          # (B, m, d)
        w = _es("mde,bme->bmd", As, r)       # As r
        q = 0.5 * _es("bmd,bmd->bm", r, w)   # r^T A r
        c_rr = 16 * f4 * q + 8 * f3 * trA[None, :]
        c_I = jnp.sum(8 * f3 * q + 4 * f2 * trA[None, :], axis=1)  # (B,)
        out = _es("bm,bmd,bme->bde", c_rr, r, r)
        wr = _es("bm,bmd,bme->bde", 8 * f3, w, r)
        out = out + wr + jnp.swapaxes(wr, 1, 2)
        out = out + _es("bm,mde->bde", 4 * f2, As)
        out = out + c_I[:, None, None] * jnp.eye(d, dtype=out.dtype)[None]
        return out

    out = lax.map(body, _pad_rows(x, block))
    return out.reshape(-1, d, d)[:n]


@partial(jax.jit, static_argnames=("block",))
def hess_matvec_dot(k, x, y, A, block=32):
    n, d = x.shape
    As = A + jnp.swapaxes(A, 1, 2)
    def body(xb):
        S = _inner_tile(xb, y)
        _, f1, f2, f3, f4 = elementwise_derivatives(k.profile, S, 4)
        w = _es("mde,be->bmd", As, xb)       # As p
        q = 0.5 * _es("be,bme->bm", xb, w)   # p^T A p
        out = _es("bm,md,me->bde", f4 * q, y, y)
        zw = _es("bm,bmd,me->bde", f3, w, y)
        out = out + jnp.swapaxes(zw, 1, 2) + zw
        # careful: (As p) z^T has row index from w -> 'bmd' x 'me' -> (b,d,e)
        out2 = _es("bm,mde->bde", f2, As)
        return out + out2

    out = lax.map(body, _pad_rows(x, block))
    return out.reshape(-1, d, d)[:n]


@partial(jax.jit, static_argnames=("block",))
def hess_matvec_generic(k, x, y, A, block=8):
    """4th-order nested AD fallback (reference src/hessian.jl:28-41)."""
    n, d = x.shape

    def pair(xi, yj, Aj):
        T = jax.jacfwd(jax.jacfwd(lambda y_: jax.hessian(lambda x_: k(x_, y_))(xi)))(
            yj
        )  # (d, d, d, d) indexed [i, j, k, l]... jacfwd appends axes
        # first jacfwd gives [i,j,k]; second [i,j,k,l]
        return _es("ijkl,kl->ij", T, Aj)

    def body(xb):
        def one_row(xi):
            contribs = jax.vmap(lambda yj, Aj: pair(xi, yj, Aj))(y, A)
            return jnp.sum(contribs, axis=0)

        return jax.vmap(one_row)(xb)

    out = lax.map(body, _pad_rows(x, block))
    return out.reshape(-1, d, d)[:n]


# --------------------------------------------------------------------------
# ValueGradientHessian MVM (isotropic closed form + generic fallback)
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("block",))
def vgh_matvec_iso(k, x, y, a0, A1, A2, block=32):
    """(1 + d + d^2)-block MVM, isotropic. a0: (m,), A1: (m,d), A2: (m,d,d)."""
    n, d = x.shape
    As2 = A2 + jnp.swapaxes(A2, 1, 2)
    trA2 = jnp.trace(A2, axis1=1, axis2=2)
    I = jnp.eye(d)

    def body(xb):
        D = _sqdist_tile(xb, y)
        f0, f1, f2, f3, f4 = elementwise_derivatives(k.profile, D, 4)
        r = xb[:, None, :] - y[None, :, :]              # (B, m, d)
        rA1 = _es("bmd,md->bm", r, A1)           # <r, A1>
        w2 = _es("mde,bme->bmd", As2, r)         # As2 r
        q2 = 0.5 * _es("bmd,bmd->bm", r, w2)     # r^T A2 r

        # b0 = sum_j f0 a0 - 2 f1 <r,A1> + 4 f2 q2 + 2 f1 trA2
        b0 = jnp.sum(
            f0 * a0[None, :] - 2 * f1 * rA1 + 4 * f2 * q2 + 2 * f1 * trA2[None, :],
            axis=1,
        )

        # B1 = sum_j 2 f1 a0 r - 2 f1 A1 - 4 f2 <r,A1> r
        #      + 8 f3 q2 r + 4 f2 (As2 r + trA2 r)
        c_r = 2 * f1 * a0[None, :] - 4 * f2 * rA1 + 8 * f3 * q2 + 4 * f2 * trA2[None, :]
        B1 = (
            _es("bm,bmd->bd", c_r, r)
            - 2 * (f1 @ A1)
            + 4 * _es("bm,bmd->bd", f2, w2)
        )

        # B2 = sum_j a0 (4 f2 r r^T + 2 f1 I)
        #      - [8 f3 <r,A1> r r^T + 4 f2 (A1 r^T + r A1^T + <r,A1> I)]
        #      + HH(A2)
        c_rr = (
            4 * f2 * a0[None, :]
            - 8 * f3 * rA1
            + 16 * f4 * q2
            + 8 * f3 * trA2[None, :]
        )
        c_I = jnp.sum(
            2 * f1 * a0[None, :] - 4 * f2 * rA1 + 8 * f3 * q2 + 4 * f2 * trA2[None, :],
            axis=1,
        )
        B2 = _es("bm,bmd,bme->bde", c_rr, r, r)
        A1r = _es("bm,md,bme->bde", 4 * f2, A1, r)  # A1 r^T weighted
        B2 = B2 - A1r - jnp.swapaxes(A1r, 1, 2)
        wr = _es("bm,bmd,bme->bde", 8 * f3, w2, r)
        B2 = B2 + wr + jnp.swapaxes(wr, 1, 2)
        B2 = B2 + _es("bm,mde->bde", 4 * f2, As2)
        B2 = B2 + c_I[:, None, None] * I[None]
        return b0, B1, B2

    xbs = _pad_rows(x, block)
    b0, B1, B2 = lax.map(body, xbs)
    return (
        b0.reshape(-1)[:n],
        B1.reshape(-1, d)[:n],
        B2.reshape(-1, d, d)[:n],
    )


@partial(jax.jit, static_argnames=("block",))
def vgh_matvec_generic(k, x, y, a0, A1, A2, block=4):
    n, d = x.shape

    def pair(xi, yj, a0j, A1j, A2j):
        kv = k(xi, yj)
        gx = jax.grad(lambda x_: k(x_, yj))(xi)
        gy = jax.grad(lambda y_: k(xi, y_))(yj)
        GG = jax.jacfwd(lambda y_: jax.grad(lambda x_: k(x_, y_))(xi))(yj)
        HV = jax.hessian(lambda x_: k(x_, yj))(xi)
        VH = jax.hessian(lambda y_: k(xi, y_))(yj)
        GH = jax.jacfwd(jax.jacfwd(lambda y_: jax.grad(lambda x_: k(x_, y_))(xi)))(yj)
        HG = jax.jacfwd(lambda y_: jax.hessian(lambda x_: k(x_, y_))(xi))(yj)
        HH = jax.jacfwd(jax.jacfwd(lambda y_: jax.hessian(lambda x_: k(x_, y_))(xi)))(yj)
        b0 = kv * a0j + gy @ A1j + _es("kl,kl->", VH, A2j)
        B1 = gx * a0j + GG @ A1j + _es("ikl,kl->i", GH, A2j)
        B2 = HV * a0j + _es("ijl,l->ij", HG, A1j) + _es(
            "ijkl,kl->ij", HH, A2j
        )
        return b0, B1, B2

    def body(xb):
        def one_row(xi):
            b0s, B1s, B2s = jax.vmap(
                lambda yj, a0j, A1j, A2j: pair(xi, yj, a0j, A1j, A2j)
            )(y, a0, A1, A2)
            return jnp.sum(b0s), jnp.sum(B1s, 0), jnp.sum(B2s, 0)

        return jax.vmap(one_row)(xb)

    b0, B1, B2 = lax.map(body, _pad_rows(x, block))
    return b0.reshape(-1)[:n], B1.reshape(-1, d)[:n], B2.reshape(-1, d, d)[:n]


# --------------------------------------------------------------------------
# operators + kernel wrappers
# --------------------------------------------------------------------------


class HessianGramian(LinearOperator):
    """Flat (n d^2) x (m d^2) operator; layout per point: row-major vec of
    the d x d block (reference src/hessian.jl:2-23)."""

    def __init__(self, k, x, y=None, block=None):
        from ..utils.grids import as_points

        self.k = k
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        D = self.d * self.d
        self.shape = (self.x.shape[0] * D, self.y.shape[0] * D)
        self.dtype = jnp.result_type(self.x.dtype, float)
        t = input_trait(k)
        self.mode = (
            "iso"
            if t == InputTrait.ISOTROPIC
            else "dot"
            if t == InputTrait.DOT
            else "generic"
        )
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        # PSD holds for the derivative gramian of a genuine Mercer kernel
        # (cov of derivatives); don't claim it from symmetry alone
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        d = self.d
        A = v.reshape(self.y.shape[0], d, d)
        kws = {} if self.block is None else dict(block=self.block)
        if self.mode == "iso":
            out = hess_matvec_iso(self.k, self.x, self.y, A, **kws)
        elif self.mode == "dot":
            out = hess_matvec_dot(self.k, self.x, self.y, A, **kws)
        else:
            out = hess_matvec_generic(self.k, self.x, self.y, A, **kws)
        return out.reshape(-1)


@dataclasses.dataclass(frozen=True)
class HessianKernel(MultiKernel):
    """d^2 x d^2 matrix-valued kernel cov(hess f(x), hess f(y))
    (reference HessianKernel, src/hessian.jl:2-23)."""

    k: Kernel

    def block_shape(self, d):
        return (d * d, d * d)

    def __call__(self, x, y):
        x = jnp.atleast_1d(jnp.asarray(x))
        y = jnp.atleast_1d(jnp.asarray(y))
        d = x.shape[0]
        T = jax.jacfwd(jax.jacfwd(lambda y_: jax.hessian(lambda x_: self.k(x_, y_))(x)))(y)
        return T.reshape(d * d, d * d)

    def gramian(self, x, y=None, **opts):
        return HessianGramian(self.k, x, y, **opts)


class ValueGradientHessianGramian(LinearOperator):
    """Flat (n (1+d+d^2)) x (m (1+d+d^2)) operator; per-point layout
    [value, grad (d), vec(hessian) (d^2)] (reference src/hessian.jl:279-479)."""

    def __init__(self, k, x, y=None, block=None):
        from ..utils.grids import as_points

        self.k = k
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        D = 1 + self.d + self.d * self.d
        self.D = D
        self.shape = (self.x.shape[0] * D, self.y.shape[0] * D)
        self.dtype = jnp.result_type(self.x.dtype, float)
        self.mode = "iso" if input_trait(k) == InputTrait.ISOTROPIC else "generic"
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        # PSD holds for the derivative gramian of a genuine Mercer kernel
        # (cov of derivatives); don't claim it from symmetry alone
        return self._same and getattr(self.k, "is_mercer", False)

    def _matvec(self, v):
        d, D = self.d, self.D
        V = v.reshape(self.y.shape[0], D)
        a0 = V[:, 0]
        A1 = V[:, 1 : 1 + d]
        A2 = V[:, 1 + d :].reshape(-1, d, d)
        kws = {} if self.block is None else dict(block=self.block)
        fn = vgh_matvec_iso if self.mode == "iso" else vgh_matvec_generic
        b0, B1, B2 = fn(self.k, self.x, self.y, a0, A1, A2, **kws)
        return jnp.concatenate(
            [b0[:, None], B1, B2.reshape(-1, d * d)], axis=1
        ).reshape(-1)


@dataclasses.dataclass(frozen=True)
class ValueGradientHessianKernel(MultiKernel):
    """(1+d+d^2)^2-block kernel of (f, grad f, hess f) observations."""

    k: Kernel

    def block_shape(self, d):
        D = 1 + d + d * d
        return (D, D)

    def __call__(self, x, y):
        x = jnp.atleast_1d(jnp.asarray(x))
        y = jnp.atleast_1d(jnp.asarray(y))
        d = x.shape[0]
        k = self.k
        kv = k(x, y)
        gx = jax.grad(lambda x_: k(x_, y))(x)
        gy = jax.grad(lambda y_: k(x, y_))(y)
        GG = jax.jacfwd(lambda y_: jax.grad(lambda x_: k(x_, y_))(x))(y)
        HV = jax.hessian(lambda x_: k(x_, y))(x).reshape(d * d)
        VH = jax.hessian(lambda y_: k(x, y_))(y).reshape(d * d)
        GH = jax.jacfwd(jax.jacfwd(lambda y_: jax.grad(lambda x_: k(x_, y_))(x)))(
            y
        ).reshape(d, d * d)
        HG = jax.jacfwd(lambda y_: jax.hessian(lambda x_: k(x_, y_))(x))(y).reshape(
            d * d, d
        )
        HH = jax.jacfwd(jax.jacfwd(lambda y_: jax.hessian(lambda x_: k(x_, y_))(x)))(
            y
        ).reshape(d * d, d * d)
        top = jnp.concatenate([kv[None], gy, VH])[None, :]
        mid = jnp.concatenate([gx[:, None], GG, GH], axis=1)
        bot = jnp.concatenate([HV[:, None], HG, HH], axis=1)
        return jnp.concatenate([top, mid, bot], axis=0)

    def gramian(self, x, y=None, **opts):
        return ValueGradientHessianGramian(self.k, x, y, **opts)
