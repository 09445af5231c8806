"""The pair-family fast path: kernels as F(s, nx, ny).

Observation (no analogue in the reference): with
s = <x, y>, nx = |x|^2, ny = |y|^2, every isotropic kernel is
F = f(nx + ny - 2 s), every dot-product kernel is F = f(s), the
neural-network kernel is F(s, nx, ny) directly — and any
Sum/Product/Power/Chained combination of such kernels is again a
scalar function of (s, nx, ny), differentiable by jax.grad.

The gradient-kernel block then has the universal closed form
    Block(a) = F_s a + (F_ss <p,a> + 2 F_sny <z,a>) z
                     + (2 F_snx <p,a> + 4 F_nxny <z,a>) p
(p = row point, z = column point), so the full block MVM is 3 matmuls
plus elementwise derivative tiles — ONE code path replacing the
reference's per-combinator Woodbury rules (src/gradient_algebra.jl:47-128)
and its hand-derived NN-kernel block (src/gradient.jl:173-211), and
covering heterogeneous iso+dot+NN products the reference handles only
generically.

Cross-covariances for value+gradient observations:
    grad_x k = F_s z + 2 F_nx p,    grad_y k = F_s p + 2 F_ny z.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.tiles import inner_tile as _inner_tile
from ..ops.tiles import matmul_p as _mm

from ..kernels.algebra import Power, Product, Sum
from ..kernels.base import InputTrait, Kernel, input_trait
from ..kernels.mercer import NeuralNetwork
from ..kernels.stationary import Constant
from ..kernels.transforms import Chained, Lengthscale


def pair_family_available(k) -> bool:
    """Can k be written as a smooth scalar F(s, nx, ny)?"""
    t = input_trait(k)
    if isinstance(k, Constant):
        return True
    if isinstance(k, NeuralNetwork):
        return True
    if isinstance(k, (Sum, Product)):
        return all(pair_family_available(a) for a in k.args)
    if isinstance(k, Power):
        return pair_family_available(k.k)
    if isinstance(k, Chained):
        return pair_family_available(k.k)
    if t in (InputTrait.ISOTROPIC, InputTrait.DOT):
        return True
    return False


def pair_profile(k, s, nx, ny):
    """Scalar F(s, nx, ny) for kernel k (recursive over combinators)."""
    if isinstance(k, Constant):
        return jnp.asarray(k.c) * jnp.ones_like(s)
    if isinstance(k, NeuralNetwork):
        sig = jnp.asarray(k.sigma)
        u = (s + sig) / jnp.sqrt((1 + nx + sig) * (1 + ny + sig))
        return 2 / jnp.pi * jnp.arcsin(u)
    if isinstance(k, Sum):
        return sum(pair_profile(a, s, nx, ny) for a in k.args)
    if isinstance(k, Product):
        out = None
        for a in k.args:
            v = pair_profile(a, s, nx, ny)
            out = v if out is None else out * v
        return out
    if isinstance(k, Power):
        return pair_profile(k.k, s, nx, ny) ** k.p
    if isinstance(k, Chained):
        return k.f(pair_profile(k.k, s, nx, ny))
    t = input_trait(k)
    if t == InputTrait.ISOTROPIC:
        # NO clamp to 0 here: jnp.maximum ties at r^2 = 0 on the diagonal
        # and its 0.5/0.5 tie-gradient halves every diagonal-block
        # derivative. Profiles used with derivative kernels are smooth at
        # (and just below) 0 by construction (Taylor guards), so the raw
        # value is both correct and AD-exact.
        return k.profile(nx + ny - 2 * s)
    if t == InputTrait.DOT:
        return k.profile(s)
    raise ValueError(f"{type(k).__name__} is not in the pair family")


def _partials(k, order2_cross=True):
    """Scalar partial-derivative functions of F needed by the gradient
    block: (F, F_s, F_ss, F_snx, F_sny, F_nxny, F_nx, F_ny)."""
    F = lambda s, nx, ny: pair_profile(k, s, nx, ny)
    Fs = jax.grad(F, argnums=0)
    Fss = jax.grad(Fs, argnums=0)
    Fsnx = jax.grad(Fs, argnums=1)
    Fsny = jax.grad(Fs, argnums=2)
    Fnx = jax.grad(F, argnums=1)
    Fny = jax.grad(F, argnums=2)
    Fnxny = jax.grad(Fnx, argnums=2)
    return F, Fs, Fss, Fsnx, Fsny, Fnxny, Fnx, Fny


def _tile_eval(fns, S, nx, ny):
    """Evaluate scalar fns elementwise on the (B, m) tile."""
    B, m = S.shape
    sf = S.reshape(-1)
    nxf = jnp.broadcast_to(nx[:, None], (B, m)).reshape(-1)
    nyf = jnp.broadcast_to(ny[None, :], (B, m)).reshape(-1)
    return [jax.vmap(f)(sf, nxf, nyf).reshape(B, m) for f in fns]


def _cdiv(a, b):
    return -(-a // b)


def _pad_rows(x, block):
    n = x.shape[0]
    nb = _cdiv(n, block)
    pad = nb * block - n
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.reshape(nb, block, x.shape[1])


@partial(jax.jit, static_argnames=("block",))
def grad_matvec_pair(k, x, y, A, block=128):
    """(n d) x (m d) gradient-gramian MVM via the universal pair form."""
    _, Fs, Fss, Fsnx, Fsny, Fnxny, _, _ = _partials(k)
    ny_ = jnp.sum(y * y, axis=1)
    T = jnp.sum(y * A, axis=1)  # <z_j, A_j>

    def body(xb):
        S = _inner_tile(xb, y)
        nx_ = jnp.sum(xb * xb, axis=1)
        fs, fss, fsnx, fsny, fnxny = _tile_eval(
            [Fs, Fss, Fsnx, Fsny, Fnxny], S, nx_, ny_
        )
        P = _inner_tile(xb, A)
        Wz = fss * P + 2 * fsny * T[None, :]
        Wp = 2 * fsnx * P + 4 * fnxny * T[None, :]
        return _mm(fs, A) + _mm(Wz, y) + jnp.sum(Wp, axis=1)[:, None] * xb

    out = lax.map(body, _pad_rows(x, block))
    return out.reshape(-1, x.shape[1])[: x.shape[0]]


@partial(jax.jit, static_argnames=("block",))
def valgrad_matvec_pair(k, x, y, a0, A, block=128):
    """(1+d)-block MVM via the universal pair form."""
    F, Fs, Fss, Fsnx, Fsny, Fnxny, Fnx, Fny = _partials(k)
    ny_ = jnp.sum(y * y, axis=1)
    T = jnp.sum(y * A, axis=1)

    def body(xb):
        S = _inner_tile(xb, y)
        nx_ = jnp.sum(xb * xb, axis=1)
        f, fs, fss, fsnx, fsny, fnxny, fnx, fny = _tile_eval(
            [F, Fs, Fss, Fsnx, Fsny, Fnxny, Fnx, Fny], S, nx_, ny_
        )
        P = _inner_tile(xb, A)
        # b0 = sum_j [ F a0 + <grad_y k, A_j> ],  grad_y k = F_s p + 2 F_ny z
        b0 = f @ a0 + jnp.sum(fs * P, axis=1) + 2 * jnp.sum(fny * T[None, :], axis=1)
        # B1 = sum_j [ grad_x k a0_j + Block A_j ], grad_x k = F_s z + 2 F_nx p
        Wz = fs * a0[None, :] + fss * P + 2 * fsny * T[None, :]
        Wp_sum = jnp.sum(
            2 * fnx * a0[None, :] + 2 * fsnx * P + 4 * fnxny * T[None, :], axis=1
        )
        B1 = _mm(fs, A) + _mm(Wz, y) + Wp_sum[:, None] * xb
        return jnp.concatenate([b0[:, None], B1], axis=1)

    out = lax.map(body, _pad_rows(x, block))
    return out.reshape(-1, 1 + x.shape[1])[: x.shape[0]]
