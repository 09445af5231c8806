"""Nyström preconditioner for large-n kernel CG solves.

The reference solves lazy systems with UNpreconditioned CG
(src/gramian.jl:229-238); for smooth kernels at n ~ 10^6 the spectrum of
K + sigma^2 I has thousands of eigenvalues above sigma^2 and plain CG
stalls. The standard scalable-GP remedy (GPyTorch's pivoted-Cholesky
preconditioner, Frangella-Tropp-Udell's randomized Nystrom) is all
dense matrix work: a rank-r Nystrom sketch

    K ~= U U^T,  U = K[:, Z] V diag(w)^{-1/2},  (w, V) = eigh(K[Z, Z])

and the preconditioner solve is a Woodbury identity — two (n, r) matmuls
per CG iteration, entirely fast-path work:

    P = U U^T + sigma^2 I
    P^-1 v = (v - U E diag(1/(s+sigma^2)) E^T U^T v) / sigma^2,
    (s, E) = eigh(U^T U).

PRECISION (measured on an f32 accelerator in an earlier version): the
spectral part of
the build needs f64. Forming U = K_xz Kzz^{-1/2} in f32 poisons the
small-eigenvalue modes (strongly cancelling products amplified by
1/sqrt(w): every mode below ~3e-6 * lambda_max is junk, and the modes
down to sigma^2/lambda_max ~ 1e-7 are what the preconditioner exists to
damp) — device-f32-built M stalled PCG at relres 2.5e-2 (n=32768) and
diverged at n=1e5, while an f64 build converges in 3-4 iterations. The
APPLY is fine in f32 (validated by the same bisect).

An all-host f64 build would ship the (n, r) U panel to the device —
2 GB of host-device traffic at n=10^6. Instead the build restructures
the math so no ill-conditioned object is ever formed at
f32 (see `nystrom_preconditioner`): the device only computes the RAW
kernel panel P = K_xz and its Gram P^T P (float-float compensated
accumulation, f64-class in pure f32 ops); everything
dynamic-range-critical happens in f64 on the host at r x r size, and
~3 MB crosses the host-device boundary in total.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, donate_argnums=(0,), static_argnames=("block",))
def _u_fill_block(U, k, xp_padded, Z, W0, i0, n, block: int = 8192):
    """One donated in-place block write U[i0:i0+block] = mask(K_bz @ W0).
    i0/n are traced operands so the program compiles ONCE and runs for
    every block."""
    from ..utils.testing import pairwise_xy
    from ..ops.tiles import matmul_p

    xb = jax.lax.dynamic_slice_in_dim(xp_padded, i0, block)
    Ub = matmul_p(pairwise_xy(k, xb, Z), W0, precision="highest")
    rows = i0 + jnp.arange(block)
    Ub = jnp.where((rows < n)[:, None], Ub.astype(U.dtype), 0.0)
    return jax.lax.dynamic_update_slice_in_dim(U, Ub, i0, 0)


def _u_panel_padded(k, xp_padded, Z, W0, n: int, block: int = 8192):
    """U = K_xz @ W0 built in fused row blocks written IN PLACE into one
    preallocated (nb*block, r) buffer via DONATED per-block jit calls —
    guaranteed single-buffer peak (U + one block's temporaries). A
    lax.fori_loop carry double-buffered the panel (2 x 12 GB OOM at
    rank 3072, r5), and the r5 first cut's lax.map + reshape[:n]
    slice-copy OOM'd rank 2048; the r4 build held the raw panel AND U
    and capped rank at 1024. Each block's kernel panel is consumed by
    the (block, r) x (r, r) matmul inside the same program — the raw
    (n, r) panel never materializes. Rows >= n are zero-masked: callers
    keep U PADDED and pad/slice only vectors."""
    npad, d = xp_padded.shape
    r = W0.shape[1]
    nb = npad // block
    U = jnp.zeros((npad, r), dtype=jnp.result_type(xp_padded.dtype,
                                                   W0.dtype))
    for i in range(nb):
        U = _u_fill_block(U, k, xp_padded, Z, W0, jnp.int32(i * block),
                          jnp.int32(n), block=block)
    return U


def _build_nystrom_hostf64(k, x_np, noise, rank, seed):
    """f64 build on the CPU backend; returns host arrays (U32, E, s)."""
    from ..utils.testing import pairwise_xy

    n = x_np.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, rank, replace=False)

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        xh = jnp.asarray(x_np, dtype=jnp.float64)
        Z = xh[jnp.asarray(idx)]
        Kzz = np.asarray(pairwise_xy(k, Z, Z), dtype=np.float64)
        w, V = np.linalg.eigh(Kzz)
        floor = max(float(w[-1]), 0.0) * 1e-12
        inv_sqrt = np.where(w > floor, 1.0 / np.sqrt(np.maximum(w, floor)), 0.0)
        Vis = jnp.asarray(V * inv_sqrt[None, :])
        U32 = np.empty((n, rank), dtype=np.float32)
        B = np.zeros((rank, rank), dtype=np.float64)
        blk = 65536
        for i in range(0, n, blk):
            panel = pairwise_xy(k, xh[i:i + blk], Z)      # (b, r) f64
            Ub = panel @ Vis
            B += np.asarray(Ub.T @ Ub, dtype=np.float64)
            U32[i:i + blk] = np.asarray(Ub, dtype=np.float32)
        s, E = np.linalg.eigh(B)
        s = np.maximum(s, 0.0)
    return U32, E.astype(np.float32), s.astype(np.float32)


@partial(jax.jit, static_argnames=("chunk",))
def _gram_ff(P, chunk: int = 2048):
    """G = P^T P with FLOAT-FLOAT (TwoSum) accumulation across row
    chunks: each chunk's (r, r) tile is a matmul at HIGHEST input
    precision (within-chunk f32-accumulator error ~ sqrt(chunk) * eps,
    relative to the chunk norm); chunks combine into an (hi, lo) f32
    pair with compensated summation, so the cross-chunk accumulation is
    exact to ~eps^2. Net error ~1e-7 * ||G|| at n = 10^6 — f64-class,
    computed entirely on device in f32 ops. Returns (hi, lo).

    P's rows must be a multiple of `chunk` OR the tail is processed as
    one short chunk — P is NEVER padded/copied (an 8 GB panel's pad
    copy OOM'd rank 2048 at n = 10^6, r5); chunks are read with
    dynamic_slice so peak memory is P plus one (chunk, r) slice."""
    from ..ops.tiles import resolve_precision

    n, r = P.shape
    nfull = n // chunk
    prec = resolve_precision("highest")
    z = jnp.zeros((r, r), P.dtype)

    def accum(carry, Pc):
        hi, lo = carry
        C = jax.lax.dot_general(Pc, Pc, (((0,), (0,)), ((), ())),
                                precision=prec)
        s = hi + C
        # TwoSum compensation: t = C - (s - hi) is exact when |hi| >= |C|
        t = C - (s - hi)
        return (s, lo + t)

    def body(i, carry):
        Pc = jax.lax.dynamic_slice_in_dim(P, i * chunk, chunk)
        return accum(carry, Pc)

    hi, lo = jax.lax.fori_loop(0, nfull, body, (z, z))
    if n - nfull * chunk:
        hi, lo = accum((hi, lo), P[nfull * chunk:])
    return hi, lo


def nystrom_preconditioner(k, x, noise, rank: int = 256, key=None,
                           floor_rel: float = 1e-8):
    """Returns apply(v) ~= (K + noise I)^-1 v for use as CG's `M`.

    `noise` is the variance added to the diagonal (sigma^2). The sketch
    uses `rank` uniformly-sampled landmark rows; memory is one (n, rank)
    f32 panel on device. SPD by construction (the capacitance is applied
    through its eigendecomposition with s >= 0).

    Device build: rather than build on the host in f64 and ship the
    (n, r) U panel to the device (2 GB at n = 10^6), it keeps the SAME
    operator (U = K_xz V w^{-1/2}, Woodbury through eigh(U^T U)) but
    computes every O(n)-sized object on device in f32, with two measured
    precision repairs that make f32 sufficient (CPU-f64-simulated sweep,
    r4; the r3 f32 build used floor 1e-12 + f32 Gram and diverged):

      * eigenvalue floor w > floor_rel * w_max with floor_rel = 1e-8
        (not 1e-12): modes below it are exactly the ones whose inv-sqrt
        amplification poisons f32 — truncating them costs ~1 PCG
        iteration at n = 2048 while making the f32 U product match the
        f64 one (4-5 iters either way, vs 15+ at floor 1e-12);
      * B = U^T U via float-float chunk accumulation (`_gram_ff`):
        B's eigenvalues enter as s + sigma^2, and a plain f32 Gram's
        sqrt(n) * eps accumulation error (~6e-5 ||B|| at n = 10^6)
        would swamp sigma^2.

    Host f64 does only the two r x r eigendecompositions; total
    host<->device traffic is ~3 MB instead of 2 GB."""
    from ..utils.grids import as_points
    from ..utils.testing import pairwise_xy

    seed = 0 if key is None else int(jax.random.randint(key, (), 0, 2**31 - 1))
    xp = jnp.asarray(as_points(x))
    n = xp.shape[0]
    rank = min(rank, n)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, rank, replace=False)
    Z = xp[jnp.asarray(idx)]
    # Kzz eigh in f64 on the host CPU backend (rank points — trivial)
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        Zh = jnp.asarray(np.asarray(Z), dtype=jnp.float64)
        Kzz = np.asarray(pairwise_xy(k, Zh, Zh), dtype=np.float64)
    Kzz = 0.5 * (Kzz + Kzz.T)
    w, V = np.linalg.eigh(Kzz)
    floor = max(float(w[-1]), 0.0) * floor_rel
    inv_sqrt = np.where(w > floor, 1.0 / np.sqrt(np.maximum(w, floor)), 0.0)
    W0 = jnp.asarray((V * inv_sqrt[None, :]).astype(np.float32))

    block = 8192
    nb = -(-n // block)
    npad = nb * block
    xp_pad = jnp.pad(xp, ((0, npad - n), (0, 0)))
    # U stays PADDED (rows >= n zero-masked) for its whole life: only
    # vectors are padded/sliced per apply — never the 8 GB panel
    U = _u_panel_padded(k, xp_pad, Z, W0, n=n, block=block)
    hi, lo = _gram_ff(U, chunk=block)
    B = np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
    s, E = np.linalg.eigh(0.5 * (B + B.T))
    s = np.maximum(s, 0.0)
    # Floor the per-mode RESIDUE at what an f32 APPLY can represent: the
    # apply computes (v - U t) whose top-mode residue is noise/(s+noise)
    # of v — once s/noise exceeds ~1/(16 eps_f32) the residue drowns in
    # U's own f32 representation error, the apply turns indefinite on
    # those modes, and PCG DIVERGES (measured r4: the demo's inferred
    # lengthscale 2.6 at n=2^20 hit exactly this). The flooring must be
    # done by SCALING THE WOODBURY DENOMINATOR, d_i = s_i (s_cap+noise)/
    # s_cap for s_i > s_cap (residue floor noise/(s_cap+noise) > 0), NOT
    # by capping s_i while U keeps the true spectrum: min-capping makes
    # the apply's eigenvalue (1 - s_i/(s_cap+noise))/noise NEGATIVE on
    # every mode with s_i > s_cap + noise — an indefinite M that makes
    # PCG diverge 400x in residual at overshoot ratios ~2e3 (ADVICE r4,
    # verified numerically). Denominator scaling keeps M SPD with
    # cond(M^-1 K) ~ s_max/s_cap: graceful extra iterations, never
    # divergence.
    s_cap = float(noise) / (16.0 * np.finfo(np.float32).eps)
    denom = np.where(s > s_cap, s * (s_cap + float(noise)) / s_cap,
                     s + float(noise))
    Ej = jnp.asarray(E.astype(np.float32))
    dj = jnp.asarray(denom.astype(np.float32))
    nz = jnp.asarray(noise, U.dtype)

    # IEEE f32 products: the residue floor above assumes f32 rounding, and
    # a TF32 apply (a GPU's default for f32 matmuls) would break it. The
    # products are matrix-vector, so bound by memory, not arithmetic.
    mm = partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)

    def apply(v):
        vp = jnp.pad(v, (0, npad - n)) if npad != n else v
        t = mm(Ej.T, mm(U.T, vp))
        t = mm(Ej, t / dj)
        out = (vp - mm(U, t)) / nz
        return out[:n] if npad != n else out

    return apply
