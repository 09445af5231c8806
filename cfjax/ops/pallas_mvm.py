"""Fused kernel-tile MVM for the GPU, written in Pallas through Triton.

Replaces the reference's threaded per-element dense MVM
(src/gramian.jl:78-99) on the d > direct_sqdist_max_d expansion path:
each program owns a tile of output rows and loops over column tiles of
the points. Per column tile it forms the inner-product tile with one
tensor-core dot (looping over the point dimension in chunks), turns it
into kernel values with the scalar profile, and contracts them against
the vector — so the (rows x m) distance tile that XLA's path writes to
device memory and reads back (operators/gramian.py) never leaves the SM.

Implemented for isotropic and dot-product trait kernels whose profiles
are pure elementwise jnp functions.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
from jax import lax
from jax.experimental.pallas import triton as plgpu

# Where the fused kernel runs, measured on H100s at the TF32 tiers: it
# beat XLA at n = 4096 and 16384 and at d = 64 and 256, and lost at
# d = 1024, where the d-deep GEMM dominates and cuBLAS runs it faster;
# the crossover between 256 and 1024 is not located (512 is their
# geometric midpoint). At n = 2048 (d = 64) three runs split (kernel
# 0.257 / 0.347 / 0.254 ms vs XLA 0.309 / 0.250 / 0.468), so it starts at
# 4096, where all three favoured it.
FUSED_MIN_N = 4096
FUSED_MAX_D = 512


def pallas_decline_reason(g) -> str | None:
    """Why a Gramian's single-RHS MVM stays off the fused kernel (None ->
    the kernel runs). Every condition is observable: the platform, the
    kernel's trait and hashability, n and d. Surfaced by
    dispatch.explain()."""
    from .. import config as _config
    from .tiles import resolve_precision

    if g.mode not in ("iso", "dot"):
        return f"trait mode {g.mode!r} (fused kernel covers iso/dot)"
    if g.has_quadrature_profile:
        return "real-nu Matern profile (Bessel quadrature) does not lower to Triton"
    if any(isinstance(l, jax.core.Tracer)
           for l in jax.tree_util.tree_leaves((g.k, g.x, g.y))):
        return "traced operands"
    try:
        hash(g.k)
    except TypeError:
        return ("kernel has array-valued (unhashable) hyperparameters — "
                "the profile is baked into the kernel as constants")
    if g.shape[0] < FUSED_MIN_N:
        return f"n={g.shape[0]} < {FUSED_MIN_N}"
    dmax = _config.DEFAULT.direct_sqdist_max_d
    if g.x.shape[1] <= dmax:
        return (f"d={g.x.shape[1]} <= direct_sqdist_max_d={dmax}: the XLA "
                "path's unrolled difference form fuses into its reduction")
    if resolve_precision() == jax.lax.Precision.HIGHEST:
        return ("matmul_precision='highest': XLA's f32 GEMM path is faster "
                "than the kernel's IEEE f32 dot")
    if g.x.shape[1] > FUSED_MAX_D:
        return (f"d={g.x.shape[1]} > {FUSED_MAX_D}: XLA's TF32 GEMM path is "
                "faster at this depth")
    backend = jax.default_backend()
    if backend != "gpu":
        return f"backend {backend!r} is not gpu"
    return None


def _pow2(v: int) -> int:
    return 1 << max(0, (int(v) - 1).bit_length())


def auto_tiles(dp: int) -> tuple:
    """(tm, tn, tk, num_warps, num_stages) by padded point dimension:
    row tile, column tile, point-dimension chunk (powers of two, tk >= 16
    for the tensor cores), warps and pipeline stages. The fastest of nine
    configurations swept on an H100 (700 W) at n = 16384, TF32."""
    if dp <= 64:
        return 64, 128, min(dp, 64), 4, 2
    return 128, 128, 32, 8, 3


def _mvm_kernel(x_ref, x2_ref, y_ref, y2_ref, a_ref, o_ref, *, profile, mode,
                tn, tk, precision):
    """One program: a (tm,) slice of the output. Loops over the column
    tiles of y (and, inside, over tk-wide chunks of the point dimension)."""
    i32 = jnp.int32  # 32-bit loop indices under x64 too
    tm, dp = x_ref.shape
    n_j = y_ref.shape[0] // tn
    n_k = dp // tk
    x2 = x2_ref[...]
    xt = x_ref[...] if n_k == 1 else None  # one chunk: load the rows once

    def col(j, acc):
        cols = pl.ds(pl.multiple_of(j * tn, tn), tn)

        def chunk(kk, S):
            ks = pl.ds(pl.multiple_of(kk * tk, tk), tk)
            return S + pl.dot(x_ref[:, ks], y_ref[cols, ks], trans_b=True,
                              precision=precision)

        if n_k == 1:
            S = pl.dot(xt, y_ref[cols, :], trans_b=True, precision=precision)
        else:
            S = lax.fori_loop(i32(0), i32(n_k), chunk,
                              jnp.zeros((tm, tn), jnp.float32))
        if mode == "iso":
            D = x2[:, None] + y2_ref[cols][None, :] - 2.0 * S
            K = profile(jnp.maximum(D, 0.0))
        else:
            K = profile(S)
        return acc + jnp.sum(K * a_ref[cols][None, :], axis=1)

    o_ref[...] = lax.fori_loop(i32(0), i32(n_j), col, jnp.zeros((tm,), jnp.float32))



@partial(jax.jit, static_argnames=("k", "mode", "tm", "tn", "tk", "interpret",
                                   "precision"))
def pallas_gramian_matvec(k, x, y, a, mode: str = "iso", tm: int = None,
                          tn: int = None, tk: int = None,
                          interpret: bool = False, precision: str = None):
    """b = K a with K_ij = k(x_i, y_j), fused: the inner-product tile is
    recomputed on the tensor cores and contracted at once, so no O(n m)
    data reaches device memory. Single-RHS only (`a` 1-D) — multi-column
    RHS stays on the XLA path, which reuses each K tile across columns.

    Points are zero-padded to tile multiples and to a power-of-two point
    dimension (zero columns change no inner product or distance); padded
    columns are masked by zero-padding `a` (every shipped profile is
    finite at the padded points' distances), and padded rows are sliced
    off the output.

    `precision` is the matmul tier (config.matmul_precision): the dot
    lowers to Triton's TF32 for "default" and "high" and to IEEE f32 for
    "highest", as XLA's own f32 matmuls do on the GPU."""
    from .tiles import resolve_precision

    if a.ndim != 1:
        raise ValueError("pallas_gramian_matvec is single-RHS; use the XLA "
                         "path for matrix RHS")
    n, d = x.shape
    m = y.shape[0]
    dp = max(16, _pow2(d))
    atm, atn, atk, num_warps, num_stages = auto_tiles(dp)
    tm, tn, tk = tm or atm, tn or atn, min(tk or atk, dp)

    f32 = jnp.float32
    xp = jnp.pad(x.astype(f32), ((0, -n % tm), (0, dp - d)))
    yp = jnp.pad(y.astype(f32), ((0, -m % tn), (0, dp - d)))
    ap = jnp.pad(a.astype(f32), (0, -m % tn))
    x2 = jnp.sum(xp * xp, axis=1)
    y2 = jnp.sum(yp * yp, axis=1)
    Np, Mp = xp.shape[0], yp.shape[0]

    out = pl.pallas_call(
        partial(_mvm_kernel, profile=k.profile_value, mode=mode, tn=tn,
                tk=tk, precision=resolve_precision(precision)),
        grid=(Np // tm,),
        in_specs=[
            pl.BlockSpec((tm, dp), lambda i: (i, 0)),
            pl.BlockSpec((tm,), lambda i: (i,)),
            pl.BlockSpec((Mp, dp), lambda i: (0, 0)),
            pl.BlockSpec((Mp,), lambda i: (0,)),
            pl.BlockSpec((Mp,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((tm,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((Np,), f32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name="cfjax_fused_gramian_mvm",
    )(xp, x2, yp, y2, ap)

    return out[:n].astype(jnp.result_type(x.dtype, a.dtype))
