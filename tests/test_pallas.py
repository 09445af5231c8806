"""Fused Triton MVM kernel and the gradient-block MVMs, against oracles.

On the CPU the Triton kernel runs in Pallas interpret mode, which checks
its math — tiling, padding, masking, the column-tile loop — against the
XLA path. Its compiled form runs only on the card: the `gpu`-marked
test checks there that each precision tier rounds as it claims."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfjax.kernels import EQ, Dot, MaternP
from cfjax.derivative import GradientKernel
from cfjax.derivative.gradient import grad_matvec_dot, grad_matvec_iso
from cfjax.operators.gramian import gramian_matvec
from cfjax.ops.pallas_mvm import pallas_gramian_matvec
from cfjax.utils.testing import round_mantissa


@pytest.mark.parametrize("k,mode", [(MaternP(2), "iso"), (Dot() ** 2, "dot")])
def test_pallas_scalar_mvm_interpret(k, mode, rng):
    n, m, d = 300, 270, 3  # non-multiples of the tile sizes
    x = jnp.asarray(rng.standard_normal((n, d)), dtype=jnp.float32)
    y = jnp.asarray(rng.standard_normal((m, d)), dtype=jnp.float32)
    a = jnp.asarray(rng.standard_normal(m), dtype=jnp.float32)
    out = pallas_gramian_matvec(k, x, y, a, mode, tm=64, tn=32, interpret=True)
    ref = gramian_matvec(k, x, y, a, mode, 64)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=2e-5)


@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_pallas_scalar_mvm_precisions_interpret(prec, rng):
    """Every precision tier lowers and computes correctly through the
    kernel, with a point dimension that pads (40 -> 64) and loops over
    two tk-wide chunks. On CPU interpret all tiers are exact f32, so this
    checks structure, not rounding; the rounding of each tier is measured
    on the card by chip_smoke.py."""
    n, m, d = 300, 270, 40
    x = jnp.asarray(rng.standard_normal((n, d)), dtype=jnp.float32)
    y = jnp.asarray(rng.standard_normal((m, d)), dtype=jnp.float32)
    a = jnp.asarray(rng.standard_normal(m), dtype=jnp.float32)
    out = pallas_gramian_matvec(EQ(), x, y, a, "iso", tm=64, tn=64, tk=32,
                                interpret=True, precision=prec)
    ref = gramian_matvec(EQ(), x, y, a, "iso", 64)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-4, atol=2e-5)


def _grad_block_oracle(k, x, y, A):
    """f64 sum_j d^2 k(x_i, y_j) / dx dy @ A_j, one (d, d) block per pair."""
    blk = lambda xi, yj: jax.jacfwd(jax.grad(k, argnums=0), argnums=1)(xi, yj)
    B = jax.vmap(lambda xi: jax.vmap(lambda yj: blk(xi, yj))(y))(x)
    return np.einsum("ijab,jb->ia", np.asarray(B), np.asarray(A))


@pytest.mark.parametrize("k,mode", [(EQ(), "iso"), (MaternP(2), "iso"), (Dot() ** 2, "dot")])
def test_grad_matvec_block_oracle(k, mode, rng):
    """The closed-form gradient-block MVMs (the GradientGramian's only
    path for iso/dot kernels) against the per-pair f64 block oracle."""
    n, m, d = 70, 53, 5
    x = rng.standard_normal((n, d)) / np.sqrt(d)
    y = rng.standard_normal((m, d)) / np.sqrt(d)
    A = rng.standard_normal((m, d))
    ref = _grad_block_oracle(k, jnp.asarray(x), jnp.asarray(y), jnp.asarray(A))
    f32 = lambda v: jnp.asarray(v, dtype=jnp.float32)
    fast = grad_matvec_iso if mode == "iso" else grad_matvec_dot
    out = np.asarray(fast(k, f32(x), f32(y), f32(A), block=32))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, rtol=0, atol=2e-5)
    # and through the operator a user builds
    G = GradientKernel(k).gramian(f32(x), f32(y))
    out_op = np.asarray(G @ f32(A).reshape(-1)).reshape(n, d)
    np.testing.assert_allclose(out_op / scale, ref / scale, rtol=0, atol=2e-5)


def _expansion_matvec_f64(x, a, dot_bits=None, block=1024):
    """f64 EQ MVM by the expansion |x_i|^2 + |x_j|^2 - 2 <x_i, x_j>, the
    inner products' inputs rounded to `dot_bits` mantissa bits when given
    (the norms are not): what the kernel computes when its dot rounds its
    inputs so, with every other rounding removed."""
    x = np.asarray(x, np.float64)
    xr = x if dot_bits is None else round_mantissa(x, dot_bits)
    a = np.asarray(a, np.float64)
    x2 = (x * x).sum(1)
    out = np.empty(len(x))
    for i in range(0, len(x), block):
        D = x2[i:i + block, None] + x2[None] - 2.0 * (xr[i:i + block] @ xr.T)
        out[i:i + block] = np.exp(-np.maximum(D, 0.0) / 2) @ a
    return out


def _rel(u, v):
    return float(np.linalg.norm(u - v) / np.linalg.norm(v))


def test_round_mantissa():
    """Nearest rounding to 10 (TF32) and 7 (bf16) mantissa bits; bf16
    agrees with JAX's own cast."""
    one = np.float32(1.0)
    assert round_mantissa(one + 2.0 ** -12, 10) == 1.0
    assert round_mantissa(one + 3 * 2.0 ** -12, 10) == 1.0 + 2.0 ** -10
    assert round_mantissa(-(one + 3 * 2.0 ** -12), 10) == -(1.0 + 2.0 ** -10)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(round_mantissa(x, 7), bf.astype(np.float64))
    assert np.all(np.abs(round_mantissa(x, 10) - x) <= 2.0 ** -11 * np.abs(x))


@pytest.mark.gpu
@pytest.mark.parametrize("prec", ["default", "high", "highest"])
def test_fused_mvm_on_card(gpu, prec):
    """The compiled Triton kernel at every tier, and the Gramian's choice
    of it: taken on the TF32 tiers, declined at "highest" (where XLA's
    path is faster). The TF32 tiers must match the f64 expansion with
    TF32-rounded dot inputs (nearest), closer than half the distance of
    that control from the exact f64 MVM — so IEEE f32 or bf16 dots fail;
    "highest" must be within half that distance of the exact MVM — so a
    TF32 dot fails."""
    from cfjax import config
    from cfjax.operators import Gramian
    from cfjax.ops.pallas_mvm import pallas_decline_reason

    rng = np.random.default_rng(0)
    n, d = 4096, 64
    x = jnp.asarray(rng.standard_normal((n, d)) / np.sqrt(d), dtype=jnp.float32)
    a = jnp.asarray(rng.standard_normal(n), dtype=jnp.float32)
    out = np.asarray(pallas_gramian_matvec(EQ(), x, x, a, "iso", precision=prec),
                     np.float64)
    old = config.DEFAULT.matmul_precision
    try:
        config.set_config(matmul_precision=prec)
        why = pallas_decline_reason(Gramian(EQ(), x))
    finally:
        config.set_config(matmul_precision=old)
    assert (why is None) == (prec != "highest"), why
    ref = _expansion_matvec_f64(x, a)
    tf32 = _expansion_matvec_f64(x, a, dot_bits=10)
    gap = _rel(tf32, ref)
    err = _rel(out, ref if prec == "highest" else tf32)
    assert err < 0.5 * gap, (err, gap)
