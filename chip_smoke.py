"""Smoke run of cfjax on an NVIDIA GPU, through the public entry points.

    python chip_smoke.py          # one card: phases 0-8
    python chip_smoke.py --four   # four cards: the sharded CG solve only

Each phase prints one line: sizes, the precision contract, the error
against an independent reference with its tolerance and the reason for
it, wall time (compilation included) and the card's peak_bytes_in_use.
References are plain f64 computations on the card (blocked jnp, the
difference form ||x - y||^2 for d <= 32 and the f64 expansion at
HIGHEST above, where f64 cancellation stays ~1e-16 relative) or numpy;
none goes through cfjax.operators. Data come from a fixed seed.

Any failure, or an error over its tolerance, ends the run with a
non-zero exit before the last line. The last line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the run stops at phase 0 with a non-zero exit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0


class SmokeFailure(RuntimeError):
    pass


def nvidia_smi() -> list[str]:
    """Card name and power limit, read by nvidia-smi (no JAX involved)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


# ---------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def report(phase, sizes, precision, err, tol, why, seconds, extra=""):
    """Print the phase's line; raise if the error is not finite or over
    its tolerance."""
    ok = bool(np.isfinite(err) and err <= tol)
    line = (f"[phase {phase}] {sizes} | precision {precision} | "
            f"err {err:.3e} <= tol {tol:.1e} ({why}): {'PASS' if ok else 'FAIL'}"
            f" | {seconds:.3f} s | peak_bytes_in_use {_peak_bytes()}")
    if extra:
        line += f" | {extra}"
    print(line, flush=True)
    if not ok:
        raise SmokeFailure(f"phase {phase} ({sizes}): err {err:.3e} > tol {tol:.1e}")


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def rel_l2(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(out - ref) / np.linalg.norm(ref))


# ---------------------------------------------------------------------------
# f64 references (independent of cfjax.operators)
# ---------------------------------------------------------------------------


def f_eq(s):
    import jax.numpy as jnp

    return jnp.exp(-s / 2)


def f_maternp2(s):
    """Matern nu = 5/2 in the squared distance: (1 + r + r^2/3) e^-r,
    r = sqrt(5 s)."""
    import jax.numpy as jnp

    r = jnp.sqrt(5.0 * s)
    return (1.0 + r + r * r / 3.0) * jnp.exp(-r)


def d_eq(s):
    """(f'(s), f''(s)) of EQ."""
    import jax.numpy as jnp

    e = jnp.exp(-s / 2)
    return -0.5 * e, 0.25 * e


def d_maternp2(s):
    """(f'(s), f''(s)) of Matern 5/2 in closed form, finite at s = 0:
    f' = -5/6 (1 + r) e^-r, f'' = 25/12 e^-r."""
    import jax.numpy as jnp

    r = jnp.sqrt(5.0 * s)
    e = jnp.exp(-r)
    return -5.0 / 6.0 * (1.0 + r) * e, 25.0 / 12.0 * e


def f_exp(s):
    import jax.numpy as jnp

    return jnp.exp(-jnp.sqrt(s))


def _sqdist_f64(xb, Y, xr=None, Yr=None):
    """Squared distances; for d > 32 by the expansion, whose inner
    products take the points xr, Yr when given (rounded copies)."""
    import jax.numpy as jnp
    from jax import lax

    d = xb.shape[1]
    if d <= 32 and xr is None:
        D = 0.0
        for i in range(d):
            t = xb[:, i, None] - Y[None, :, i]
            D = D + t * t
        return D
    xr, Yr = (xb, Y) if xr is None else (xr, Yr)
    S = jnp.matmul(xr, Yr.T, precision=lax.Precision.HIGHEST)
    D = jnp.sum(xb * xb, 1)[:, None] + jnp.sum(Y * Y, 1)[None, :] - 2.0 * S
    return jnp.maximum(D, 0.0)


def ref_matvec(f, x, y, a, block=256, dot_bits=None):
    """f64 sum_j f(|x_i - y_j|^2) a_j, blocked over rows, on the card.
    With `dot_bits`, the expansion's inner products take the points
    rounded to that many mantissa bits (nearest; the norms do not): what
    a dot that rounds its inputs so computes, every other rounding
    removed."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from cfjax.utils.testing import round_mantissa

    rounded = (lambda v: v) if dot_bits is None else (
        lambda v: round_mantissa(v, dot_bits))
    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(x, np.float64))
        Y = jnp.asarray(np.asarray(y, np.float64))
        Xr = jnp.asarray(rounded(np.asarray(x, np.float64)))
        Yr = jnp.asarray(rounded(np.asarray(y, np.float64)))
        A = jnp.asarray(np.asarray(a, np.float64))
        n = X.shape[0]
        pad = lambda V: jnp.pad(V, ((0, -n % block), (0, 0))).reshape(
            -1, block, V.shape[1])

        @jax.jit
        def run(Xp, Xrp, Y, Yr, A):
            if dot_bits is None:
                return lax.map(lambda xb: f(_sqdist_f64(xb, Y)) @ A, Xp)
            return lax.map(lambda b: f(_sqdist_f64(b[0], Y, b[1], Yr)) @ A,
                           (Xp, Xrp))

        return np.asarray(run(pad(X), pad(Xr), Y, Yr, A)).reshape(-1)[:n]


def ref_grad_matvec(df, x, y, A, block=16):
    """f64 sum_j B(x_i, y_j) A_j with B = d^2 k / dx dy for
    k = f(|x - y|^2): B = -2 f'(s) I - 4 f''(s) r r^T, r = x - y;
    df(s) = (f'(s), f''(s))."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(x, np.float64))
        Y = jnp.asarray(np.asarray(y, np.float64))
        Aj = jnp.asarray(np.asarray(A, np.float64))
        n, d = X.shape
        Xp = jnp.pad(X, ((0, -n % block), (0, 0))).reshape(-1, block, d)

        @jax.jit
        def run(Xp, Y, Aj):
            def body(xb):
                S = _sqdist_f64(xb, Y)
                R = xb[:, None, :] - Y[None, :, :]              # (b, m, d)
                RA = jnp.einsum("bmd,md->bm", R, Aj,
                                precision=lax.Precision.HIGHEST)
                f1, f2 = df(S)
                W = f2 * RA
                return (-2.0 * jnp.matmul(f1, Aj, precision=lax.Precision.HIGHEST)
                        - 4.0 * jnp.einsum("bm,bmd->bd", W, R,
                                           precision=lax.Precision.HIGHEST))
            return lax.map(body, Xp)

        return np.asarray(run(Xp, Y, Aj)).reshape(-1, d)[:n]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(expect_count=None):
    import jax

    smi = nvidia_smi()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SmokeFailure(f"no GPU: JAX's first device is {dev.platform!r}")
    count = len(jax.devices())
    if expect_count is not None and count < expect_count:
        raise SmokeFailure(f"{count} GPUs visible, {expect_count} needed")
    for l in smi:
        print(f"nvidia-smi: {l}", flush=True)
    print(f"[phase 0] device {dev.platform} | kind {dev.device_kind} | "
          f"count {count} | jax {jax.__version__} | "
          f"XLA_FLAGS {os.environ.get('XLA_FLAGS', '')!r}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind, "count": count}


def _gp_data(rng, n, d):
    x = rng.uniform(0.0, 1.0, (n, d))
    fx = np.sin(2 * np.pi * x[:, 0]) * np.cos(2 * np.pi * x[:, 1]) + x[:, 2] ** 2
    return x, fx


def phase_gp(n=1 << 18, n_test=4096, n_check=4096, lengthscale=0.2,
             noise=1e-2, tol=1e-4):
    """gp_condition on its Nystrom-PCG branch, then the posterior mean."""
    import jax.numpy as jnp

    from cfjax.gp import gp_condition
    from cfjax.kernels import EQ, Lengthscale

    rng = np.random.default_rng(SEED)
    x, fx = _gp_data(rng, n, 3)
    y = fx + np.sqrt(noise) * rng.standard_normal(n)
    xt, _ = _gp_data(rng, n_test, 3)
    k = Lengthscale(EQ(), lengthscale)
    xj = jnp.asarray(x, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)

    post, dt = timed(lambda: gp_condition(k, xj, yj, noise=noise, tol=tol,
                                          maxiter=2000))
    if post.cg_info is None:
        raise SmokeFailure("gp_condition did not take its preconditioned CG path")
    iters = int(post.cg_info[0])
    alpha = np.asarray(post.alpha, np.float64)
    if not np.all(np.isfinite(alpha)):
        raise SmokeFailure("non-finite alpha")
    rows = np.sort(rng.choice(n, n_check, replace=False))
    f_l = lambda s: f_eq(s / lengthscale ** 2)
    Kalpha = ref_matvec(f_l, x[rows], x, alpha)
    Kabs = ref_matvec(f_l, x[rows], x, np.abs(alpha))
    res = Kalpha + noise * alpha[rows] - y[rows]
    ynorm = np.linalg.norm(y[rows])
    rel_res = float(np.linalg.norm(res) / ynorm)
    # what f32 can certify: one rounding of every term of (K + noise I) alpha
    floor = 2.0 ** -24 * float(np.linalg.norm(Kabs + noise * np.abs(alpha[rows])) / ynorm)
    report(1, f"gp_condition n={n} d=3 Lengthscale(EQ(),{lengthscale}) "
              f"noise={noise} tol={tol}", "f32 difference-form MVM",
           rel_res, tol + floor,
           f"f64 true residual on {n_check} sampled rows; CG tol + the f32 "
           f"rounding floor {floor:.2e} of (K + noise I) alpha", dt,
           f"CG iterations {iters}")

    mean, dt = timed(lambda: post.mean(jnp.asarray(xt, jnp.float32)))
    ref = ref_matvec(f_l, xt, x, alpha)
    ratio = float(np.linalg.norm(ref_matvec(f_l, xt, x, np.abs(alpha)))
                  / np.linalg.norm(ref))
    report(1, f"GPPosterior.mean n_test={n_test} n={n}", "f32 difference form",
           rel_l2(mean, ref), 2.0 ** -23 * ratio,
           f"f32 rounding of {n} terms: 2^-23 x the sum's cancellation ratio "
           f"|K||alpha| / |K alpha| = {ratio:.3e}", dt)


def _ref_logml_and_grad(x, y, lengthscale, noise, probes):
    """f64 dense Cholesky logML and d/d(lengthscale, noise) on the card:
    d/dt = 1/2 alpha^T dA alpha - 1/2 tr(A^-1 dA), A = K + noise I.

    Also, for the two gradients, the exact standard deviation of their
    `probes`-probe Rademacher (Hutchinson) estimate, from
    Var z^T M z = sum_{i != j} M_ij^2 + M_ij M_ji with M = A^-1 dA (None
    for the logML: its variance needs log A). Run as separate programs
    so no more than three n x n f64 buffers live at once. Returns
    {name: (value, sd or None)}."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    hi = lax.Precision.HIGHEST
    with jax.enable_x64(True):
        X = jnp.asarray(np.asarray(x, np.float64))
        Y = jnp.asarray(np.asarray(y, np.float64))
        n = X.shape[0]
        l = float(lengthscale)
        L = jax.jit(lambda X: jnp.linalg.cholesky(
            jnp.exp(-_sqdist_f64(X, X) / (2 * l * l)) + noise * jnp.eye(n)))(X)

        @jax.jit
        def value(L, Y):
            alpha = jax.scipy.linalg.cho_solve((L, True), Y)
            logdet = 2 * jnp.sum(jnp.log(jnp.diagonal(L)))
            return alpha, logdet, -0.5 * (jnp.dot(Y, alpha) + logdet
                                          + n * jnp.log(2 * jnp.pi))

        alpha, logdet, logml = value(L, Y)
        Linv = jax.jit(lambda L: jax.scipy.linalg.solve_triangular(
            L, jnp.eye(n), lower=True))(L)
        del L
        Ainv = jax.jit(lambda Li: jnp.matmul(Li.T, Li, precision=hi))(Linv)
        del Linv

        @jax.jit
        def dk_terms(X, Ainv, alpha):
            D = _sqdist_f64(X, X)
            K = jnp.exp(-D / (2 * l * l))
            dK = K * D / l ** 3
            return (dK, jnp.dot(alpha, jnp.matmul(dK, alpha, precision=hi)),
                    jnp.sum(Ainv * dK), jnp.trace(Ainv),
                    2 * (jnp.sum(Ainv * Ainv) - jnp.sum(jnp.diagonal(Ainv) ** 2)))

        dK, q, t, tr_ainv, var_s = dk_terms(X, Ainv, alpha)
        M = jax.jit(lambda A, B: jnp.matmul(A, B, precision=hi))(Ainv, dK)
        del Ainv, dK
        var_l = jax.jit(lambda M: jnp.sum(M * M) + jnp.sum(M * M.T)
                        - 2 * jnp.sum(jnp.diagonal(M) ** 2))(M)
        del M
        sd = lambda var: 0.5 * float(jnp.sqrt(var / probes))
        return {"logML": (float(logml), None),
                "dlogML/dl": (float(0.5 * q - 0.5 * t), sd(var_l)),
                "dlogML/dnoise": (float(0.5 * jnp.dot(alpha, alpha) - 0.5 * tr_ainv),
                                  sd(var_s))}


def phase_logml(n=1 << 15, lengthscale=0.2, noise=0.5, keys=8, probes=16,
                lanczos_iters=128, solve_maxiter=2000):
    """value_and_grad of log_marginal_likelihood in the lazy SLQ regime,
    averaged over `keys` independent probe keys. The gradients' tolerance
    is 4 standard deviations of that average, exact from the f64
    reference (see _ref_logml_and_grad); the logML's is the two-sided
    99.9% Student-t quantile times the standard error across keys. Enough
    Lanczos steps that the quadrature's own bias, ~rho^(2 steps) with
    rho = (sqrt(cond) - 1) / (sqrt(cond) + 1) (Ubaru, Chen & Saad 2017),
    is negligible next to it; the library's default of 48 steps is not
    checked here (ROADMAP queue 3)."""
    import jax
    import jax.numpy as jnp
    from scipy import stats

    from cfjax.gp import log_marginal_likelihood
    from cfjax.kernels import EQ, Lengthscale

    rng = np.random.default_rng(SEED + 1)
    x, fx = _gp_data(rng, n, 3)
    y = fx + np.sqrt(noise) * rng.standard_normal(n)
    xj = jnp.asarray(x, jnp.float32)
    yj = jnp.asarray(y, jnp.float32)

    vg = jax.value_and_grad(
        lambda k, s, key: log_marginal_likelihood(
            k, xj, yj, noise=s, key=key, method="slq", probes=probes,
            lanczos_iters=lanczos_iters, solve_maxiter=solve_maxiter),
        argnums=(0, 1))
    est = {"logML": [], "dlogML/dl": [], "dlogML/dnoise": []}
    t_all = 0.0
    for i in range(keys):
        (v, (gk, gs)), dt = timed(vg, Lengthscale(EQ(), lengthscale),
                                  jnp.float32(noise), jax.random.PRNGKey(i))
        t_all += dt
        est["logML"].append(float(v))
        est["dlogML/dl"].append(float(gk.l))
        est["dlogML/dnoise"].append(float(gs))
    ref = _ref_logml_and_grad(x, y, lengthscale, noise, probes)
    for name, vals in est.items():
        r, sd = ref[name]
        mean = statistics.fmean(vals)
        if sd is None:
            se = statistics.stdev(vals) / math.sqrt(keys)
            q = float(stats.t.ppf(0.9995, keys - 1))
            tol, why = q * se, (f"{q:.2f} (Student-t, {keys - 1} dof, 99.9% "
                                f"two-sided) x the standard error across keys "
                                f"{se:.3e}")
        else:
            tol, why = 4 * sd / math.sqrt(keys), (
                f"4 sd of the {keys}-key mean; one {probes}-probe estimate's "
                f"sd {sd:.3e}, exact from the f64 reference")
        report(2, f"value_and_grad(log_marginal_likelihood) SLQ n={n} d=3 "
                  f"noise={noise} {name} ({keys} keys x {probes} probes, "
                  f"{lanczos_iters} Lanczos steps)",
               "f32 difference-form MVM, f32 Lanczos/CG", abs(mean - r),
               tol + 1e-4 * abs(r),
               f"{why}, + 1e-4 rel for the f32 CG solve; mean {mean:.6e} vs "
               f"f64 Cholesky {r:.6e}; per key {[round(v, 3) for v in vals]}",
               t_all / keys)


def phase_headline(n=16384):
    """The reference's headline MVM: gramian(MaternP(2), x) @ a."""
    import jax.numpy as jnp

    from cfjax.kernels import MaternP
    from cfjax.operators import gramian

    rng = np.random.default_rng(SEED + 2)
    x = rng.standard_normal((n, 3))
    a = rng.standard_normal(n)
    K = gramian(MaternP(2), jnp.asarray(x, jnp.float32))
    out, dt = timed(lambda v: K @ v, jnp.asarray(a, jnp.float32))
    report(3, f"gramian(MaternP(2)) @ a n={n} d=3", "f32 difference form",
           rel_l2(out, ref_matvec(f_maternp2, x, x, a)), 1e-5,
           f"f32 profile and sums of {n} terms", dt)


def hlo_precision(fn, *args):
    """The precision and algorithm fields of the dots XLA compiled."""
    import jax

    txt = jax.jit(fn).lower(*args).compile().as_text()
    found = set(re.findall(r'"operand_precision":\[[^\]]*\]', txt))
    found |= set(re.findall(r'"algorithm":"[A-Z0-9_]+"', txt))
    found |= set(re.findall(r"operand_precision=\{[^}]*\}", txt))
    found |= set(re.findall(r"algorithm=[a-z0-9_]+", txt))
    return ", ".join(sorted(found)) or "none found"


def phase_expansion(n=16384, ds=(64, 256, 1024)):
    """The d > direct_sqdist_max_d path at each matmul precision tier.

    Each tier is held to the rounding it claims, by f64 controls that
    round the expansion's dot inputs (nearest) and nothing else:
    "highest" (IEEE f32) must be closer to the exact f64 MVM than half
    the TF32 control's distance from it; "high" and "default" (TF32)
    must be closer to the TF32 control than that same half distance, so
    an IEEE f32, bf16 or truncating TF32 dot fails. The bf16 control's
    distance is printed beside. XLA's dot must also carry the tier in
    its compiled operand_precision."""
    import jax.numpy as jnp

    from cfjax import config
    from cfjax.kernels import EQ
    from cfjax.operators import gramian
    from cfjax.operators.gramian import gramian_matvec
    from cfjax.ops.pallas_mvm import pallas_decline_reason

    rng = np.random.default_rng(SEED + 3)
    old = config.DEFAULT.matmul_precision
    try:
        for d in ds:
            x = rng.standard_normal((n, d)) / math.sqrt(d)
            a = rng.standard_normal(n)
            xj, aj = jnp.asarray(x, jnp.float32), jnp.asarray(a, jnp.float32)
            x = np.asarray(xj, np.float64)  # the points the library gets
            ref = ref_matvec(f_eq, x, x, a)
            tf32 = ref_matvec(f_eq, x, x, a, dot_bits=10)
            gap = rel_l2(tf32, ref)
            bf16_gap = rel_l2(ref_matvec(f_eq, x, x, a, dot_bits=7), ref)
            for tier in ("highest", "high", "default"):
                config.set_config(matmul_precision=tier)
                K = gramian(EQ(), xj)
                why = pallas_decline_reason(K)
                out, dt = timed(lambda v: K @ v, aj)
                hlo = hlo_precision(
                    lambda x_, a_: gramian_matvec(EQ(), x_, x_, a_, "iso", 512),
                    xj, aj)
                T = tier.upper()
                if (f'"operand_precision":["{T}","{T}"]' not in hlo
                        and f"operand_precision={{{tier},{tier}}}" not in hlo):
                    raise SmokeFailure(f"phase 4 d={d} {tier}: XLA's dot has {hlo}")
                if tier == "highest":
                    err, why_tol = rel_l2(out, ref), "vs exact f64: IEEE f32 dot"
                else:
                    err, why_tol = rel_l2(out, tf32), ("vs the f64 TF32 control: "
                                                       "TF32 dot, nearest")
                report(4, f"gramian(EQ()) @ a n={n} d={d}", tier, err, 0.5 * gap,
                       f"{why_tol}; tol = half the TF32 control's distance "
                       f"{gap:.3e} from exact (bf16 control: {bf16_gap:.3e})", dt,
                       f"vs exact f64 {rel_l2(out, ref):.3e} | path "
                       f"{'fused Triton' if why is None else 'XLA: ' + why}"
                       f" | XLA dot HLO: {hlo}")
    finally:
        config.set_config(matmul_precision=old)


def phase_gradient(sizes=((1024, 1024), (4096, 16))):
    """GradientKernel MVMs against f64 blocks on sampled block rows:
    MaternP(2) at sizes[0] (n, d), EQ at sizes[1]."""
    import jax.numpy as jnp

    from cfjax.derivative import GradientKernel
    from cfjax.kernels import EQ, MaternP
    from cfjax.operators import gramian

    rng = np.random.default_rng(SEED + 4)
    for (k, f), (n, d) in zip(((MaternP(2), d_maternp2), (EQ(), d_eq)), sizes):
        x = rng.standard_normal((n, d)) / math.sqrt(d)
        A = rng.standard_normal((n, d))
        G = gramian(GradientKernel(k), jnp.asarray(x, jnp.float32))
        out, dt = timed(lambda v: G @ v, jnp.asarray(A.reshape(-1), jnp.float32))
        rows = np.sort(rng.choice(n, 64, replace=False))
        ref = ref_grad_matvec(f, x[rows], x, A)
        report(5, f"gramian(GradientKernel({type(k).__name__}({getattr(k, 'p', '')})))"
                  f" @ v n={n} d={d} ({n * d}x{n * d}), 64 block rows",
               "matmul_precision=highest", rel_l2(
                   np.asarray(out).reshape(n, d)[rows], ref), 1e-4,
               "f32 closed-form blocks: four d-deep products per block", dt)


def _tree_invariants(t, n_points):
    """Permutation, covering radii at every level, and points that are
    the input points."""
    P = t.points_np.shape[0]
    perm = np.asarray(t.perm)
    if sorted(perm.tolist()) != list(range(P)):
        raise SmokeFailure("tree permutation is not a permutation")
    worst = 0.0
    for l in range(t.levels + 1):
        nl = 2 ** l
        pts = t.points_np.reshape(nl, P // nl, -1)
        c, r = t.centers_np[l], t.radii_np[l]
        dist = np.sqrt(((pts - c[:, None, :]) ** 2).sum(-1)).max(1)
        worst = max(worst, float(np.max(dist - r)))
    return worst


def phase_structured(n_toeplitz=65536, m_kron=128, n_bh=65536, n_sparse=16384):
    import jax
    import jax.numpy as jnp

    from cfjax.barneshut import BarnesHutFactorization
    from cfjax.barneshut.tree import build_tree
    from cfjax.kernels import EQ, Exp, Lengthscale, separable
    from cfjax.operators import gramian
    from cfjax.operators.sparse_op import sparse_gramian
    from cfjax.utils.grids import LazyGrid, UniformGrid

    rng = np.random.default_rng(SEED + 5)

    # Toeplitz: Exp() on a uniform grid
    n, h = n_toeplitz, 1e-4
    a = rng.standard_normal(n)
    T = gramian(Exp(), UniformGrid(0.0, h, n))
    out, dt = timed(lambda v: T @ v, jnp.asarray(a, jnp.float32))
    g = (h * np.arange(n))[:, None]
    report(6, f"Toeplitz gramian(Exp()) @ a n={n} ({type(T).__name__})",
           "f32 FFT", rel_l2(out, ref_matvec(f_exp, g, g, a)), 1e-5,
           "f32 FFT circulant embedding of length 2n", dt)

    # Kronecker: EQ^(x)3 on a 128^3 grid
    m = m_kron
    ax = np.linspace(0.0, 4.0, m)
    a = rng.standard_normal(m ** 3)
    K = gramian(separable("^", EQ(), d=3), LazyGrid((ax, ax, ax)))
    out, dt = timed(lambda v: K @ v, jnp.asarray(a, jnp.float32))
    K1 = np.exp(-0.5 * (ax[:, None] - ax[None, :]) ** 2)
    ref = np.einsum("ia,jb,kc,abc->ijk", K1, K1, K1, a.reshape(m, m, m),
                    optimize=True).reshape(-1)
    report(6, f"Kronecker gramian(EQ^3) @ a on {m}^3 ({type(K).__name__})",
           "matmul_precision=highest", rel_l2(out, ref), 1e-5,
           "three f32 mode contractions of 128 terms", dt)

    # Barnes-Hut: device tree build + planned MVM
    n = n_bh
    x = rng.uniform(0.0, 50.0, (n, 2))
    w = rng.uniform(0.0, 1.0, n)
    xj = jnp.asarray(x, jnp.float32)
    t, dt = timed(lambda: build_tree(xj, 16))
    if t._packed is None:
        raise SmokeFailure("build_tree took a host path on the GPU")
    gap = _tree_invariants(t, n)
    report(6, f"build_tree n={n} d=2 (device Hilbert build)", "f32",
           max(gap, 0.0), 1e-4, "every point within its node's radius, at "
           "every level; f32 radii", dt)
    F, dt_build = timed(lambda: BarnesHutFactorization(EQ(), xj, theta=0.5))
    gap = _tree_invariants(F.tree, n)
    report(6, f"BarnesHutFactorization build n={n} d=2 theta=0.5 (tree)", "f32",
           max(gap, 0.0), 1e-4, "covering radii of the fused device build",
           dt_build)
    out, dt = timed(lambda v: F @ v, jnp.asarray(w, jnp.float32))
    report(6, f"Barnes-Hut MVM n={n} d=2 theta=0.5 order=1 weights U(0,1)",
           "f32", rel_l2(out, ref_matvec(f_eq, x, x, w)), 1e-2,
           "dipole far field at theta=0.5 (approximation, not rounding)", dt)

    # sparsified MVM: clustered points in d=32
    n, d, c = n_sparse, 32, 256
    centers = 3.0 * rng.standard_normal((c, d))
    x = centers[rng.integers(0, c, n)] + 0.15 * rng.standard_normal((n, d))
    a = rng.standard_normal(n)
    k = Lengthscale(EQ(), 1.0)
    cut = 1e-6
    (S, ratio), dt = timed(lambda: sparse_gramian(k, jnp.asarray(x, jnp.float32),
                                                  tol=cut))
    out, dt_mv = timed(lambda v: S @ v, jnp.asarray(a, jnp.float32))
    ref = ref_matvec(f_eq, x, x, a)
    err = float(np.max(np.abs(np.asarray(out, np.float64) - ref)))
    bound = cut * float(np.abs(a).sum()) + 1e-5 * float(np.abs(ref).max())
    report(6, f"sparse_gramian(EQ) n={n} d={d} tol={cut} nnz ratio {ratio:.2e} "
              f"({type(S).__name__})", "f32", err, bound,
           "max abs: dropped entries < tol so |error| <= tol*|a|_1, + f32", dt_mv,
           f"build {dt:.3f} s")


def phase_card_tests():
    """The tests marked `gpu`, in this process (one process on the card)."""
    import jax
    import pytest

    class Count:
        def __init__(self):
            self.passed, self.failed, self.skipped = [], [], []

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                self.passed.append(report.nodeid)
            elif report.failed:
                self.failed.append(report.nodeid)
            elif report.skipped:
                self.skipped.append(report.nodeid)

    here = os.path.dirname(os.path.abspath(__file__))
    os.environ["JAX_PLATFORMS"] = "cuda"  # conftest keeps an explicit platform
    c = Count()
    t0 = time.perf_counter()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests")],
                     plugins=[c])
    dt = time.perf_counter() - t0
    jax.config.update("jax_enable_x64", False)  # conftest turned it on
    bad = len(c.failed) + len(c.skipped)
    print(f"[phase 7] pytest -m gpu: {len(c.passed)} passed, {len(c.failed)} failed, "
          f"{len(c.skipped)} skipped, exit {int(rc)} | {dt:.3f} s", flush=True)
    if rc != 0 or bad or not c.passed:
        raise SmokeFailure(f"card tests: exit {int(rc)}, failed {c.failed}, "
                           f"skipped {c.skipped}")


def phase_kernels(cases=((16384, 64), (16384, 256), (16384, 1024), (2048, 64),
                         (4096, 64)), rounds=1):
    """The fused Triton kernel against XLA's path on the same inputs, in
    turns, at each precision tier (the n = 2048 and 4096 cases test the
    kernel's FUSED_MIN_N); plus XLA's own times where no kernel is kept."""
    import jax
    import jax.numpy as jnp

    from cfjax import config
    from cfjax.derivative import GradientKernel
    from cfjax.kernels import EQ, MaternP
    from cfjax.operators import gramian
    from cfjax.operators.gramian import gramian_matvec
    from cfjax.ops.pallas_mvm import pallas_gramian_matvec
    from cfjax.utils.timing import time_call

    rng = np.random.default_rng(SEED + 6)
    old = config.DEFAULT.matmul_precision
    try:
        for n, d in cases:
            x = jnp.asarray(rng.standard_normal((n, d)) / math.sqrt(d), jnp.float32)
            a = jnp.asarray(rng.standard_normal(n), jnp.float32)
            for tier in (("highest", "high", "default") if n == 16384 else ("default",)):
                config.set_config(matmul_precision=tier)
                fused = lambda v: pallas_gramian_matvec(EQ(), x, x, v, "iso")
                xla = lambda v: gramian_matvec(EQ(), x, x, v, "iso", 512)
                tf, tx = [], []
                for _ in range(rounds):  # in turns: fused, xla, xla, fused
                    tf.append(time_call(fused, a))
                    tx.append(time_call(xla, a))
                    tx.append(time_call(xla, a))
                    tf.append(time_call(fused, a))
                err = rel_l2(fused(a), xla(a))
                print(f"[phase 8] EQ MVM n={n} d={d} {tier}: fused Triton "
                      f"{statistics.median(tf) * 1e3:.4f} ms vs XLA "
                      f"{statistics.median(tx) * 1e3:.4f} ms "
                      f"(runs {[round(t * 1e3, 4) for t in tf]} / "
                      f"{[round(t * 1e3, 4) for t in tx]}) | fused vs XLA "
                      f"rel {err:.2e}", flush=True)
    finally:
        config.set_config(matmul_precision=old)

    # no kernel kept: XLA's time and temporary bytes
    for nn, d in ((1 << 18, 3), (1 << 20, 2)):
        x = jnp.asarray(rng.uniform(0, 1, (nn, d)), jnp.float32)
        a = jnp.asarray(rng.standard_normal(nn), jnp.float32)
        K = gramian(EQ(), x)
        f = jax.jit(lambda v: K @ v)
        mem = f.lower(a).compile().memory_analysis()
        t = time_call(f, a, warmup=1, reps=3)
        print(f"[phase 8] EQ MVM n={nn} d={d} XLA: {t * 1e3:.4f} ms | temp bytes "
              f"{mem.temp_size_in_bytes} (one (512 x n) f32 tile would be "
              f"{512 * nn * 4})", flush=True)
    for k, nn, d in ((MaternP(2), 1024, 1024), (EQ(), 4096, 16)):
        x = jnp.asarray(rng.standard_normal((nn, d)) / math.sqrt(d), jnp.float32)
        v = jnp.asarray(rng.standard_normal(nn * d), jnp.float32)
        G = gramian(GradientKernel(k), x)
        f = jax.jit(lambda v: G @ v)
        mem = f.lower(v).compile().memory_analysis()
        t = time_call(f, v)
        print(f"[phase 8] GradientKernel({type(k).__name__}) MVM n={nn} d={d} XLA: "
              f"{t * 1e3:.4f} ms | temp bytes {mem.temp_size_in_bytes}", flush=True)

    # what the card reaches on plain work, for roofline shares
    A = jnp.ones((8192, 8192), jnp.bfloat16)
    t = time_call(jax.jit(lambda A: A @ A), A)
    B = jnp.ones((1 << 28,), jnp.float32)
    tc = time_call(jax.jit(lambda B: B * 2.0), B)
    print(f"[phase 8] bf16 matmul 8192^3: {2 * 8192 ** 3 / t / 1e12:.1f} TFLOP/s | "
          f"f32 copy 1 GiB: {2 * B.nbytes / tc / 1e9:.1f} GB/s", flush=True)


def phase_four(n=1 << 20, lengthscale=0.02, noise=1.0, tol=2e-2, n_check=4096):
    """The sharded lazy Gramian on four cards: sharded_gramian_matvec_2d
    over a 2 x 2 mesh and ShardedGramian over a 1-D mesh of 4, each
    against the one-card path on device 0 in this process: one MVM, a CG
    solve whose true residual is checked in f64, and its solution against
    the one-card solution. The one-card solve, the slowest, runs last."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators import cg
    from cfjax.operators.gramian import gramian_matvec
    from cfjax.parallel import ShardedGramian
    from cfjax.parallel.mesh import sharded_gramian_matvec_2d

    devs = jax.devices()[:4]
    rng = np.random.default_rng(SEED + 7)
    x = rng.uniform(0.0, 1.0, (n, 2))
    y = np.sin(6 * x[:, 0]) * np.cos(4 * x[:, 1]) + rng.standard_normal(n)
    k = Lengthscale(EQ(), lengthscale)
    f_l = lambda s: f_eq(s / lengthscale ** 2)
    xf, yf = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)
    rows = np.sort(rng.choice(n, n_check, replace=False))
    ynorm = np.linalg.norm(y[rows])

    what = (f"CG n={n} d=2 Lengthscale(EQ(),{lengthscale}) noise={noise} "
            f"tol={tol}")

    def solve(name, mv, b, placed, out1=None):
        """One MVM against the one-card MVM, then CG and its f64 true
        residual on sampled rows. Returns the solution."""
        extra = f"x shards on devices {placed}"
        if out1 is not None:
            out, dt = timed(mv, b)
            report("4x", f"{name} MVM n={n} d=2", "f32 difference form",
                   rel_l2(out, out1), 1e-5, "against the one-card MVM: f32 "
                   "sums of 2^20 terms in another order", dt, extra)
        # CG asks for tol / 2: the check below estimates the whole-vector
        # residual from sampled rows
        (a, info), dt = timed(lambda: cg(mv, b, tol=tol / 2, maxiter=1000))
        a = np.asarray(a, np.float64)
        Ka = ref_matvec(f_l, x[rows], x, a)
        Kabs = ref_matvec(f_l, x[rows], x, np.abs(a))
        res = float(np.linalg.norm(Ka + noise * a[rows] - y[rows]) / ynorm)
        floor = 2.0 ** -24 * float(np.linalg.norm(Kabs + noise * np.abs(a[rows])) / ynorm)
        report("4x", f"{name} {what}", "f32 difference form", res, tol + floor,
               f"f64 true residual on {n_check} rows; CG tol + f32 rounding "
               f"floor {floor:.2e}", dt,
               f"{extra} | CG iterations {int(info[0])}")
        return a

    x1, y1 = jax.device_put(xf, devs[0]), jax.device_put(yf, devs[0])
    one = jax.jit(lambda v: gramian_matvec(k, x1, x1, v, "iso", 512) + noise * v)
    out1, dt = timed(one, y1)
    print(f"[phase 4x] one-card MVM n={n} d=2 on device {devs[0].id}: {dt:.3f} s",
          flush=True)

    mesh2 = Mesh(np.array(devs).reshape(2, 2), ("rows", "cols"))
    xr = jax.device_put(xf, NamedSharding(mesh2, P("rows", None)))
    xc = jax.device_put(xf, NamedSharding(mesh2, P("cols", None)))
    placed2 = sorted({s.device.id for s in xr.addressable_shards})
    if placed2 != sorted(d.id for d in devs):
        raise SmokeFailure(f"2 x 2 mesh shards sit on devices {placed2}")
    mv2 = jax.jit(lambda v: sharded_gramian_matvec_2d(k, xr, xc, v, "iso", mesh2)
                  + noise * v)
    a2 = solve("sharded_gramian_matvec_2d 2 x 2 mesh", mv2, yf, placed2, out1)

    mesh1 = Mesh(np.array(devs), ("data",))
    G = ShardedGramian(k, xf, mesh=mesh1)
    placed = sorted({s.device.id for s in G.x.addressable_shards})
    if placed != sorted(d.id for d in devs):
        raise SmokeFailure(f"1-D mesh shards sit on devices {placed}")
    mv1 = jax.jit(lambda v: G._matvec(v) + noise * v)
    a1d = solve(f"ShardedGramian 1-D mesh of {len(devs)}", mv1, yf, placed, out1)

    a1 = solve("one card", one, y1, [devs[0].id])
    # both solutions answer (K + noise I) a = y to a residual below tol |y|,
    # so |a - a1| <= |(K + noise I)^-1| 2 tol |y| <= 2 tol |y| / noise
    bound = 2 * tol * float(np.linalg.norm(y)) / noise / float(np.linalg.norm(a1))
    for name, a in (("sharded_gramian_matvec_2d 2 x 2 mesh", a2),
                    (f"ShardedGramian 1-D mesh of {len(devs)}", a1d)):
        report("4x", f"{name} solution vs the one-card solution, {what}",
               "f32 difference form", rel_l2(a, a1), bound,
               "two solutions with residual <= tol |y|: 2 tol |y| / (noise |a1|)",
               0.0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded solve and its reference")
    args = ap.parse_args(argv)

    from cfjax.utils.cache import enable_compile_cache, use_gpu_compile_flags

    use_gpu_compile_flags()
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.four:
        device = phase_device(expect_count=4)
        phase_four()
    else:
        device = phase_device()
        phase_gp()
        phase_logml()
        phase_headline()
        phase_expansion()
        phase_gradient()
        phase_structured()
        phase_card_tests()
        phase_kernels()
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
