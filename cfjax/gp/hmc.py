"""HMC + NUTS over GP hyperparameters (north-star demo layer, SURVEY.md
§7.7, BASELINE.json config 5).

Plain leapfrog HMC with dual-averaging step-size adaptation, plus a
recursion-free NUTS (dynamic doubling, multinomial sampling) — both
jit-compiled lax control flow. The log-density gradient flows through
the whole lazy-operator stack (gramian -> Cholesky/CG/SLQ) by JAX AD.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax


def hmc_sample(
    logdensity,
    theta0,
    key,
    num_samples: int = 500,
    num_warmup: int = 200,
    num_leapfrog: int = 16,
    init_step: float = 0.1,
    target_accept: float = 0.8,
):
    """Sample from logdensity(theta) (theta: flat vector). Returns
    (samples (num_samples, dim), accept_rate)."""
    theta0 = jnp.asarray(theta0)
    dim = theta0.shape[0]
    grad_ld = jax.grad(logdensity)

    def leapfrog(theta, p, eps):
        p = p + 0.5 * eps * grad_ld(theta)

        def body(_, carry):
            th, pp = carry
            th = th + eps * pp
            pp = pp + eps * grad_ld(th)
            return th, pp

        theta, p = lax.fori_loop(0, num_leapfrog - 1, body, (theta + 0.0, p))
        theta = theta + eps * p
        p = p + 0.5 * eps * grad_ld(theta)
        return theta, p

    def kernel(carry, key_i):
        theta, eps, h_bar, log_eps_bar, i = carry
        k1, k2 = jax.random.split(key_i)
        p0 = jax.random.normal(k1, (dim,))
        ld0 = logdensity(theta)
        theta_new, p_new = leapfrog(theta, p0, eps)
        ld1 = logdensity(theta_new)
        log_accept = (ld1 - 0.5 * jnp.sum(p_new**2)) - (ld0 - 0.5 * jnp.sum(p0**2))
        log_accept = jnp.where(jnp.isfinite(log_accept), log_accept, -jnp.inf)
        accept_prob = jnp.minimum(1.0, jnp.exp(log_accept))
        u = jax.random.uniform(k2)
        accept = u < accept_prob
        theta = jnp.where(accept, theta_new, theta)

        # dual averaging during warmup
        in_warmup = i < num_warmup
        t = i + 1.0
        kappa, gamma, t0, mu = 0.75, 0.05, 10.0, jnp.log(10.0 * init_step)
        h_bar = jnp.where(
            in_warmup,
            (1 - 1 / (t + t0)) * h_bar + (target_accept - accept_prob) / (t + t0),
            h_bar,
        )
        log_eps = mu - jnp.sqrt(t) / gamma * h_bar
        log_eps_bar = jnp.where(
            in_warmup,
            t ** (-kappa) * log_eps + (1 - t ** (-kappa)) * log_eps_bar,
            log_eps_bar,
        )
        eps = jnp.where(in_warmup, jnp.exp(log_eps), jnp.exp(log_eps_bar))
        return (theta, eps, h_bar, log_eps_bar, i + 1), (theta, accept_prob)

    total = num_warmup + num_samples
    keys = jax.random.split(key, total)
    init = (theta0, jnp.asarray(init_step), jnp.zeros(()), jnp.log(init_step), 0.0)
    (_, _, _, _, _), (thetas, aprobs) = lax.scan(kernel, init, keys)
    return thetas[num_warmup:], jnp.mean(aprobs[num_warmup:])


def _dual_averaging_update(h_bar, log_eps_bar, accept_stat, i, init_step,
                           target_accept):
    """Nesterov dual averaging (one step), Stan's parameterization."""
    t = i + 1.0
    kappa, gamma, t0 = 0.75, 0.05, 10.0
    mu = jnp.log(10.0 * init_step)
    h_bar = (1 - 1 / (t + t0)) * h_bar + (target_accept - accept_stat) / (t + t0)
    log_eps = mu - jnp.sqrt(t) / gamma * h_bar
    log_eps_bar = t ** (-kappa) * log_eps + (1 - t ** (-kappa)) * log_eps_bar
    return h_bar, log_eps_bar, log_eps


def nuts_sample(
    logdensity,
    theta0,
    key,
    num_samples: int = 500,
    num_warmup: int = 200,
    max_tree_depth: int = 8,
    init_step: float = 0.1,
    target_accept: float = 0.8,
    max_delta_energy: float = 1000.0,
):
    """No-U-Turn sampler (dynamic doubling, MULTINOMIAL state sampling,
    dual-averaging step adaptation). Recursion-free: the doubling is a
    lax.while_loop and each subtree is built leaf-by-leaf with the
    binary-checkpoint U-turn test (a subtree of 2^j leaves needs only
    max_tree_depth stored states: leaf n is compared against the stored
    left endpoints of every power-of-two block that CLOSES at n).

    Returns (samples (num_samples, dim), mean_accept_stat). theta is a
    flat vector; logdensity must be jax-differentiable."""
    theta0 = jnp.asarray(theta0, dtype=float)
    dim = theta0.shape[0]
    vg = jax.value_and_grad(logdensity)
    D = max_tree_depth

    def leapfrog(theta, p, g, eps):
        p_half = p + 0.5 * eps * g
        theta_new = theta + eps * p_half
        ld, g_new = vg(theta_new)
        p_new = p_half + 0.5 * eps * g_new
        return theta_new, p_new, g_new, ld

    def is_turning(th_minus, p_minus, th_plus, p_plus):
        dth = th_plus - th_minus
        return (jnp.dot(dth, p_minus) <= 0.0) | (jnp.dot(dth, p_plus) <= 0.0)

    def build_subtree(z_edge, depth, direction, eps, H0, key):
        """Grow 2^depth leaves from z_edge = (theta, p, grad) in
        `direction`. Returns (z_new_edge, proposal, logw, turning,
        diverging, alpha_sum, n_alpha). Proposal is multinomial within
        the subtree (Gumbel-max streaming)."""
        theta_e, p_e, g_e = z_edge
        n_leaf = 2 ** depth

        ck_th = jnp.zeros((D + 1, dim))
        ck_p = jnp.zeros((D + 1, dim))

        def leaf_body(i, carry):
            (theta, p, g, ck_th, ck_p, prop, best_key, logw, turning,
             diverging, alpha_sum, key) = carry
            key, ku = jax.random.split(key)
            theta, p, g, ld = leapfrog(theta, p, g, direction * eps)
            H = -ld + 0.5 * jnp.sum(p ** 2)
            dE = H - H0
            diverging = diverging | (dE > max_delta_energy) | ~jnp.isfinite(dE)
            lw = jnp.where(jnp.isfinite(dE), -dE, -jnp.inf)
            alpha = jnp.minimum(1.0, jnp.exp(-dE))
            alpha_sum = alpha_sum + jnp.where(jnp.isfinite(alpha), alpha, 0.0)
            # streaming multinomial draw via Gumbel-max
            gumbel = -jnp.log(-jnp.log(
                jax.random.uniform(ku, (), minval=1e-12, maxval=1.0)))
            score = lw + gumbel
            take = score > best_key
            prop = jnp.where(take, theta, prop)
            best_key = jnp.maximum(best_key, score)
            logw = jnp.logaddexp(logw, lw)

            # binary checkpointing: even leaf -> store; odd leaf -> test
            # U-turn against the left endpoint of every closing block
            even = (i % 2) == 0
            pc = _popcount(i)
            ck_th = jnp.where(even, ck_th.at[pc].set(theta), ck_th)
            ck_p = jnp.where(even, ck_p.at[pc].set(p), ck_p)
            idx_max = _popcount(i >> 1)
            n_close = _trailing_ones(i)
            idx_min = idx_max - n_close + 1

            def check(jj, t):
                in_range = (jj >= idx_min) & (jj <= idx_max)
                # momenta are TRAJECTORY momenta (leapfrog integrates with
                # direction*eps), so the U-turn test needs the
                # trajectory-order difference th_right - th_left: the
                # checkpoint is trajectory-left of the current leaf when
                # direction=+1 and trajectory-right when direction=-1
                dth = direction * (theta - ck_th[jj])
                turn = (jnp.dot(dth, ck_p[jj]) <= 0.0) | (
                    jnp.dot(dth, p) <= 0.0)
                return t | (in_range & turn)

            turn_i = lax.fori_loop(0, D + 1, check, False)
            turning = turning | (~even & turn_i)
            return (theta, p, g, ck_th, ck_p, prop, best_key, logw,
                    turning, diverging, alpha_sum, key)

        init = (theta_e, p_e, g_e, ck_th, ck_p, theta_e,
                -jnp.inf, -jnp.inf, False, False, 0.0, key)

        def cond(state):
            i, carry = state
            return (i < n_leaf) & ~carry[8] & ~carry[9]

        def body(state):
            i, carry = state
            return i + 1, leaf_body(i, carry)

        n_done, out = lax.while_loop(cond, body, (0, init))
        (theta, p, g, _, _, prop, _, logw, turning, diverging,
         alpha_sum, _) = out
        return ((theta, p, g), prop, logw, turning, diverging, alpha_sum,
                jnp.asarray(n_done, float))

    def transition(theta, eps, key):
        kp, kt = jax.random.split(key)
        p0 = jax.random.normal(kp, (dim,))
        ld0, g0 = vg(theta)
        H0 = -ld0 + 0.5 * jnp.sum(p0 ** 2)
        # both edges carry TRAJECTORY momenta; the minus edge is grown by
        # integrating with -eps (which leaves momenta in trajectory frame)
        z_minus = (theta, p0, g0)
        z_plus = (theta, p0, g0)
        state0 = dict(
            z_minus=z_minus, z_plus=z_plus, prop=theta, logw=jnp.zeros(()),
            turning=False, diverging=False, depth=0, alpha_sum=0.0,
            n_alpha=0.0, key=kt)

        def cond(s):
            return ((s["depth"] < D) & ~s["turning"] & ~s["diverging"])

        def body(s):
            key, kd, ks, kc = jax.random.split(s["key"], 4)
            direction = jnp.where(jax.random.bernoulli(kd), 1.0, -1.0)
            # edge to grow: plus edge if direction > 0 else minus edge
            th_e = jnp.where(direction > 0, s["z_plus"][0], s["z_minus"][0])
            p_e = jnp.where(direction > 0, s["z_plus"][1], s["z_minus"][1])
            g_e = jnp.where(direction > 0, s["z_plus"][2], s["z_minus"][2])
            (z_new, prop_sub, logw_sub, turn_sub, div_sub, a_sum,
             n_a) = build_subtree((th_e, p_e, g_e), s["depth"], direction,
                                  eps, H0, ks)
            ok = ~turn_sub & ~div_sub
            # biased progressive sampling: take the new subtree's proposal
            # with prob min(1, w_sub / w_old)
            accept_new = jnp.log(jax.random.uniform(kc, (), minval=1e-38)
                                 ) < (logw_sub - s["logw"])
            prop = jnp.where(ok & accept_new, prop_sub, s["prop"])
            logw = jnp.where(ok, jnp.logaddexp(s["logw"], logw_sub),
                             s["logw"])
            thn, pn, gn = z_new
            z_plus = jax.tree.map(
                lambda new, old: jnp.where((direction > 0) & ok, new, old),
                (thn, pn, gn), s["z_plus"])
            z_minus = jax.tree.map(
                lambda new, old: jnp.where((direction < 0) & ok, new, old),
                (thn, pn, gn), s["z_minus"])
            whole_turn = is_turning(z_minus[0], z_minus[1],
                                    z_plus[0], z_plus[1])
            return dict(
                z_minus=z_minus, z_plus=z_plus, prop=prop, logw=logw,
                turning=s["turning"] | turn_sub | whole_turn,
                diverging=s["diverging"] | div_sub,
                depth=s["depth"] + 1,
                alpha_sum=s["alpha_sum"] + a_sum,
                n_alpha=s["n_alpha"] + n_a, key=key)

        out = lax.while_loop(cond, body, state0)
        accept_stat = out["alpha_sum"] / jnp.maximum(out["n_alpha"], 1.0)
        return out["prop"], accept_stat

    def kernel(carry, key_i):
        theta, eps, h_bar, log_eps_bar, i = carry
        theta, accept_stat = transition(theta, eps, key_i)
        in_warmup = i < num_warmup
        h_new, leb_new, log_eps = _dual_averaging_update(
            h_bar, log_eps_bar, accept_stat, i, init_step, target_accept)
        h_bar = jnp.where(in_warmup, h_new, h_bar)
        log_eps_bar = jnp.where(in_warmup, leb_new, log_eps_bar)
        eps = jnp.where(in_warmup, jnp.exp(log_eps), jnp.exp(log_eps_bar))
        return (theta, eps, h_bar, log_eps_bar, i + 1.0), (theta, accept_stat)

    total = num_warmup + num_samples
    keys = jax.random.split(key, total)
    init = (theta0, jnp.asarray(init_step, float), jnp.zeros(()),
            jnp.log(init_step), 0.0)
    _, (thetas, astats) = lax.scan(kernel, init, keys)
    return thetas[num_warmup:], jnp.mean(astats[num_warmup:])


def _popcount(i):
    i = jnp.asarray(i, jnp.int32)
    c = jnp.zeros((), jnp.int32)
    for s in range(31):
        c = c + ((i >> s) & 1)
    return c


def _trailing_ones(i):
    i = jnp.asarray(i, jnp.int32)
    # number of contiguous low-order 1 bits
    done = jnp.zeros((), bool)
    c = jnp.zeros((), jnp.int32)
    for s in range(31):
        bit = ((i >> s) & 1) == 1
        take = bit & ~done
        c = c + take.astype(jnp.int32)
        done = done | ~bit
    return c


def nuts_sample_host(
    logdensity,
    theta0,
    key,
    num_samples: int = 100,
    num_warmup: int = 50,
    max_tree_depth: int = 6,
    init_step: float = 0.1,
    target_accept: float = 0.8,
    max_delta_energy: float = 1000.0,
    verbose: bool = False,
):
    """Host-loop NUTS: the same algorithm as `nuts_sample` (dynamic
    doubling, multinomial state sampling, dual-averaging warmup) but the
    tree is built by HOST recursion, each leapfrog dispatching
    `value_and_grad(logdensity)` as its own device program.

    Use this when ONE likelihood evaluation is seconds-to-minutes of
    device time (e.g. the n >= 2^20 SLQ logML): the jitted `nuts_sample`
    fuses the whole chain into a single XLA program, which would be a
    multi-hour device execution that can neither be interrupted nor
    report progress; here every device program stays at single-evaluation
    granularity, with only O(tree depth) host-device transfers of
    2-vectors on top. Returns (samples (num_samples, dim),
    mean_accept_stat) like `nuts_sample`."""
    import numpy as np

    theta0 = np.asarray(theta0, dtype=float)
    dim = theta0.shape[0]
    vg_dev = jax.value_and_grad(logdensity)

    def vg(th):
        ld, g = vg_dev(jnp.asarray(th))
        return float(ld), np.asarray(g, dtype=float)

    rng = np.random.default_rng(
        int(jax.random.randint(key, (), 0, 2**31 - 1)))

    def leapfrog(th, p, g, eps):
        ph = p + 0.5 * eps * g
        th2 = th + eps * ph
        ld2, g2 = vg(th2)
        p2 = ph + 0.5 * eps * g2
        return th2, p2, g2, ld2

    def build(th, p, g, depth, v, eps, H0):
        """Subtree of 2^depth leaves from (th, p, g) in direction v.
        Returns (minus_state, plus_state, proposal, logw, ok, asum,
        aleaves); states are (th, p, g)."""
        if depth == 0:
            th2, p2, g2, ld2 = leapfrog(th, p, g, v * eps)
            H = ld2 - 0.5 * float(np.sum(p2 * p2))
            div = not np.isfinite(H) or (H0 - H) > max_delta_energy
            a = min(1.0, float(np.exp(min(H - H0, 0.0)))) if np.isfinite(H) else 0.0
            st = (th2, p2, g2)
            return st, st, th2, (H if not div else -np.inf), (not div), a, 1
        m1, p1_, prop1, lw1, ok1, a1, n1 = build(th, p, g, depth - 1, v, eps, H0)
        if not ok1:
            return m1, p1_, prop1, lw1, False, a1, n1
        edge = p1_ if v > 0 else m1
        m2, p2_, prop2, lw2, ok2, a2, n2 = build(
            edge[0], edge[1], edge[2], depth - 1, v, eps, H0)
        minus = m1 if v > 0 else m2
        plus = p2_ if v > 0 else p1_
        lw = np.logaddexp(lw1, lw2)
        prop = prop2 if (np.log(rng.uniform() + 1e-300) < lw2 - lw) else prop1
        dth = plus[0] - minus[0]
        uturn = (np.dot(dth, minus[1]) < 0) or (np.dot(dth, plus[1]) < 0)
        return minus, plus, prop, lw, (ok2 and not uturn), a1 + a2, n1 + n2

    ld0, g0 = vg(theta0)
    th = theta0
    ld, g = ld0, g0
    eps = float(init_step)
    h_bar, log_eps_bar = 0.0, float(np.log(init_step))
    samples = np.empty((num_samples, dim))
    astats = []
    for i in range(num_warmup + num_samples):
        p0 = rng.standard_normal(dim)
        H0 = ld - 0.5 * float(np.sum(p0 * p0))
        minus = plus = (th, p0, g)
        prop, lw = th, H0
        asum, aleaves = 0.0, 0
        for depth in range(max_tree_depth):
            v = 1 if rng.uniform() < 0.5 else -1
            edge = plus if v > 0 else minus
            m2, p2_, prop2, lw2, ok, a2, n2 = build(
                edge[0], edge[1], edge[2], depth, v, eps, H0)
            asum += a2
            aleaves += n2
            if not ok:
                break
            # biased progressive sampling (favors the new subtree)
            if np.log(rng.uniform() + 1e-300) < lw2 - lw:
                prop = prop2
            lw = np.logaddexp(lw, lw2)
            minus = m2 if v < 0 else minus
            plus = p2_ if v > 0 else plus
            dth = plus[0] - minus[0]
            if (np.dot(dth, minus[1]) < 0) or (np.dot(dth, plus[1]) < 0):
                break
        if prop is not th:
            th = prop
            ld, g = vg(th)
        accept_stat = asum / max(aleaves, 1)
        if i < num_warmup:
            h_bar, log_eps_bar, log_eps = _dual_averaging_update(
                h_bar, log_eps_bar, accept_stat, i, init_step, target_accept)
            eps = float(jnp.exp(log_eps))
        else:
            eps = float(jnp.exp(log_eps_bar)) if num_warmup else eps
            samples[i - num_warmup] = th
            astats.append(accept_stat)
        if verbose:
            print(f"  nuts_host step {i + 1}/{num_warmup + num_samples}: "
                  f"eps={eps:.4f} accept_stat={accept_stat:.2f} "
                  f"leaves={aleaves}", flush=True)
    return jnp.asarray(samples), jnp.asarray(np.mean(astats) if astats else 0.0)
