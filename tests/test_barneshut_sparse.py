"""Barnes-Hut + sparsification tests.

Reference patterns: theta-sweep accuracy curves with 4 weight-vector
classes and exactness at theta=0 (test/barneshut.jl:10-47, 75-135);
sparsification nnz/accuracy checks (README.md:374-396)."""

import jax.numpy as jnp
import numpy as np
import pytest

from cfjax.barneshut import BarnesHutFactorization, build_tree
from cfjax.kernels import EQ, Cauchy, Exp, Lengthscale, MaternP
from cfjax.operators.sparse_op import decay_radius, sparse_gramian
from cfjax.utils.testing import pairwise


def test_tree_build(rng):
    y = rng.standard_normal((100, 2))
    t = build_tree(y, leafsize=8)
    assert t.points.shape[0] == t.n_leaves * t.leafsize
    # every original point appears exactly once among the first-m inverse perm
    assert len(np.unique(t.perm)) == t.points.shape[0]
    # radii cover their slices
    P = t.points.shape[0]
    for l in [0, t.levels]:
        nl = 2**l
        pts = np.asarray(t.points).reshape(nl, P // nl, -1)
        c = np.asarray(t.centers[l])
        r = np.asarray(t.radii[l])
        dist = np.sqrt(((pts - c[:, None, :]) ** 2).sum(-1)).max(1)
        assert np.all(dist <= r + 1e-12)


def test_tree_build_device_path(rng):
    """The jitted device build (used on accelerators) must produce a
    valid tree: a true permutation, covering radii at every level, and
    host mirrors that match the device arrays (they come back through
    one packed bitcast transfer)."""
    y = rng.standard_normal((5000, 3)).astype(np.float32)
    t = build_tree(y, leafsize=16, method="device")
    P = t.points_np.shape[0]
    assert sorted(t.perm.tolist()) == list(range(P))
    assert t.perm.dtype == np.int32
    np.testing.assert_allclose(np.asarray(t.points), t.points_np, rtol=0)
    for l in range(t.levels + 1):
        nl = 2**l
        pts = t.points_np.reshape(nl, P // nl, -1)
        c, r = t.centers_np[l], t.radii_np[l]
        dist = np.sqrt(((pts - c[:, None, :]) ** 2).sum(-1)).max(1)
        assert np.all(dist <= r + 1e-5)
        np.testing.assert_allclose(np.asarray(t.centers[l]), c, rtol=0)
        np.testing.assert_allclose(np.asarray(t.radii[l]), r, rtol=0)
    # padded slots replicate the last original point
    assert np.all(t.perm < 5000) or np.all(
        y[-1] == t.points_np[np.nonzero(t.perm >= 5000)[0][0]])


@pytest.mark.gpu
def test_tree_build_auto_takes_device_path_on_card(gpu, rng):
    """On the GPU, build_tree's auto method picks the device Hilbert build
    (mirrors stay on the card until first touched) and the tree it
    builds there is valid."""
    y = jnp.asarray(rng.uniform(0, 10, (1 << 15, 2)), dtype=jnp.float32)
    t = build_tree(y, leafsize=16)
    assert t._packed is not None and t._perm is None   # device build, lazy mirrors
    P = t.points_np.shape[0]
    assert sorted(t.perm.tolist()) == list(range(P))
    for l in range(t.levels + 1):
        nl = 2**l
        pts = t.points_np.reshape(nl, P // nl, -1)
        c, r = t.centers_np[l], t.radii_np[l]
        dist = np.sqrt(((pts - c[:, None, :]) ** 2).sum(-1)).max(1)
        assert np.all(dist <= r + 1e-4)


@pytest.mark.parametrize("wclass", ["ones", "rand", "signed", "randn"])
def test_bh_theta_sweep(rng, wclass):
    n, d = 400, 2
    x = jnp.asarray(rng.standard_normal((n, d)))
    k = EQ()
    K = np.asarray(pairwise(k, x, x))
    w = {
        "ones": np.ones(n),
        "rand": rng.uniform(0, 1, n),
        "signed": np.sign(rng.standard_normal(n)),
        "randn": rng.standard_normal(n),
    }[wclass]
    exact = K @ w
    errs = []
    for theta in [0.0, 0.25, 0.5, 1.0]:
        F = BarnesHutFactorization(k, x, theta=theta, leafsize=16)
        b = np.asarray(F @ jnp.asarray(w))
        err = np.linalg.norm(b - exact) / np.linalg.norm(exact)
        errs.append(err)
    # exact at theta = 0 (never accept -> all dense leaves)
    assert errs[0] < 1e-10, errs
    # error grows (weakly) with theta and stays small at theta=1/4
    assert errs[1] < 2e-2, errs
    assert errs[1] <= errs[3] + 1e-12 or errs[3] < 1e-10, errs


def test_bh_solve(rng):
    n, d = 300, 2
    x = jnp.asarray(rng.standard_normal((n, d)))
    k = Lengthscale(EQ(), 0.5)
    F = BarnesHutFactorization(k, x, theta=0.0)  # exact MVM
    K = np.asarray(pairwise(k, x, x)) + 0.1 * np.eye(n)
    b = rng.standard_normal(n)
    Fd = F.add_diagonal(0.1)
    xs = Fd.solve(jnp.asarray(b), tol=1e-12, maxiter=1000)
    np.testing.assert_allclose(np.asarray(xs), np.linalg.solve(K, b), rtol=1e-6, atol=1e-8)


def test_decay_radius():
    for k in [EQ(), Exp(), Cauchy(), MaternP(2), Lengthscale(EQ(), 2.0)]:
        r = decay_radius(k, 1e-6)
        assert r is not None
        val = float(k.profile(jnp.asarray(r * r)))
        assert val <= 1.2e-6, (type(k).__name__, val)
        # radius is tight-ish: value at 0.8 r above tol
        assert float(k.profile(jnp.asarray((0.8 * r) ** 2))) > 1e-6


def test_sparse_gramian(rng):
    n, d = 500, 3
    x = jnp.asarray(rng.standard_normal((n, d)) * 3)
    k = Lengthscale(EQ(), 0.3)
    S, ratio = sparse_gramian(k, x, tol=1e-8, block=128)
    assert ratio < 0.2
    K = np.asarray(pairwise(k, x, x))
    a = rng.standard_normal(n)
    approx = np.asarray(S @ jnp.asarray(a))
    err = np.linalg.norm(approx - K @ a) / np.linalg.norm(K @ a)
    assert err < 1e-6, err


def test_tile_ell_small_m(rng):
    """m <= 128 => single column tile (nt == 1): the slab MVM gathers
    from a (1, 128) operand and must still match the dense matrix."""
    from cfjax.operators.tile_ell import _tile_ell_matvec_impl

    n, m, d = 200, 100, 3
    x = jnp.asarray(rng.standard_normal((n, d)))
    y = jnp.asarray(rng.standard_normal((m, d)))
    k = Lengthscale(EQ(), 0.8)
    S, _ = sparse_gramian(k, x, y, tol=1e-4, block=128, format="tile")
    assert S.nt == 1
    a = jnp.asarray(rng.standard_normal(m))
    go = tuple(g[2] for g in S.groups)
    gv = tuple(g[3] for g in S.groups)
    crops = tuple(g[1] - g[0] for g in S.groups)
    out = _tile_ell_matvec_impl(go, gv, S.perm, a, S.nt, crops)[:n]
    expect = np.asarray(S.todense()) @ np.asarray(a)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-7)


def test_tile_ell_matrix_rhs(rng):
    """TileELL matvec accepts (m, r) matrix RHS (ADVICE.md round 1)."""
    n, d = 300, 3
    x = jnp.asarray(rng.standard_normal((n, d)) * 2)
    k = Lengthscale(EQ(), 0.5)
    S, _ = sparse_gramian(k, x, tol=1e-6, block=128, format="tile")
    A = jnp.asarray(rng.standard_normal((n, 4)))
    out = S @ A
    expect = np.asarray(S.todense()) @ np.asarray(A)
    assert out.shape == (n, 4)
    np.testing.assert_allclose(np.asarray(out), expect, rtol=1e-5, atol=1e-6)


def test_tree_sparsification_matches_scan(rng):
    # ball-tree leaf-pair pruned range search (reference src/sparse.jl:42-54)
    # must produce the identical sparse pattern + values as the dense scan
    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators.sparse_op import sparse_gramian

    n = 4096
    x = jnp.asarray(rng.standard_normal((n, 2)))
    k = Lengthscale(EQ(), 0.05)
    S_tree, r_tree = sparse_gramian(k, x, tol=1e-6, method="tree", format="ell")
    S_scan, r_scan = sparse_gramian(k, x, tol=1e-6, method="scan", format="ell")
    assert r_tree == r_scan
    a = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(S_tree @ a), np.asarray(S_scan @ a), rtol=1e-12, atol=1e-14
    )


def test_tree_sparsification_cross_and_tile(rng):
    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators.sparse_op import sparse_gramian

    n, m = 1500, 900  # uneven, cross gramian
    x = jnp.asarray(rng.standard_normal((n, 2)))
    y = jnp.asarray(rng.standard_normal((m, 2)))
    k = Lengthscale(EQ(), 0.1)
    S_tree, _ = sparse_gramian(k, x, y, tol=1e-6, method="tree", format="tile")
    S_scan, _ = sparse_gramian(k, x, y, tol=1e-6, method="scan", format="ell")
    a = jnp.asarray(rng.standard_normal(m))
    np.testing.assert_allclose(
        np.asarray(S_tree @ a), np.asarray(S_scan @ a), rtol=1e-10, atol=1e-12
    )


def test_tree_sparsification_high_d_falls_back(rng):
    # in high-d the leaf test prunes nothing: auto must take the scan
    # path, explicit tree must raise
    from cfjax.kernels import EQ
    from cfjax.operators.sparse_op import sparse_gramian

    n, d = 1024, 16
    x = jnp.asarray(rng.standard_normal((n, d)))
    S, ratio = sparse_gramian(EQ(), x, tol=1e-3, method="auto", format="ell")
    assert ratio > 0
    with pytest.raises(ValueError):
        sparse_gramian(EQ(), x, tol=1e-3, method="tree", format="ell")


def test_tree_sparsification_lazy_operator(rng):
    # lazy leaf-tile block-sparse operator: zero materialization, exact
    # same entries as the scan within the decay radius
    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators.sparse_op import TreeSparseOperator, sparse_gramian

    n = 4096
    x = jnp.asarray(rng.standard_normal((n, 2)))
    k = Lengthscale(EQ(), 0.05)
    S_lazy, r1 = sparse_gramian(k, x, tol=1e-6, format="lazy")
    assert isinstance(S_lazy, TreeSparseOperator)
    S_scan, r2 = sparse_gramian(k, x, tol=1e-6, method="scan", format="ell")
    assert r1 == r2
    a = jnp.asarray(rng.standard_normal(n))
    np.testing.assert_allclose(
        np.asarray(S_lazy @ a), np.asarray(S_scan @ a), rtol=1e-12, atol=1e-13
    )


def test_barneshut_quadrupole_improves_accuracy(rng):
    # order=2 far field (node second moments) must beat the dipole at the
    # same theta on signed weights (reference PowersArray higher-order
    # scaffold, src/taylor.jl:62-85)
    from cfjax.kernels import EQ
    from cfjax.barneshut import BarnesHutFactorization
    from cfjax.utils.testing import pairwise

    n = 1200
    x = jnp.asarray(rng.standard_normal((n, 2)))
    w = jnp.asarray(rng.standard_normal(n))  # signed
    exact = np.asarray(pairwise(EQ(), x, x)) @ np.asarray(w)
    errs = {}
    for order in (1, 2):
        F = BarnesHutFactorization(EQ(), x, theta=0.6, group_size=32,
                                   order=order)
        b = np.asarray(F @ w)
        errs[order] = np.linalg.norm(b - exact) / np.linalg.norm(exact)
    assert errs[2] < 0.7 * errs[1]
    assert errs[2] < 5e-2


def test_sparse_operators_are_linear_operators(rng):
    """Sparsify-then-solve round-trips (VERDICT r3 #7): the ELL and
    TileELL operators are full LinearOperators — (S + sigma I).solve,
    .T, diagonal all compose (reference src/sparse.jl -> SparseMatrixCSC
    supports the whole \\ surface)."""
    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators.sparse_op import EllSparseOperator, sparse_gramian
    from cfjax.operators.tile_ell import TileEllOperator

    n = 600
    x = jnp.asarray(rng.standard_normal((n, 2)), dtype=jnp.float64)
    k = Lengthscale(EQ(), 0.3)
    for fmt, cls in [("ell", EllSparseOperator), ("tile", TileEllOperator)]:
        S, ratio = sparse_gramian(k, x, tol=1e-8, format=fmt, method="scan")
        assert isinstance(S, cls)
        assert S.is_symmetric
        a = jnp.asarray(rng.standard_normal(n), dtype=S.dtype)
        # symmetric storage: S.T @ a == S @ a
        assert np.allclose(np.asarray(S.T @ a), np.asarray(S @ a), rtol=1e-5, atol=1e-6)
        op = S.add_diagonal(0.5)
        b = op @ a
        got = op.solve(b, tol=1e-10, maxiter=500)
        assert np.allclose(np.asarray(got), np.asarray(a), atol=1e-4)
    # non-symmetric (x != y) rectangular: CGNR least squares via rmatvec
    y = jnp.asarray(rng.standard_normal((400, 2)), dtype=jnp.float64)
    S, _ = sparse_gramian(k, x, y, tol=1e-8, format="ell", method="scan")
    assert not S.is_symmetric and S.shape == (600, 400)
    Sd = np.asarray(S.todense())
    a = jnp.asarray(rng.standard_normal(400), dtype=S.dtype)
    # rmatvec oracle
    v = jnp.asarray(rng.standard_normal(600), dtype=S.dtype)
    assert np.allclose(np.asarray(S.T @ v), Sd.T @ np.asarray(v), atol=1e-8)


def test_tile_ell_rmatvec_nonsymmetric(rng):
    from cfjax.kernels import EQ, Lengthscale
    from cfjax.operators.sparse_op import sparse_gramian

    x = jnp.asarray(rng.standard_normal((300, 2)), dtype=jnp.float64)
    y = jnp.asarray(rng.standard_normal((280, 2)), dtype=jnp.float64)
    k = Lengthscale(EQ(), 0.3)
    S, _ = sparse_gramian(k, x, y, tol=1e-8, format="tile", method="scan")
    assert not S.is_symmetric
    Sd = np.asarray(S.todense())
    v = jnp.asarray(rng.standard_normal(300), dtype=jnp.float32)
    assert np.allclose(np.asarray(S.T @ v), Sd.T @ np.asarray(v), atol=1e-5)


def test_sparse_gramian_width_tiers(rng):
    """Skewed neighbor counts (one dense cluster + a diffuse cloud) must
    exercise several width tiers of the count-sorted TileELL build — the
    single global ELL width this replaced inflated one dense row's count
    onto every row (VERDICT r3 #2)."""
    from cfjax.operators.sparse_op import _width_tiers

    n, d = 4096, 3
    cluster = rng.standard_normal((512, d)) * 0.05          # dense blob
    cloud = rng.standard_normal((n - 512, d)) * 4.0          # diffuse
    x = jnp.asarray(np.concatenate([cluster, cloud]), dtype=jnp.float64)
    k = Lengthscale(EQ(), 0.3)
    S, ratio = sparse_gramian(k, x, tol=1e-8, block=256, format="tile")
    counts = np.asarray((np.asarray(pairwise(k, x, x)) >= 1e-8).sum(1))
    tiers = _width_tiers(np.sort(counts)[::-1], n, align=1024)
    assert len(tiers) >= 2, "cluster/cloud skew should produce >= 2 tiers"
    K = np.asarray(pairwise(k, x, x))
    a = rng.standard_normal(n)
    approx = np.asarray(S @ jnp.asarray(a))
    err = np.linalg.norm(approx - K @ a) / np.linalg.norm(K @ a)
    assert err < 1e-6, err
    assert S.nnz == counts.sum()


def test_bh_interaction_plan_partitions_sources(rng):
    """The precomputed interaction plan must COVER every source exactly
    once per target group: the leaf-descendant sets of all far nodes
    (across levels) plus the still-open leaves partition the full leaf
    set — no source double-counted, none dropped (the invariant that
    makes the planned matvec equal the dynamic traversal)."""
    n = 700
    x = jnp.asarray(rng.standard_normal((n, 2)), dtype=jnp.float32)
    F = BarnesHutFactorization(EQ(), x, theta=0.4)
    t = F.tree
    nleaf = 2**t.levels
    for (xg_b, gc_b, gr_b, rows_b, _), (flv, fidx, lidx) in zip(
            F.buckets, F.plans):
        ng = np.asarray(gc_b).shape[0]
        for g in range(ng):
            covered = np.zeros(nleaf, dtype=int)
            for li, l in enumerate(flv):
                for node in fidx[li][g]:
                    if node < 0:
                        continue
                    span = 2 ** (t.levels - l)
                    covered[node * span:(node + 1) * span] += 1
            for leaf in lidx[g]:
                if leaf >= 0:
                    covered[leaf] += 1
            assert (covered == 1).all(), (
                f"group {g}: min {covered.min()}, max {covered.max()}")


def test_bh_fixed_centers_linear(rng):
    """matvec_linear must be exactly linear in v (CG/MINRES contract) and
    accurate; the default |w|-com matvec is only approximately linear."""
    n = 2048
    x = jnp.asarray(rng.uniform(0, 1, (n, 2)))
    F = BarnesHutFactorization(EQ(), x, theta=0.4)
    a = jnp.asarray(rng.standard_normal(n))
    b = jnp.asarray(rng.standard_normal(n))
    lhs = F.matvec_linear(2.0 * a - 3.0 * b)
    rhs = 2.0 * F.matvec_linear(a) - 3.0 * F.matvec_linear(b)
    np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                               rtol=1e-10, atol=1e-10)
    K = np.asarray(pairwise(EQ(), x, x))
    err = np.linalg.norm(np.asarray(F.matvec_linear(a)) - K @ np.asarray(a))
    err /= np.linalg.norm(K @ np.asarray(a))
    assert err < 0.05, err


def test_bh_cg_gp_solve_roundtrip(rng):
    """Config-5 pipeline at test scale: (K_bh + sigma^2 I) alpha = y via
    CG on the linear BH matvec, checked against the dense solve."""
    from cfjax.operators.solvers import cg

    n = 2048
    x = jnp.asarray(rng.uniform(0, 1, (n, 2)))
    y = jnp.sin(3.0 * x[:, 0]) + 0.05 * jnp.asarray(rng.standard_normal(n))
    F = BarnesHutFactorization(EQ(), x, theta=0.2, order=2)
    sigma2 = 0.1
    alpha, (iters, res) = cg(lambda v: F.matvec_linear(v) + sigma2 * v, y,
                             tol=1e-6, maxiter=300)
    K = np.asarray(pairwise(EQ(), x, x)) + sigma2 * np.eye(n)
    alpha_exact = np.linalg.solve(K, np.asarray(y))
    err = np.linalg.norm(np.asarray(alpha) - alpha_exact)
    err /= np.linalg.norm(alpha_exact)
    assert err < 0.05, err


def test_barneshut_arbitrary_order_far_field(rng):
    # order=p far field for p >= 3 (tensor node moments, the real
    # algorithm behind the reference's unused PowersArray scaffold,
    # src/taylor.jl:62-85): error strictly decreases with order at fixed
    # theta on signed weights, and order 3/4 agree with order 2's far
    # field structure (same tree, same frontier) while being tighter
    from cfjax.kernels import EQ
    from cfjax.barneshut import BarnesHutFactorization
    from cfjax.utils.testing import pairwise

    n = 1200
    x = jnp.asarray(rng.standard_normal((n, 2)))
    w = jnp.asarray(rng.standard_normal(n))  # signed
    exact = np.asarray(pairwise(EQ(), x, x)) @ np.asarray(w)
    errs = {}
    # theta <= 0.4: inside the Taylor-convergent regime (at wider opening
    # angles the Gaussian's series about far centers is pre-convergent and
    # raising the order buys nothing — that is physics, not a bug)
    for order in (1, 2, 3, 4):
        F = BarnesHutFactorization(EQ(), x, theta=0.3, group_size=32,
                                   order=order)
        b = np.asarray(F @ w)
        errs[order] = np.linalg.norm(b - exact) / np.linalg.norm(exact)
    assert errs[3] < 0.7 * errs[2]
    assert errs[4] < 0.7 * errs[3]
    assert errs[4] < 2e-3


def test_barneshut_high_order_linear_operator(rng):
    # fixed_centers keeps EVERY moment linear in w at any order: the
    # order-4 matvec_linear must be additive/homogeneous to fp precision
    from cfjax.kernels import EQ
    from cfjax.barneshut import BarnesHutFactorization

    n = 800
    x = jnp.asarray(rng.standard_normal((n, 2)))
    F = BarnesHutFactorization(EQ(), x, theta=0.5, group_size=32, order=4)
    u = jnp.asarray(rng.standard_normal(n))
    v = jnp.asarray(rng.standard_normal(n))
    mv = lambda t: np.asarray(F._matvec(t, fixed_centers=True))
    lhs = mv(2.0 * u + 3.0 * v)
    rhs = 2.0 * mv(u) + 3.0 * mv(v)
    np.testing.assert_allclose(lhs, rhs, rtol=5e-5, atol=5e-5)
