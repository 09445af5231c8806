"""Balanced spatial tree in fixed-depth arrays.

Array-based replacement for the reference's pointer-based BallTree
(NearestNeighbors.jl, used at src/barneshut.jl:25-36): a *complete*
binary tree built by recursive median splits along the widest dimension,
stored as a permutation of the points plus per-level center/radius
arrays. Every node at level l covers a contiguous slice of the permuted
points — so node reductions (weight sums, centers of mass, dipole
moments) are plain reshape-sums on device, and the traversal is a
level-synchronous masked sweep (no recursion, no pointers).
"""

from __future__ import annotations

import dataclasses
import math

import jax.numpy as jnp
import numpy as np


class BalancedTree:
    """Complete balanced tree in fixed arrays. Host mirrors (`perm`,
    `points_np`, `centers_np`, `radii_np`) are LAZY on device builds: the
    packed device buffer is fetched on first access (the transfer is
    ~25 MB at n = 10^6, which consumers that never touch the mirrors —
    Barnes-Hut — should not pay)."""

    def __init__(self, *, points, pad, leafsize, levels, centers, radii,
                 perm=None, perm_dev=None, packed=None,
                 centers_np=None, radii_np=None, points_np=None):
        self.points = points      # (P, d) permuted (padded) device points
        self.pad = pad            # number of padded duplicate points
        self.leafsize = leafsize
        self.levels = levels      # L: internal levels; leaves = 2^L
        self.centers = centers    # per level l: (2^l, d) device centers
        self.radii = radii        # per level l: (2^l,) device radii
        self._perm = perm         # (P,) host permutation into padded points
        self._perm_dev = perm_dev
        self._packed = packed     # int32 device buffer for lazy mirrors
        self._centers_np = centers_np
        self._radii_np = radii_np
        self._points_np = points_np

    @property
    def n_leaves(self):
        return 2 ** self.levels

    def _unpack(self):
        """ONE packed D2H fetch materializes every host mirror."""
        P, d = self.points.shape
        L = self.levels
        if self._packed is None:  # tree built without mirrors (fused BH)
            import jax

            # run eagerly even if a consumer trace is live (the fetch
            # below needs a concrete buffer)
            with jax.ensure_compile_time_eval():
                f = lambda a: jnp.asarray(a, jnp.float32)  # payload is f32
                self._packed = jax.jit(_pack_mirrors)(
                    self._perm_dev, f(self.points),
                    tuple(f(c) for c in self.centers),
                    tuple(f(r) for r in self.radii))
        buf = np.asarray(self._packed)  # int32; float payload bitcast back
        f32 = lambda a: a.view(np.float32)
        o = 0
        self._perm = buf[o:o + P]; o += P
        self._points_np = f32(buf[o:o + P * d]).reshape(P, d); o += P * d
        cs, rs = [], []
        for l in range(L + 1):
            cs.append(f32(buf[o:o + (2**l) * d]).reshape(2**l, d))
            o += (2**l) * d
        for l in range(L + 1):
            rs.append(f32(buf[o:o + 2**l])); o += 2**l
        self._centers_np, self._radii_np = cs, rs
        assert self._perm.min() >= 0 and self._perm.max() < P

    @property
    def perm(self):
        if self._perm is None:
            self._unpack()
        return self._perm

    @property
    def perm_dev(self):
        """Device permutation (no host copy on device builds)."""
        if self._perm_dev is None:
            import jax

            # first use may be inside a jit trace: keep the cache concrete
            with jax.ensure_compile_time_eval():
                self._perm_dev = jnp.asarray(self.perm)
        return self._perm_dev

    @property
    def points_np(self):
        if self._points_np is None:
            self._unpack()
        return self._points_np

    @property
    def centers_np(self):
        if self._centers_np is None:
            self._unpack()
        return self._centers_np

    @property
    def radii_np(self):
        if self._radii_np is None:
            self._unpack()
        return self._radii_np


def build_tree(y, leafsize: int = 16, method: str = "auto") -> BalancedTree:
    """Build the complete balanced tree. Points are padded to 2^L * ls by
    duplicating the last point (padded weights are zero at matvec time,
    so results are exact; only node radii are mildly affected).

    method: "median" — per-level median splits along the widest dimension
    (adaptive boxes, O(n) argpartition per level, host numpy); "morton" —
    one Hilbert-curve sort, equal-count leaves sliced from the curve,
    boxes computed bottom-up (ONE gather + one sort total, slightly
    looser boxes); "device" — the Hilbert build as a single jitted
    device program (quantize → Hilbert transform → argsort → box/radius
    reductions all on device; host mirrors fetched in ONE transfer —
    every host-side pass AND the input device→host copy disappear);
    "auto" — device on an accelerator for d ≤ 4, else morton for big
    low-d inputs, median otherwise."""
    if y.ndim == 1:
        y = y[:, None] if isinstance(y, np.ndarray) else jnp.reshape(y, (-1, 1))
    m, d = y.shape
    L = max(0, math.ceil(math.log2(max(1, m / leafsize))))
    nleaf = 2**L
    ls = math.ceil(m / nleaf)
    P = nleaf * ls
    pad = P - m

    if method == "auto":
        import jax

        on_accelerator = jax.default_backend() != "cpu"
        if on_accelerator and d <= 4 and L > 0 and P >= (1 << 14):
            method = "device"
        else:
            method = "morton" if (P >= (1 << 19) and d <= 8) else "median"
    if method == "device" and d <= 4 and L > 0:
        return _build_tree_device(y, m, d, L, ls, P, pad)

    y = np.asarray(y)
    yp = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)], axis=0) if pad else y
    if method == "morton" and d <= 16 and L > 0:
        return _build_tree_morton(yp, m, d, L, ls, P, pad)

    perm = np.arange(P)
    pts_run = yp.copy()
    centers_np, radii_np = [], []
    # iterative median splits, fully vectorized: at level l all 2^l
    # segments partition at once along their own widest dimension. A
    # median split only needs argpartition (O(n) per level, not a full
    # sort), and each level's min/max pass doubles as that level's
    # bounding-box center — one O(nd) sweep per level total (the
    # reference's BallTree build is O(n log n), src/barneshut.jl:28).
    for l in range(L + 1):
        nl = 1 << l
        seg = P // nl
        pts = pts_run.reshape(nl, seg, d)
        lo = pts.min(axis=1)
        hi = pts.max(axis=1)
        centers_np.append(0.5 * (lo + hi))
        radii_np.append(0.5 * np.sqrt(((hi - lo) ** 2).sum(-1)))
        if l == L:
            break
        dims = np.argmax(hi - lo, axis=1)  # (nl,) widest dimension
        coords = np.take_along_axis(
            pts, dims[:, None, None], axis=2
        )[:, :, 0]  # (nl, seg)
        order = np.argpartition(coords, seg // 2, axis=1)
        perm = np.take_along_axis(perm.reshape(nl, seg), order, axis=1).reshape(P)
        pts_run = np.take_along_axis(
            pts, order[:, :, None], axis=1
        ).reshape(P, d)
    points = pts_run

    # radii: exact max-distance at the leaves (one O(nd) pass), then
    # tighten every internal level with the triangle bound
    # r_parent <= max_child (r_child + ||c_child - c_parent||) against the
    # bbox half-diagonal — valid covering radii everywhere, without the
    # per-level O(nd) exact pass (which dominated the 10^6-point build)
    cL = centers_np[L]
    leaf_r2 = ((points.reshape(2**L, -1, d) - cL[:, None, :]) ** 2).sum(-1)
    radii_np[L] = np.sqrt(leaf_r2.max(axis=1))
    for l in range(L - 1, -1, -1):
        cc = centers_np[l + 1].reshape(2**l, 2, d)
        rc = radii_np[l + 1].reshape(2**l, 2)
        off = np.sqrt(((cc - centers_np[l][:, None, :]) ** 2).sum(-1))
        radii_np[l] = np.minimum(radii_np[l], (rc + off).max(axis=1))

    centers = [jnp.asarray(c) for c in centers_np]
    radii = [jnp.asarray(r) for r in radii_np]

    return BalancedTree(
        perm=perm,
        points=jnp.asarray(points),
        pad=pad,
        leafsize=ls,
        levels=L,
        centers=centers,
        radii=radii,
        centers_np=centers_np,
        radii_np=radii_np,
        points_np=points,
    )


def _hilbert_transpose(q, bits, d):
    """Skilling's axes->transposed-Hilbert transform, vectorized over
    points (q: (P, d) uint64, each coordinate `bits` bits). A Hilbert
    curve is CONTINUOUS: consecutive curve positions are spatially
    adjacent, so equal-count slices never straddle the domain (Z-order's
    jumps produced leaves with radius ~ the whole cloud, which exploded
    the Barnes-Hut frontier)."""
    dt = q.dtype
    X = [q[:, j].copy() for j in range(d)]
    one = dt.type(1)
    M = dt.type(one << dt.type(bits - 1))
    Q = M
    while Q > one:
        p = dt.type(Q - one)
        for i in range(d):
            # branch-free: mask = all-ones where bit Q of X[i] is set
            mask = dt.type(0) - ((X[i] & Q) >> dt.type(int(Q).bit_length() - 1))
            t = (X[0] ^ X[i]) & p & ~mask
            X[0] ^= (p & mask) | t
            X[i] ^= t
        Q = dt.type(Q >> one)
    for i in range(1, d):
        X[i] ^= X[i - 1]
    t = np.zeros_like(X[0])
    Q = M
    while Q > one:
        mask = dt.type(0) - ((X[d - 1] & Q) >> dt.type(int(Q).bit_length() - 1))
        t ^= dt.type(Q - one) & mask
        Q = dt.type(Q >> one)
    for i in range(d):
        X[i] ^= t
    return X


def _build_tree_morton(yp, m, d, L, ls, P, pad) -> BalancedTree:
    """Space-filling-curve build: quantize coordinates, Hilbert-transform,
    interleave bits, ONE argsort; equal-count leaves = contiguous slices
    of the curve; leaf bounding boxes in one pass, internal boxes
    bottom-up; exact leaf radii + triangle-bound internal radii (same
    bound family as the median build)."""
    # enough cells that leaves resolve: 2^(bits*d) >> P; 32-bit codes when
    # they fit (halves the bandwidth of the bit-twiddling passes)
    bits = min(62 // d, 12 if d >= 2 else 16)
    while (1 << (bits * d)) < 16 * P and bits * d <= 60:
        bits += 1
    dt = np.uint32 if bits * d <= 30 else np.uint64
    lo = yp.min(axis=0)
    hi = yp.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    q = ((yp - lo) / span * ((1 << bits) - 1)).astype(dt)
    X = _hilbert_transpose(q, bits, d)
    code = np.zeros(P, dtype=dt)
    # transposed-code bit i of axis j -> global bit (i*d + (d-1-j)):
    # axis 0 carries the MOST significant interleaved bits
    for b in range(bits):
        for j in range(d):
            code |= ((X[j] >> dt(b)) & dt(1)) << dt(b * d + (d - 1 - j))
    perm = np.argsort(code, kind="stable")
    points = yp[perm]

    # leaf boxes: one pass; internal boxes: pairwise min/max bottom-up
    los = [None] * (L + 1)
    his = [None] * (L + 1)
    pts = points.reshape(2**L, ls, d)
    los[L] = pts.min(axis=1)
    his[L] = pts.max(axis=1)
    for l in range(L - 1, -1, -1):
        los[l] = np.minimum(los[l + 1][0::2], los[l + 1][1::2])
        his[l] = np.maximum(his[l + 1][0::2], his[l + 1][1::2])
    centers_np = [0.5 * (los[l] + his[l]) for l in range(L + 1)]
    radii_np = [0.5 * np.sqrt(((his[l] - los[l]) ** 2).sum(-1))
                for l in range(L + 1)]
    leaf_r2 = ((pts - centers_np[L][:, None, :]) ** 2).sum(-1)
    radii_np[L] = np.sqrt(leaf_r2.max(axis=1))
    for l in range(L - 1, -1, -1):
        cc = centers_np[l + 1].reshape(2**l, 2, d)
        rc = radii_np[l + 1].reshape(2**l, 2)
        off = np.sqrt(((cc - centers_np[l][:, None, :]) ** 2).sum(-1))
        radii_np[l] = np.minimum(radii_np[l], (rc + off).max(axis=1))

    return BalancedTree(
        perm=perm,
        points=jnp.asarray(points),
        pad=pad,
        leafsize=ls,
        levels=L,
        centers=[jnp.asarray(c) for c in centers_np],
        radii=[jnp.asarray(r) for r in radii_np],
        centers_np=centers_np,
        radii_np=radii_np,
        points_np=points,
    )


def _hilbert_transpose_jnp(q, bits, d):
    """Device port of _hilbert_transpose: q (P, d) uint32, static bit
    loops (the curve order is a compile-time constant)."""
    X = [q[:, j] for j in range(d)]
    u = lambda v: jnp.uint32(v)
    M = 1 << (bits - 1)
    Q = M
    while Q > 1:
        p = u(Q - 1)
        sh = Q.bit_length() - 1
        for i in range(d):
            mask = u(0) - ((X[i] & u(Q)) >> sh)
            t = (X[0] ^ X[i]) & p & ~mask
            X[0] = X[0] ^ ((p & mask) | t)
            X[i] = X[i] ^ t
        Q >>= 1
    for i in range(1, d):
        X[i] = X[i] ^ X[i - 1]
    t = jnp.zeros_like(X[0])
    Q = M
    while Q > 1:
        mask = u(0) - ((X[d - 1] & u(Q)) >> (Q.bit_length() - 1))
        t = t ^ (u(Q - 1) & mask)
        Q >>= 1
    return [x ^ t for x in X]


def _tree_core(yp, bits, d, L, ls):
    """Device tree build: Hilbert codes, argsort, permute, per-level
    bounding boxes bottom-up, exact leaf radii + triangle-bound internal
    radii. Codes are uint32 (32-bit integer sorts are the fast ones on
    accelerators, and jax has no 64-bit ints without x64), so
    bits*d <= 30 — the auto gate restricts the device path to d <= 4."""
    P = yp.shape[0]
    lo = yp.min(axis=0)
    hi = yp.max(axis=0)
    span = jnp.where(hi > lo, hi - lo, 1.0)
    q = ((yp - lo) / span * ((1 << bits) - 1)).astype(jnp.uint32)
    X = _hilbert_transpose_jnp(q, bits, d)
    code = jnp.zeros((P,), dtype=jnp.uint32)
    for b in range(bits):
        for j in range(d):
            code = code | (((X[j] >> b) & jnp.uint32(1))
                           << (b * d + (d - 1 - j)))
    perm = jnp.argsort(code)
    points = yp[perm]

    pts = points.reshape(2**L, ls, d)
    los = [None] * (L + 1)
    his = [None] * (L + 1)
    los[L] = pts.min(axis=1)
    his[L] = pts.max(axis=1)
    for l in range(L - 1, -1, -1):
        los[l] = jnp.minimum(los[l + 1][0::2], los[l + 1][1::2])
        his[l] = jnp.maximum(his[l + 1][0::2], his[l + 1][1::2])
    centers = [0.5 * (los[l] + his[l]) for l in range(L + 1)]
    radii = [0.5 * jnp.sqrt(((his[l] - los[l]) ** 2).sum(-1))
             for l in range(L + 1)]
    leaf_r2 = ((pts - centers[L][:, None, :]) ** 2).sum(-1)
    radii[L] = jnp.sqrt(leaf_r2.max(axis=1))
    for l in range(L - 1, -1, -1):
        cc = centers[l + 1].reshape(2**l, 2, d)
        rc = radii[l + 1].reshape(2**l, 2)
        off = jnp.sqrt(((cc - centers[l][:, None, :]) ** 2).sum(-1))
        radii[l] = jnp.minimum(radii[l], (rc + off).max(axis=1))
    perm = perm.astype(jnp.int32)
    return perm, points, tuple(centers), tuple(radii)


def _pack_mirrors(perm, points, centers, radii):
    """Pack every host-mirror into ONE flat INT32 buffer: device_get on a
    pytree fetches each leaf separately (2L+2 transfers); one packed
    fetch costs one. The buffer is integer-typed with the f32
    payload bitcast INTO it (not the int perm bitcast to f32: perm
    values 0..P-1 are all denormal f32 bit patterns, and any pass that
    flushes denormals would silently zero the permutation)."""
    import jax as _jax
    b32 = lambda a: _jax.lax.bitcast_convert_type(a, jnp.int32)
    return jnp.concatenate(
        [perm, b32(points.ravel())]
        + [b32(c.ravel()) for c in centers] + [b32(r.ravel()) for r in radii])


def _tree_device_impl(yp, bits, d, L, ls):
    perm, points, centers, radii = _tree_core(yp, bits, d, L, ls)
    return perm, points, centers, radii, _pack_mirrors(perm, points,
                                                       centers, radii)


_tree_device_jit = None


def _build_tree_device(y, m, d, L, ls, P, pad) -> BalancedTree:
    import jax
    from functools import partial

    global _tree_device_jit
    if _tree_device_jit is None:
        _tree_device_jit = jax.jit(_tree_device_impl,
                                   static_argnames=("bits", "d", "L", "ls"))

    bits = min(30 // d, 16)
    while (1 << (bits * d)) < 16 * P and bits * d <= 28:
        bits += 1

    yj = jnp.asarray(y, dtype=jnp.float32)
    if pad:
        yj = jnp.concatenate([yj, jnp.broadcast_to(yj[-1:], (pad, d))], axis=0)
    perm, points, centers, radii, packed = _tree_device_jit(
        yj, bits=bits, d=d, L=L, ls=ls)
    # host mirrors stay on device until a consumer touches one: the
    # packed device-to-host fetch (~25 MB at n = 10^6) is
    # deferred to BalancedTree._unpack — Barnes-Hut never pays it
    return BalancedTree(
        points=points,
        pad=pad,
        leafsize=ls,
        levels=L,
        centers=list(centers),
        radii=list(radii),
        perm_dev=perm,
        packed=packed,
    )
