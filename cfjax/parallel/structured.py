"""Sharded structured fast paths: gradient/Hessian block MVMs, Barnes-Hut,
Kronecker and Toeplitz over a device mesh.

Round-1 sharded only the scalar dense Gramian; the reference threads
*every* hot loop (gradient blockmul src/gramian.jl:242-251, per-target
Barnes-Hut src/barneshut.jl:88). This module is the device-mesh equivalent for
the structured operators:

  * derivative-kernel block MVMs (iso/dot/slf/pair/generic, value+grad,
    Hessian, VGH): rows of the block matrix sharded over a mesh axis
    (each device runs the same trait-specialized closed-form matmul
    expansion on its row shard); optional second mesh axis shards the
    SOURCE points + input blocks, with a psum reduction of the partial
    MVMs — the dp x tp decomposition of this domain;
  * Barnes-Hut: the target-group axis of every width bucket is sharded
    (the mesh analogue of the reference's per-target threaded loop);
  * Kronecker: leading grid mode sharded; trailing modes contract
    locally, the leading mode reduces with psum_scatter over the mesh;
  * Toeplitz/circulant: batched FFT MVM with the RHS columns sharded.

Everything is expressed with jax.shard_map + named collectives so the
same code runs on a fake 8-device CPU mesh, one host's GPUs (XLA runs
the collectives through NCCL over NVLink), or several hosts under
jax.distributed.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..operators.linop import LinearOperator
from .mesh import default_mesh


def _pad_rows_to(arr, mult):
    p = (-arr.shape[0]) % mult
    if not p:
        return arr
    pad = [(0, p)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, pad, mode="edge")


def _pad_rows_zero(arr, mult):
    p = (-arr.shape[0]) % mult
    if not p:
        return arr
    pad = [(0, p)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, pad)


def sharded_block_apply(fn, k, x, y, vec_args, mesh: Mesh, row_axis: str,
                        col_axis: str | None = None, block: int | None = None):
    """Shard any trait-specialized block MVM `fn(k, x, y, *vec_args,
    block=...) -> (n, D)` whose rows are independent and whose output is
    linear in `vec_args` (summed over y rows) — true for every
    grad/valgrad/hess/vgh matvec in cfjax.derivative.

    Rows of x shard over `row_axis`. With `col_axis`, y and the input
    blocks also shard and each device contributes a partial sum over its
    source shard, reduced by psum (zero-padded vec rows contribute 0)."""
    n = x.shape[0]
    nr = mesh.shape[row_axis]
    xp = _pad_rows_to(x, nr)
    kws = {} if block is None else dict(block=block)

    if col_axis is None:
        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P(row_axis)) + (P(),) * (1 + len(vec_args)),
                 out_specs=P(row_axis), check_vma=False)
        def mv(k_, xs, y_, *vecs):
            return fn(k_, xs, y_, *vecs, **kws)

        out = mv(k, xp, y, *vec_args)
    else:
        nc = mesh.shape[col_axis]
        yp = _pad_rows_to(y, nc)
        vecs = tuple(_pad_rows_zero(v, nc) for v in vec_args)

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P(row_axis), P(col_axis))
                 + (P(col_axis),) * len(vecs),
                 out_specs=P(row_axis), check_vma=False)
        def mv(k_, xs, ys, *vs):
            part = fn(k_, xs, ys, *vs, **kws)
            return jax.lax.psum(part, col_axis)

        out = mv(k, xp, yp, *vecs)
    return out[:n]


# --------------------------------------------------------------------------
# sharded derivative-kernel gramians
# --------------------------------------------------------------------------


def _grad_fn(mode):
    from ..derivative import gradient as g

    if mode == "iso":
        return g.grad_matvec_iso
    if mode == "dot":
        return g.grad_matvec_dot
    if mode == "slf":
        return g.grad_matvec_slf
    if mode == "pair":
        from ..derivative.pair import grad_matvec_pair

        return grad_matvec_pair
    return g.grad_matvec_generic


def _hess_fn(mode):
    from ..derivative import hessian as h

    if mode == "iso":
        return h.hess_matvec_iso
    if mode == "dot":
        return h.hess_matvec_dot
    return h.hess_matvec_generic


class _ShardedBlockGramian(LinearOperator):
    """Common machinery: flat (n*D) x (m*D) operator over per-point
    D-blocks, rows sharded on `row_axis` (+ optional col shard/psum)."""

    def __init__(self, k, x, y=None, mesh: Mesh = None, row_axis: str = None,
                 col_axis: str = None, block: int = None):
        from ..utils.grids import as_points

        self.k = k
        self.mesh = mesh if mesh is not None else default_mesh()
        self.row_axis = row_axis or self.mesh.axis_names[0]
        self.col_axis = col_axis
        self.x = as_points(x)
        self.y = self.x if y is None else as_points(y)
        self._same = y is None
        self.d = self.x.shape[1]
        D = self._block_dim()
        self.shape = (self.x.shape[0] * D, self.y.shape[0] * D)
        self.dtype = jnp.result_type(self.x.dtype, float)
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        # PSD holds for the derivative gramian of a genuine Mercer kernel
        # (cov of derivatives); don't claim it from symmetry alone
        return self._same and getattr(self.k, "is_mercer", False)

    def _sharded(self, fn, vec_args):
        return sharded_block_apply(fn, self.k, self.x, self.y, vec_args,
                                   self.mesh, self.row_axis, self.col_axis,
                                   self.block)


class ShardedGradientGramian(_ShardedBlockGramian):
    """Row(+col)-sharded flat (n d) x (m d) gradient-block operator —
    the mesh version of GradientGramian (reference threaded blockmul!,
    src/gramian.jl:242-251)."""

    def _block_dim(self):
        from ..derivative.gradient import _grad_mode

        self.mode = _grad_mode(self.k)
        return self.d

    def _matvec(self, v):
        A = v.reshape(self.y.shape[0], self.d)
        return self._sharded(_grad_fn(self.mode), (A,)).reshape(-1)


class ShardedValueGradientGramian(_ShardedBlockGramian):
    """Row(+col)-sharded (n(1+d)) x (m(1+d)) value+gradient operator."""

    def _block_dim(self):
        from ..derivative.gradient import _grad_mode

        self.mode = _grad_mode(self.k)
        return self.d + 1

    def _matvec(self, v):
        from ..derivative import gradient as g

        D = self.d + 1
        V = v.reshape(self.y.shape[0], D)
        a0, A = V[:, 0], V[:, 1:]
        if self.mode == "iso":
            fn = g.valgrad_matvec_iso
        elif self.mode == "dot":
            fn = g.valgrad_matvec_dot
        elif self.mode == "pair":
            from ..derivative.pair import valgrad_matvec_pair

            fn = valgrad_matvec_pair
        else:
            fn = g.valgrad_matvec_generic
        return self._sharded(fn, (a0, A)).reshape(-1)


class ShardedHessianGramian(_ShardedBlockGramian):
    """Row(+col)-sharded (n d^2) x (m d^2) Hessian-block operator."""

    def _block_dim(self):
        from ..kernels.base import InputTrait, input_trait

        t = input_trait(self.k)
        self.mode = (
            "iso" if t == InputTrait.ISOTROPIC
            else "dot" if t == InputTrait.DOT
            else "generic"
        )
        return self.d * self.d

    def _matvec(self, v):
        A = v.reshape(self.y.shape[0], self.d, self.d)
        return self._sharded(_hess_fn(self.mode), (A,)).reshape(-1)


# --------------------------------------------------------------------------
# sharded Barnes-Hut
# --------------------------------------------------------------------------


def sharded_bh_matvec(F, v, mesh: Mesh, axis: str = None):
    """b = F v with the target-group axis of every Barnes-Hut width
    bucket sharded over `axis` (mesh analogue of the reference's
    per-target threaded loop, src/barneshut.jl:88). Tree reductions +
    source data are replicated; each device contracts only its groups'
    precomputed interaction lists (the r5 planned path — the frontier
    walk happened once on the host at plan time)."""
    from ..barneshut.bh import bh_matvec_planned

    axis = axis or mesh.axis_names[0]
    nd = mesh.shape[axis]
    t = F.tree
    wp = F._permuted_weights(jnp.asarray(v))
    flat = jnp.zeros((F._tgt_P,), dtype=F.dtype)

    def padg(a, pg):
        return np.concatenate([a, np.repeat(a[-1:], pg, 0)]) if pg else a

    for (xg_b, _, _, rows_b, _), (flv, fidx, lidx) in zip(F.buckets, F.plans):
        ng = xg_b.shape[0]
        pg = (-ng) % nd
        xg_p = padg(np.asarray(xg_b), pg)
        fidx_p = tuple(jnp.asarray(padg(f, pg)) for f in fidx)
        lidx_p = jnp.asarray(padg(lidx, pg))

        fn = partial(bh_matvec_planned, far_levels=flv, levels=t.levels,
                     leafsize=t.leafsize, order=getattr(F, "order", 1))

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(), P(axis), tuple(P(axis) for _ in fidx_p),
                           P(axis), P(), P()),
                 out_specs=P(axis), check_vma=False)
        def mv(k_, xg, fi, li, pts, w_):
            return fn(k_, xg, fi, li, pts, w_)

        out_g = mv(F.k, jnp.asarray(xg_p), fidx_p, lidx_p, t.points, wp)
        out_g = out_g[:ng]
        flat = flat.at[jnp.asarray(rows_b.reshape(-1))].set(out_g.reshape(-1))
    out = jnp.zeros((F._tgt_P,), dtype=flat.dtype)
    out = out.at[jnp.asarray(F._tgt_perm)].set(flat)
    return out[: F.n]


# --------------------------------------------------------------------------
# sharded Kronecker + Toeplitz
# --------------------------------------------------------------------------


def _dense_factor(f):
    return f if isinstance(f, jnp.ndarray) else f.todense()


def sharded_kronecker_matvec(K, a, mesh: Mesh, axis: str = None):
    """(A1 (x) ... (x) Ak) a with the leading grid mode sharded over
    `axis`: trailing modes contract locally on each device's slab of the
    reshaped tensor; the leading mode's contraction produces per-device
    partials reduced with psum_scatter back onto the shard. Per-device
    FLOPs = full MVM / n_devices; the only collective is one
    reduce-scatter of the (m1, m2...mk) tensor."""
    axis = axis or mesh.axis_names[0]
    nd = mesh.shape[axis]
    mats = [_dense_factor(f) for f in K.factors]
    dims = [int(m.shape[0]) for m in mats]
    X = jnp.asarray(a).reshape(dims)
    m1 = dims[0]
    p = (-m1) % nd
    A1 = jnp.pad(mats[0], ((0, p), (0, p)))  # zero rows/cols: inert
    Xp = jnp.pad(X, [(0, p)] + [(0, 0)] * (len(dims) - 1))
    rest = mats[1:]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None, axis), P(axis)) + (P(),) * len(rest),
             out_specs=P(axis), check_vma=False)
    def mv(A1_cols, Xloc, *rest_mats):
        # trailing modes: local contractions (device holds full trailing dims)
        Z = Xloc
        for i, M in enumerate(rest_mats):
            Z = jnp.moveaxis(
                jnp.tensordot(M, Z, axes=(1, i + 1)), 0, i + 1)
        # leading mode: partial over this device's rows of X
        part = jnp.tensordot(A1_cols, Z, axes=(1, 0))  # (m1p, ...)
        return jax.lax.psum_scatter(part, axis, scatter_dimension=0,
                                    tiled=True)

    out = mv(A1, Xp, *rest)
    if p:
        out = out[:m1]
    return out.reshape(-1)


def sharded_toeplitz_matmat(T, V, mesh: Mesh, axis: str = None):
    """Batched circulant-embedding FFT MVM with RHS columns sharded over
    the mesh (the Toeplitz path's batch parallelism; single-vector MVMs
    are latency-bound and stay single-device)."""
    from ..operators.toeplitz import toeplitz_matvec

    axis = axis or mesh.axis_names[0]
    nd = mesh.shape[axis]
    V = jnp.asarray(V)
    r = V.shape[1]
    p = (-r) % nd
    Vp = jnp.pad(V, ((0, 0), (0, p)))
    col, row = T.col, T.row if hasattr(T, "row") else T.col

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(), P(), P(None, axis)), out_specs=P(None, axis),
             check_vma=False)
    def mm(c, rw, Vloc):
        return jax.vmap(lambda v: toeplitz_matvec(c, rw, v),
                        in_axes=1, out_axes=1)(Vloc)

    out = mm(col, row, Vp)
    return out[:, :r] if p else out
