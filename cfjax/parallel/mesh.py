"""Device-mesh parallelism for lazy Gramians.

The reference's only parallelism is shared-memory threads over Gramian
rows (src/gramian.jl:81, SURVEY.md §2.3). The device equivalent is
row-block data parallelism over a `jax.sharding.Mesh`:

  - points x are sharded along the mesh "data" axis (each device owns a row
    block of the implicit n x n kernel matrix),
  - y and the input vector are replicated,
  - each device evaluates its kernel tile on the fly (same blocked
    matmul-profile MVM as on one device) -> output is row-sharded,
  - CG runs on row-sharded vectors; its inner products become psum
    collectives automatically under jit/GSPMD.

Multi-host: the same code runs under jax.distributed with a global mesh.
XLA runs the collectives through NCCL: over NVLink between the GPUs of
one host, over the network between hosts. Every GPU of a host reaches
every other at the same rate, so mesh shapes follow the algorithm."""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..operators.gramian import gramian_matvec, mvm_mode
from ..operators.linop import LinearOperator


def init_distributed(coordinator_address: str = None, num_processes: int = None,
                     process_id: int = None, mesh_shape: tuple = None,
                     axis_names: tuple = ("rows", "cols")):
    """Multi-host bring-up: wire `jax.distributed.initialize` and build a
    global 2-D mesh over every device of every process (XLA runs the
    collectives through NCCL; there is nothing to configure).

    In a single-process run all arguments may be omitted and
    `initialize()` is skipped. With several processes, pass
    `coordinator_address` (e.g. "localhost:<port>" on one host),
    `num_processes` and `process_id`: nothing detects a cluster. Returns the global
    Mesh; shard with `jax.sharding.NamedSharding(mesh, P(...))` or the
    Sharded* operators in this package exactly as on one host —
    `jax.make_array_from_process_local_data` builds the global arrays.
    """
    multiprocess = coordinator_address is not None or (
        num_processes is not None and num_processes > 1
    )
    if multiprocess and jax.process_count() == 1:
        kw = {}
        if coordinator_address is not None:
            kw["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kw["num_processes"] = num_processes
        if process_id is not None:
            kw["process_id"] = process_id
        jax.distributed.initialize(**kw)
    devs = jax.devices()  # global device list, all hosts
    if mesh_shape is None:
        nd = len(devs)
        rows = int(np.gcd(nd, max(1, jax.process_count())))
        if rows == 1 and nd % 2 == 0 and nd > 1:
            rows = 2
        mesh_shape = (rows, nd // rows)
    axis_names = tuple(axis_names)[: len(mesh_shape)]
    return Mesh(np.array(devs).reshape(mesh_shape), axis_names)


def default_mesh(n_devices: int = None, axis: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_rows(arr, mesh: Mesh, axis: str = "data"):
    """Place an (n, ...) array row-sharded over the mesh."""
    spec = P(axis, *([None] * (jnp.ndim(arr) - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(arr, mesh: Mesh):
    return jax.device_put(arr, NamedSharding(mesh, P()))


def sharded_gramian_matvec(k, x, y, a, mode: str, mesh: Mesh, axis: str = "data",
                           block: int = 512):
    """b = K a with rows of K sharded over the mesh (shard_map version of
    gramian_matvec: each device runs the blocked tile MVM on its row shard)."""
    nd = mesh.shape[axis]
    n = x.shape[0]
    pad = (-n) % nd
    xp = jnp.pad(x, ((0, pad), (0, 0))) if pad else x

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(axis, None), P(None, None), P(None)),
        out_specs=P(axis),
        check_vma=False,
    )
    def mv(k_, xs, y_, a_):
        blk = min(block, xs.shape[0])
        return gramian_matvec(k_, xs, y_, a_, mode, blk)

    out = mv(k, xp, y, a)
    return out[:n] if pad else out


def sharded_cg(matvec, b, tol: float = 1e-8, maxiter: int = 1000):
    """CG whose operand vectors may be sharded; inner products become
    psums automatically under jit."""
    from ..operators.solvers import cg

    return cg(matvec, b, tol=tol, maxiter=maxiter)


class ShardedGramian(LinearOperator):
    """Row-sharded lazy Gramian over a device mesh."""

    def __init__(self, k, x, y=None, mesh: Mesh = None, axis: str = "data",
                 block: int = 512):
        from ..utils.grids import as_points

        self.k = k
        self.mesh = mesh if mesh is not None else default_mesh()
        self.axis = axis
        xp = as_points(x)
        yp = xp if y is None else as_points(y)
        self._same = y is None
        # pad rows to a device-count multiple so the shard is legal;
        # padded garbage rows are sliced off after each matvec
        nd = self.mesh.shape[axis]
        self._n = xp.shape[0]
        pad = (-self._n) % nd
        xp_pad = jnp.pad(xp, ((0, pad), (0, 0))) if pad else xp
        self.x = shard_rows(xp_pad, self.mesh, axis)
        self.y = replicate(yp, self.mesh)
        self.shape = (xp.shape[0], yp.shape[0])
        self.dtype = jnp.result_type(xp.dtype, float)
        self.mode = mvm_mode(k)
        self.block = block

    @property
    def is_symmetric(self):
        return self._same

    @property
    def is_psd(self):
        return self._same and self.k.is_mercer

    def _matvec(self, v):
        out = sharded_gramian_matvec(
            self.k, self.x, self.y, v, self.mode, self.mesh, self.axis, self.block
        )
        return out[: self._n]

    def solve(self, b, tol: float = 1e-8, maxiter: int = 1000, **kw):
        x, _ = sharded_cg(self._matvec, b, tol=tol, maxiter=maxiter)
        return x


def sharded_gramian_matvec_2d(
    k, x, y, a, mode: str, mesh: Mesh, row_axis: str = "rows",
    col_axis: str = "cols", block: int = 512,
):
    """b = K a over a 2-D mesh: rows of K sharded on `row_axis`, columns
    (i.e. y points and the input vector) on `col_axis`. Each device
    computes its (row-shard x col-shard) tile's partial MVM; a psum over
    the column axis reduces the partials (this domain's 'tensor
    parallelism'; cf. SURVEY.md §2.3)."""
    nr = mesh.shape[row_axis]
    nc = mesh.shape[col_axis]
    n, m = x.shape[0], y.shape[0]
    pr, pc = (-n) % nr, (-m) % nc
    xp = jnp.pad(x, ((0, pr), (0, 0))) if pr else x
    yp = jnp.pad(y, ((0, pc), (0, 0))) if pc else y
    ap = jnp.pad(a, (0, pc)) if pc else a

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(row_axis, None), P(col_axis, None), P(col_axis)),
        out_specs=P(row_axis),
        check_vma=False,
    )
    def mv(k_, xs, ys, as_):
        blk = min(block, xs.shape[0])
        part = gramian_matvec(k_, xs, ys, as_, mode, blk)
        return jax.lax.psum(part, col_axis)

    out = mv(k, xp, yp, ap)
    return out[:n]
