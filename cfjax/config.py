"""Global configuration constants.

Mirrors the reference's module-level constants (see reference
src/CovarianceFunctions.jl:37 `default_tol`, src/gramian.jl:201-202
`DEFAULT_MAX_CHOLESKY_SIZE`/`DEFAULT_TOL`, src/barneshut.jl:3-4,
src/sparse.jl:3) as a frozen dataclass so it can be threaded through
jitted code as static metadata.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Config:
    # numerical tolerance for factorization / PSD checks
    default_tol: float = 1e-6
    # below this size, `factorize` returns a dense Cholesky; above, stays lazy (CG)
    max_cholesky_size: int = 2**14
    # Barnes-Hut defaults
    barneshut_leafsize: int = 16
    barneshut_theta: float = 0.25
    # sparsification
    sparse_leafsize: int = 16
    # default row-block size for blocked lazy MVMs (inherited; not tuned
    # on the GPU)
    mvm_block_rows: int = 512
    # iterative solver defaults
    cg_maxiter: int = 1000
    cg_tol: float = 1e-8
    # For LARGE eager solves (b.size >= cg_chunk_min_n, not under jit),
    # cg runs its while_loop in host-driven segments of this many
    # iterations, so no single device program runs for minutes (it could
    # be neither interrupted nor observed). Under jit (tracer inputs)
    # chunking is ignored. The segment length is not tuned for the GPU;
    # what the per-segment host sync costs there is not measured.
    cg_chunk_iters: int = 8
    cg_chunk_min_n: int = 1 << 18
    # matmul precision of distance/inner-product tiles and of the other
    # matmuls that follow the config. On an H100 "default" and "high"
    # both lower to TF32 (10-bit mantissa inputs, ~360 TFLOP/s for an
    # f32 GEMM) and "highest" to IEEE f32 (~50 TFLOP/s). TF32 leaves
    # ~3e-5 relative error on a d = 64..1024 EQ MVM, against ~1e-7 at
    # "highest"; the distance expansion's cancellation grows it for
    # close points, which is what Cholesky's PSD-ness and PCG at GP
    # noise levels are sensitive to — hence "highest" by default.
    matmul_precision: str = "highest"
    # at d <= this, isotropic distance tiles skip the matmul and use the
    # exact unrolled difference form (no cancellation), which XLA fuses
    # into the MVM's row reduction. The crossover against the matmul
    # expansion was set on an earlier accelerator and is not measured on
    # the GPU.
    direct_sqdist_max_d: int = 16


DEFAULT = Config()


def set_config(**kwargs):
    """Replace global config fields (e.g. set_config(matmul_precision=
    "default") for TF32 matmuls). Clears jax's jit caches:
    jitted kernels read DEFAULT at trace time, so cached executables
    would otherwise keep the old values."""
    global DEFAULT
    import dataclasses as _dc

    import jax as _jax

    DEFAULT = _dc.replace(DEFAULT, **kwargs)
    _jax.clear_caches()
    return DEFAULT
