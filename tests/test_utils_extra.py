"""Utility parity tests (reference src/util.jl, src/givens.jl,
src/derivatives.jl equivalents)."""

import jax
import jax.numpy as jnp
import numpy as np

from cfjax.utils.linalg import (
    exchange_matrix,
    givens_rotation,
    jet_derivatives,
    leave_one_out_products,
    nth_derivatives,
    perfect_shuffle,
    perfect_shuffle_indices,
)
from cfjax.utils.testing import isisotropic_probe, isstationary_probe


def test_perfect_shuffle(rng):
    X = rng.standard_normal((3, 5))
    v = jnp.asarray(X.reshape(-1))
    out = perfect_shuffle(v, 3, 5)
    np.testing.assert_allclose(np.asarray(out), X.T.reshape(-1))
    p = perfect_shuffle_indices(3, 5)
    np.testing.assert_allclose(X.reshape(-1)[p], X.T.reshape(-1))


def test_exchange_and_loo(rng):
    J = np.asarray(exchange_matrix(4))
    v = rng.standard_normal(4)
    np.testing.assert_allclose(J @ v, v[::-1])
    x = rng.uniform(0.5, 2, 6)
    loo = np.asarray(leave_one_out_products(jnp.asarray(x)))
    expect = np.array([np.prod(np.delete(x, i)) for i in range(6)])
    np.testing.assert_allclose(loo, expect, rtol=1e-12)


def test_givens_differentiable():
    c, s, r = givens_rotation(3.0, 4.0)
    np.testing.assert_allclose([float(c), float(s), float(r)], [0.6, 0.8, 5.0])
    # rotation annihilates second entry
    assert abs(float(-s * 3.0 + c * 4.0)) < 1e-12
    g = jax.grad(lambda f: givens_rotation(f, 4.0)[2])(3.0)
    np.testing.assert_allclose(float(g), 0.6, rtol=1e-12)


def test_nth_derivatives():
    f = lambda x: jnp.sin(x)
    d = nth_derivatives(f, 0.7, 4)
    x = 0.7
    expect = [np.sin(x), np.cos(x), -np.sin(x), -np.cos(x), np.sin(x)]
    np.testing.assert_allclose([float(v) for v in d], expect, rtol=1e-10)
    dj = jet_derivatives(f, 0.7, 4)
    np.testing.assert_allclose([float(v) for v in dj], expect, rtol=1e-10)


def test_property_probes():
    from cfjax.kernels import EQ, Cosine, Dot

    assert isstationary_probe(EQ())
    assert isisotropic_probe(EQ())
    assert isstationary_probe(Cosine(jnp.ones(3)))
    assert not isisotropic_probe(Cosine(jnp.asarray([1.0, 2.0, 0.5])))
    assert not isstationary_probe(Dot())


def test_explain_and_matrixkernel(rng):
    from cfjax.kernels import EQ, MatrixKernel
    from cfjax.operators.dispatch import explain, gramian
    from cfjax.utils.grids import UniformGrid

    s = explain(EQ(), UniformGrid(0.0, 0.1, 16))
    assert "Toeplitz" in s
    s2 = explain(EQ(), rng.standard_normal((10, 2)))
    assert "mvm mode = iso" in s2
    A = rng.standard_normal((6, 6))
    A = A @ A.T
    k = MatrixKernel(jnp.asarray(A), (6, 6))
    G = gramian(k, np.asarray([0, 2, 4]), np.asarray([1, 3]))
    np.testing.assert_allclose(np.asarray(G.todense()), A[[0, 2, 4]][:, [1, 3]])


def test_time_call_median_of_timed_calls():
    """Warm-up calls are not timed; the result is the median of `reps`
    calls, each of which ends in block_until_ready."""
    import time

    from cfjax.utils.timing import time_call

    calls = []

    def fn(v):
        calls.append(1)
        time.sleep(0.002 if len(calls) > 2 else 0.2)  # slow warm-up
        return v + 1.0

    dt = time_call(fn, jnp.zeros(8), warmup=2, reps=5)
    assert len(calls) == 7
    assert 0.002 <= dt < 0.1


def test_time_call_measures_real_op():
    from cfjax.utils.timing import time_call

    A = jnp.asarray(np.random.default_rng(0).standard_normal((256, 256)),
                    dtype=jnp.float32)
    dt = time_call(jax.jit(lambda v: A @ v), jnp.ones(256), reps=3)
    assert dt > 0


def test_roofline_accounting():
    import pytest

    from cfjax.utils.roofline import peaks, roofline_seconds

    kind = "NVIDIA H100 80GB HBM3"
    assert peaks(kind)["tf32"] == 495e12
    # 2 GFLOP at the f32 peak vs 1 GB at 3.35 TB/s: memory bound
    t, bound = roofline_seconds(kind, 2e9, 1e9)
    assert bound == "hbm" and t == 1e9 / 3.35e12
    t, bound = roofline_seconds(kind, 1e15, 1e9, rate="bf16")
    assert bound == "bf16" and t == 1e15 / 989e12
    with pytest.raises(ValueError, match="no published peaks"):
        peaks("cpu")


def test_compile_cache_location(monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR when set, else `.jax_cache` at the root
    of the checkout; the path is what JAX's config then holds."""
    import os

    from cfjax.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_import_sets_no_xla_flags():
    """Importing cfjax leaves XLA_FLAGS as it was: the GPU compile flags
    are for programs to opt into."""
    import os

    import cfjax  # noqa: F401

    assert "xla_gpu" not in os.environ.get("XLA_FLAGS", "")


def test_use_gpu_compile_flags(monkeypatch):
    """Adds each flag unless XLA_FLAGS sets it; raises once a backend is
    up (XLA would ignore the flags), unless nothing is missing."""
    import os

    import pytest
    from jax._src import xla_bridge

    from cfjax.utils import cache

    monkeypatch.setattr(xla_bridge, "backends_are_initialized", lambda: False)
    monkeypatch.setenv("XLA_FLAGS", "--xla_gpu_autotune_level=2 --xla_foo=1")
    assert cache.use_gpu_compile_flags().split() == [
        "--xla_gpu_autotune_level=2", "--xla_foo=1",
        "--xla_gpu_enable_triton_gemm=false"]
    monkeypatch.setattr(xla_bridge, "backends_are_initialized", lambda: True)
    before = cache.use_gpu_compile_flags()  # nothing missing: no error
    assert before == os.environ["XLA_FLAGS"]
    monkeypatch.setenv("XLA_FLAGS", "--xla_foo=1")
    with pytest.raises(RuntimeError, match="before the first JAX computation"):
        cache.use_gpu_compile_flags()
    assert os.environ["XLA_FLAGS"] == "--xla_foo=1"
