"""Compile settings for programs that run cfjax: JAX's persistent
compilation cache and XLA's GPU flags, in one place.

Importing cfjax changes neither. A program (chip_smoke.py, bench.py,
examples/) calls `use_gpu_compile_flags()` first thing, before any JAX
computation, and `enable_compile_cache()` before it compiles."""

from __future__ import annotations

import os

import jax

# the checkout's own cache directory (listed in .gitignore); a fixed path,
# because the path is part of the cache key
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")

# Measured on an H100 (80GB HBM3):
#   * --xla_gpu_autotune_level=0: XLA's GPU autotuner made the compile of
#     the lazy Gramian MVM grow with n (0.5 s at n = 16384, 19 s at 65536,
#     over 90 s at 262144) while the program it chose ran no faster
#     (7.1 ms at n = 65536 with and without it);
#   * --xla_gpu_enable_triton_gemm=false: without autotuning, XLA's own
#     Triton GEMMs ran an 8192^3 bf16 product at 25 TFLOP/s; cuBLAS, which
#     needs no autotuning, ran it at 719.
GPU_COMPILE_FLAGS = ("--xla_gpu_autotune_level=0",
                     "--xla_gpu_enable_triton_gemm=false")


def use_gpu_compile_flags() -> str:
    """Add GPU_COMPILE_FLAGS to this process's XLA_FLAGS, each unless
    XLA_FLAGS already sets it. They hold for every XLA program of the
    process, cfjax's or not. XLA reads its flags when its backend starts,
    so this raises once a JAX backend is up. Returns XLA_FLAGS."""
    from jax._src import xla_bridge

    flags = os.environ.get("XLA_FLAGS", "")
    missing = [f for f in GPU_COMPILE_FLAGS if f.split("=")[0] not in flags]
    if missing and xla_bridge.backends_are_initialized():
        raise RuntimeError("use_gpu_compile_flags() must run before the first "
                           "JAX computation: XLA has read its flags already")
    os.environ["XLA_FLAGS"] = " ".join([flags, *missing]).strip()
    return os.environ["XLA_FLAGS"]


def enable_compile_cache() -> str:
    """Keep compiled programs in $JAX_COMPILATION_CACHE_DIR when it is set,
    else in `.jax_cache` at the root of the checkout. Returns the path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _REPO_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
