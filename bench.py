"""Benchmark: the reference README's headline configuration.

Times the lazy Gramian MVM (MaternP(2), d=3, n=16384 — reference
README.md:30-43, BASELINE.md: 0.585 s on the reference's CPU) on one
NVIDIA GPU and prints ONE JSON line with the time, the speedup over that
baseline, the card's name and power limit, and a check of one row
against an f64 reference. Fails without a GPU; there is no CPU fallback.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess

import numpy as np


def main():
    # read before JAX opens the card: nvidia-smi is not a JAX process
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()

    from cfjax.utils.cache import enable_compile_cache, use_gpu_compile_flags

    use_gpu_compile_flags()
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    from cfjax.kernels import MaternP
    from cfjax.operators import Gramian
    from cfjax.utils.timing import time_call

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev.platform!r}")

    n, d = 16384, 3
    ref_seconds = 0.585  # BASELINE.md lazy dense MVM

    rng = np.random.default_rng(0)
    xn = rng.standard_normal((n, d))
    an = rng.standard_normal(n)
    x = jnp.asarray(xn, dtype=jnp.float32)
    a = jnp.asarray(an, dtype=jnp.float32)
    G = Gramian(MaternP(2), x)
    mv = jax.jit(G._matvec)
    dt = time_call(mv, a, warmup=2, reps=21)

    # guard against reporting garbage: row 0 against an f64 numpy reference
    r = np.sqrt(5.0 * ((xn - xn[0]) ** 2).sum(1))
    row0 = ((1.0 + r + r * r / 3.0) * np.exp(-r)) @ an
    rel = abs(float(mv(a)[0]) - row0) / (abs(row0) + 1e-30)

    print(json.dumps({
        "metric": "maternp2_n16384_d3_lazy_mvm_seconds",
        "value": dt,
        "unit": "s",
        "vs_baseline": ref_seconds / dt,
        "row_check_rel_err": rel,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": smi,
    }))


if __name__ == "__main__":
    main()
