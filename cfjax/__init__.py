"""cfjax — a Gaussian-process covariance engine in JAX.

Brand-new JAX/XLA/Pallas re-design with the capability surface of
SebastianAment/CovarianceFunctions.jl: a lazy Gramian linear-operator
abstraction with O(1) memory, automatic structure detection dispatching
MVMs/solves to fast paths (Toeplitz/FFT, Kronecker, derivative-kernel
blocks, Barnes-Hut, sparsification), on a composable kernel algebra.

Importing cfjax sets no XLA flag and no cache; programs opt in through
`cfjax.utils.cache` (see README, "Tests / bench").
"""

from . import kernels
from .config import Config, set_config
from .kernels import *  # noqa: F401,F403

__version__ = "0.1.0"
