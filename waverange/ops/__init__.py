"""Device-side (JAX/XLA) compute ops for the waverange codec."""

from .wavelet import cdf97_3d, cdf97_forward, cdf97_inverse  # noqa: F401
from .quant import quantize_layers, accumulate_layers  # noqa: F401
