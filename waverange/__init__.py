"""waverange — a JAX lossy compression framework for 3-D
regular-grid CFD floating-point data, with the capabilities of WaveRange
(pseudospectators/WaveRange): CDF 9/7 wavelet decomposition, tolerance-driven
byte-layer quantization, and range coding, plus the generic / FluSI-HDF5 /
MSSG file interfaces.

Architecture (a from-scratch design, not a port):
  * device path (JAX/XLA, on a GPU or the CPU): separable lifting
    wavelet sweeps, min/max reductions, byte-layer quantization —
    batched over fields and subdomain blocks, sharded over a
    `jax.sharding.Mesh`;
  * host path (C++ via ctypes): the inherently sequential entropy stage
    (carry-propagating range coder), parallel across independent layer
    streams × fields × blocks; plus a bit-exact f64 reference pipeline;
  * io/cli: file formats and command-line tools compatible with the
    reference's wrenc/wrdec/wrmssgenc/wrmssgdec.
"""

__version__ = "0.1.0"

from . import native  # noqa: F401
