"""Common dtypes and constants.

Reference analogue: dsp/datatypes.h (TYPEREAL=double, TYPECPX={re,im} double).
The accelerator build defaults to float32/complex64 for throughput; a float64 "golden"
mode (for bit-level comparisons against the reference math) is enabled by
``jax.config.update("jax_enable_x64", True)`` plus ``set_precision("golden")``.
"""

from __future__ import annotations

import numpy as np

K_PI = 3.14159265358979323846
K_2PI = 2.0 * K_PI

# Full-scale amplitude used throughout the reference chain: input samples are
# scaled to +-32767 (16-bit A/D convention), AGC and S-meter calibrate to it.
# (reference: dsp/agc.cpp:69 MAX_AMPLITUDE, dsp/smeter.cpp:47 MAX_PWR)
MAX_AMPLITUDE = 32767.0

_PRECISION = "fast"  # "fast" (f32/c64) or "golden" (f64/c128)


def set_precision(mode: str) -> None:
    global _PRECISION
    if mode not in ("fast", "golden"):
        raise ValueError(f"unknown precision mode {mode!r}")
    _PRECISION = mode


def real_dtype():
    return np.float64 if _PRECISION == "golden" else np.float32


def complex_dtype():
    return np.complex128 if _PRECISION == "golden" else np.complex64


def complex_zeros(shape, dtype):
    """``jnp.zeros`` that forms complex arrays as ``lax.complex`` of real
    zero planes, so no host complex constant is transferred (eagerly or
    traced).  Real dtypes pass through to plain ``jnp.zeros``."""
    import jax
    import jax.numpy as jnp

    dtype = jnp.dtype(dtype)
    if not jnp.issubdtype(dtype, jnp.complexfloating):
        return jnp.zeros(shape, dtype)
    rd = jnp.float64 if dtype == jnp.dtype(jnp.complex128) else jnp.float32
    z = jnp.zeros(shape, rd)
    return jax.lax.complex(z, z)


def complex_to_device(a, cdtype=None):
    """Host complex array -> device complex array WITHOUT a complex
    host->device transfer: ships the real/imag planes as floats and forms
    the complex value on device (jax.lax.complex).

    Used for every complex *constant* that enters a params pytree (filter
    responses, DFT tables), the same f32-plane contract as
    Receiver.process_host; equivalent to a complex transfer."""
    import jax
    import jax.numpy as jnp

    a = np.asarray(a)
    if cdtype is None:
        cdtype = complex_dtype()
    rd = jnp.float64 if np.dtype(cdtype) == np.complex128 else jnp.float32
    return jax.lax.complex(jnp.asarray(a.real.copy(), rd),
                           jnp.asarray(a.imag.copy(), rd))
