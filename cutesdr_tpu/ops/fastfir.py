"""FFT overlap-save fast convolution — the main channel bandpass filter.

Reference analogue: CFastFIR (dsp/fastfir.cpp:268-306): a serial per-sample
buffer-fill loop that fires a 2048-pt FFT → H multiply → IFFT every 1024
samples, keeping a 1024-sample overlap.

Design: the block is reshaped into *all* of its overlap-save frames at
once — [n_frames, 2048] with hop 1024 — and a single batched FFT·H·IFFT
processes every frame in parallel.  The only state is the last
(FIR_SIZE-1)-sample input tail.  Output alignment and values match the
reference exactly: frame f (with z = [tail | block]) covers z[f·V : f·V+NFFT]
and contributes its last V = NFFT-(FIR-1) samples.

The filter H comes from design/fastfir_design.py and already includes the
1/NFFT scale the reference folds in; since jnp.fft.ifft scales by 1/NFFT
itself (the reference's RevFFT is unscaled), the runtime multiplies by NFFT
once, keeping H bit-identical with the reference design.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from cutesdr_tpu.design.fastfir_design import (CONV_FFT_SIZE, CONV_FIR_SIZE,
                                               design_fastfir)
from cutesdr_tpu.types import complex_to_device, complex_zeros


class FastFirParams(NamedTuple):
    h_freq: jax.Array    # [NFFT] complex frequency response (incl. 1/NFFT)


class FastFirCarry(NamedTuple):
    tail: jax.Array      # [FIR-1] complex input history


# default sizes (reference values); smaller sizes trade throughput for
# latency — one overlap-save frame of (nfft - ntaps + 1) output samples is
# the pipeline's intrinsic latency.  All runtime functions derive the sizes
# from the array shapes, so any (power-of-2 nfft, ntaps <= nfft) pair works.
NFFT = CONV_FFT_SIZE
NFIR = CONV_FIR_SIZE
VALID = NFFT - (NFIR - 1)   # 1024 output samples per frame


def valid_per_frame(nfft: int = NFFT, ntaps: int = NFIR) -> int:
    return nfft - (ntaps - 1)


def init(f_lo_cut: float, f_hi_cut: float, offset: float, sample_rate: float,
         cdtype=jnp.complex64, nfft: int = NFFT,
         ntaps: int = NFIR) -> tuple[FastFirParams, FastFirCarry]:
    h = design_fastfir(f_lo_cut, f_hi_cut, offset, sample_rate,
                       fft_size=nfft, fir_size=ntaps)
    # complex_to_device: H must not cross the boundary as complex (CLAUDE.md)
    return (FastFirParams(h_freq=complex_to_device(h, cdtype)),
            FastFirCarry(tail=complex_zeros(ntaps - 1, cdtype)))


def retune(params: FastFirParams, f_lo_cut: float, f_hi_cut: float,
           offset: float, sample_rate: float,
           ntaps: int = NFIR) -> FastFirParams:
    h = design_fastfir(f_lo_cut, f_hi_cut, offset, sample_rate,
                       fft_size=params.h_freq.shape[-1], fir_size=ntaps)
    return FastFirParams(h_freq=complex_to_device(h, params.h_freq.dtype))


def filter_frames(h_freq: jax.Array, z: jax.Array,
                  ntaps: int = NFIR) -> jax.Array:
    """Overlap-save core on an explicit [ntaps-1 + n] history+block buffer;
    returns n filtered samples.  Also used by the time-sharded front-end,
    where the history is a ppermute'd halo instead of a carried tail."""
    nfft = h_freq.shape[-1]
    valid = nfft - (ntaps - 1)
    n = z.shape[-1] - (ntaps - 1)
    if n % valid:
        raise ValueError(f"fastfir block length {n} not a multiple of {valid}")
    n_frames = n // valid
    # frame f = z[f*valid : f*valid + nfft]
    idx = (np.arange(nfft)[None, :] + valid * np.arange(n_frames)[:, None])
    frames = z[..., idx]                                  # [..., n_frames, nfft]
    spec = jnp.fft.fft(frames, axis=-1)
    yf = jnp.fft.ifft(spec * h_freq, axis=-1) * nfft
    y = yf[..., ntaps - 1:]                               # [..., n_frames, valid]
    return y.reshape(y.shape[:-2] + (n,)).astype(z.dtype)


def process(params: FastFirParams, carry: FastFirCarry,
            x: jax.Array) -> tuple[FastFirCarry, jax.Array]:
    """len(x) must be a multiple of the frame's valid length."""
    ntaps = carry.tail.shape[-1] + 1
    z = jnp.concatenate([carry.tail, x], axis=-1)        # [ntaps-1 + n]
    y = filter_frames(params.h_freq, z, ntaps)
    return FastFirCarry(tail=z[..., z.shape[-1] - (ntaps - 1):]), y
