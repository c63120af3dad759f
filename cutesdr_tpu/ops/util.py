"""Shared helpers for the ops layer."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def strided_corr(z: jax.Array, taps: jax.Array, stride: int = 1,
                 offset: int = 0, compute_dtype=None) -> jax.Array:
    """Strided sliding-window correlation along the last axis.

    y[..., n] = sum_j taps[j] * z[..., n*stride + offset + j]

    for every n such that the window fits (VALID).  Real dtypes only; complex
    inputs are handled by callers via stacked re/im (the convs are real).
    Lowers to ``lax.conv_general_dilated`` (which is itself cross-correlation,
    no kernel flip).  Callers wanting true convolution pass ``taps[::-1]``.

    ``compute_dtype=jnp.bfloat16`` quantizes inputs and taps to bf16 while
    accumulating in float32 — halves the memory traffic of the wideband
    front end at a measured ~50 dB quantization-SNR floor (see
    tests/test_numerics_parity.py::test_bf16_front_end_snr).

    The default (f32) path pins ``precision=HIGHEST``: without it an f32
    conv may run with reduced-precision multiplies (TF32 on the GPU, one
    bf16 pass on other accelerators) — ~-53 dB on the x256 decimation
    chain against an f64 oracle, invisible to the CPU test suite.  bf16 is
    available only through the explicit ``compute_dtype`` opt-in.

    Small stride-1 kernels (<= 128 taps: the audio-rate FIRs) use an
    unrolled shift-multiply-add instead — exact f32 elementwise arithmetic
    that XLA fuses into one pass, with no convolution at all.
    """
    L = taps.shape[0]
    if offset:
        z = z[..., offset:]
    if compute_dtype is None and stride == 1 and L <= 128:
        M = z.shape[-1] - L + 1
        y = taps[0] * z[..., 0:M]
        for j in range(1, L):
            y = y + taps[j] * z[..., j:j + M]
        return y.astype(z.dtype)
    batch_shape = z.shape[:-1]
    t = z.shape[-1]
    out_dtype = z.dtype
    zb = z.reshape((-1, 1, t))                       # (N, C=1, W)
    k = taps.astype(z.dtype).reshape((1, 1, L))
    if compute_dtype is not None:
        zb = zb.astype(compute_dtype)
        k = k.astype(compute_dtype)
    y = lax.conv_general_dilated(
        zb, k, window_strides=(stride,), padding="VALID",
        dimension_numbers=("NCW", "OIW", "NCW"),
        preferred_element_type=jnp.float32 if compute_dtype is not None else None,
        precision=None if compute_dtype is not None else lax.Precision.HIGHEST)
    return y.reshape(batch_shape + (y.shape[-1],)).astype(out_dtype)


def complex_strided_corr(z: jax.Array, taps: jax.Array, stride: int = 1,
                         offset: int = 0, compute_dtype=None) -> jax.Array:
    """`strided_corr` for complex ``z`` with real ``taps``: correlate the
    stacked re/im planes in one batched real conv."""
    stacked = jnp.stack([z.real, z.imag], axis=0)
    y = strided_corr(stacked, taps, stride=stride, offset=offset,
                     compute_dtype=compute_dtype)
    return lax.complex(y[0], y[1])


def first_order_recurrence(alpha, u: jax.Array, s0) -> jax.Array:
    """Parallel (log-depth) solve of s[n] = alpha·s[n-1] + u[n], s[-1] = s0.

    Linear recurrences don't need a serial scan: with pair elements
    (a, b) and composition (a1,b1)∘(a2,b2) = (a1·a2, a2·b1 + b2), a prefix
    associative_scan yields s[n] = A[n]·s0 + B[n].  ``alpha`` may be a scalar
    or per-sample array.
    """
    a = jnp.broadcast_to(jnp.asarray(alpha, u.dtype), u.shape)

    def combine(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1])

    A, B = lax.associative_scan(combine, (a, u), axis=-1)
    return A * s0 + B


def ema(alpha, x: jax.Array, init) -> jax.Array:
    """Exponential moving average y[n] = (1-a)·y[n-1] + a·x[n] (parallel)."""
    return first_order_recurrence(1.0 - alpha, alpha * x, init)


def max_affine_recurrence(c: jax.Array, u: jax.Array, v: jax.Array,
                          s0) -> jax.Array:
    """Parallel solve of s[n] = max(c[n]·s[n-1] + u[n], v[n]), s[-1] = s0.

    Maps x ↦ max(c·x + u, v) with c ≥ 0 are closed under composition:
    (f2∘f1)(x) = max(c1·c2·x + c2·u1 + u2, max(c2·v1 + u2, v2)), so a
    prefix associative_scan over (c, u, v) triples evaluates the whole
    recurrence in log depth.  This is the exact shape of "EMA with a
    snap-up floor" recurrences (S-meter attack-dominates rule,
    dsp/smeter.cpp:62-112)."""
    c = jnp.broadcast_to(jnp.asarray(c, u.dtype), u.shape)
    v = jnp.broadcast_to(jnp.asarray(v, u.dtype), u.shape)

    def combine(l, r):
        return (l[0] * r[0], r[0] * l[1] + r[1],
                jnp.maximum(r[0] * l[2] + r[1], r[2]))

    C, U, V = lax.associative_scan(combine, (c, u, v), axis=-1)
    return jnp.maximum(C * s0 + U, V)


def distance_since_last_true(flags: jax.Array, init_distance) -> jax.Array:
    """For each n, the number of samples since ``flags`` was last True
    (0 at a True sample); positions before any True continue counting from
    ``init_distance`` (the carry from the previous block)."""
    n = flags.shape[-1]
    idx = jnp.arange(1, n + 1, dtype=jnp.int32)
    # virtual last-True before the block at index -init_distance
    marked = jnp.where(flags, idx, -jnp.asarray(init_distance, jnp.int32))
    last = lax.cummax(marked, axis=marked.ndim - 1)   # cummax: no neg axes
    return idx - last


def sliding_window_max(x: jax.Array, window: int, init_tail: jax.Array):
    """Max over the trailing ``window`` samples (inclusive of current) for
    each position of ``x``; ``init_tail`` is the window-1 history.  Returns
    (per-sample maxima, new tail).

    Van Herk–Gil-Werman: two block-wise cummax passes give every sliding
    maximum in O(1) ops/sample regardless of window size (the reference
    rescans O(W) on peak expiry, dsp/agc.cpp:209-231; a naive reduce_window
    is O(W)/sample)."""
    w = int(window)
    z = jnp.concatenate([init_tail, x], axis=-1)      # length n + w - 1
    new_tail = z[..., z.shape[-1] - (w - 1):] if w > 1 else z[..., :0]
    if w == 1:
        return x, new_tail
    n = x.shape[-1]
    L = z.shape[-1]
    pad = (-L) % w
    neg_inf = jnp.asarray(-jnp.inf, z.dtype)
    zp = jnp.concatenate(
        [z, jnp.full(z.shape[:-1] + (pad,), neg_inf, z.dtype)], axis=-1)
    blocks = zp.reshape(zp.shape[:-1] + (-1, w))
    ax = blocks.ndim - 1                  # lax.cummax rejects negative axes
    pre = lax.cummax(blocks, axis=ax)                              # block prefix max
    suf = jnp.flip(lax.cummax(jnp.flip(blocks, -1), axis=ax), -1)  # block suffix max
    pre_f = pre.reshape(zp.shape)
    suf_f = suf.reshape(zp.shape)
    # window [i, i+w-1] spans at most two w-blocks: suffix of the first,
    # prefix of the second
    y = jnp.maximum(suf_f[..., :n], pre_f[..., w - 1:w - 1 + n])
    return y, new_tail


def moving_sum(x: jax.Array, window: int, init_tail: jax.Array):
    """Sum over the trailing ``window`` samples (inclusive of current), via
    cumulative-sum difference; ``init_tail`` holds window-1 history samples.
    Returns (per-sample sums, new tail)."""
    z = jnp.concatenate([init_tail, x], axis=-1)
    c = jnp.cumsum(z, axis=-1)
    zero = jnp.zeros(z.shape[:-1] + (1,), z.dtype)
    c = jnp.concatenate([zero, c], axis=-1)
    n = x.shape[-1]
    w = window
    sums = c[..., w:w + n] - c[..., :n]
    return sums, z[..., z.shape[-1] - (w - 1):]
