"""Parallel solve of second-order type-II PLL loops while locked.

Shared by the FM and SAM demodulators (dsp/fmdemod.cpp:62-89,
dsp/samdemod.cpp:78-110 in the reference, both per-sample serial loops).

Both loops have the per-sample recurrence

    err   = ±wrap(theta ∓ phase)
    freq += beta * err           (clamped to ±limit)
    phase += freq + alpha * err  (wrapped)

With the state written as x = [e, f] (phase-detector error, NCO frequency)
and psi[n] = wrap(theta[n] - theta[n-1]) the wrapped input phase increments,
the recurrence is *exactly linear* whenever the wrap and the clamp are
inactive (the locked condition):

    x[n+1] = A x[n] + [s·psi[n+1], 0],   A = [[1-a-b, -1], [b, 1]]

(s = +1 when e = theta - phase, -1 when e = -(theta + phase); proof by
induction — err[n+1] = wrap-of a quantity that equals the linear e[n+1]
while |e| <= pi).  A is constant with spectral radius sqrt(1-a) < 1, so the
block solution is a causal FIR of psi with the truncated impulse response
A^d — a convolution (fully parallel) instead of a scan.
Validity (max |e| < pi, max |f| <= clamp) is read off the linear solution
itself; the caller falls back to the exact sequential scan for blocks where
the linearization was not exact (acquisition, clamp hits, noise spikes).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

WRAP_MARGIN = 0.98          # |e| < WRAP_MARGIN*pi counts as wrap-free


def locked_loop_kernel(alpha: float, beta: float, tol: float = 1e-12,
                       max_taps: int = 4096) -> np.ndarray:
    """Powers A^d (d = 0..D-1) of the locked-loop state matrix, truncated
    where the spectral decay reaches ``tol``.  float64 host-side constant."""
    A = np.array([[1.0 - alpha - beta, -1.0], [beta, 1.0]], np.float64)
    rho = float(np.max(np.abs(np.linalg.eigvals(A))))
    if rho >= 0.9999:        # loop at/over the stability edge: no truncation
        d = max_taps
    else:
        d = int(np.ceil(np.log(tol) / np.log(rho))) + 2
        d = min(max(d, 8), max_taps)
    K = np.empty((d, 2, 2), np.float64)
    K[0] = np.eye(2)
    for i in range(1, d):
        K[i] = A @ K[i - 1]
    return K


def _conv_causal(u: jax.Array, k: jax.Array, n: int) -> jax.Array:
    """First n samples of the full 1-D convolution u*k.

    Always the FFT form: a direct f32 conv of the ~1900-tap locked-loop
    kernel must run at precision=HIGHEST to stay exact enough for the
    loop (a reduced-precision pass measured -53 dB), and the FFT form is
    numerically equivalent at solver tolerances with O(n log n) cost."""
    d = k.shape[-1]
    L = 1 << int(np.ceil(np.log2(n + d - 1)))
    out = jnp.fft.irfft(jnp.fft.rfft(u, L) * jnp.fft.rfft(k, L), L)
    return out[:n].astype(u.dtype)


def chunked_scan(step, init, guess, xs: jax.Array, chunk: int, halo: int,
                 unroll: int = 8):
    """Parallel guess-verify evaluation of a *self-synchronizing* scan.

    ``step(state, x) -> (state', y)`` with ``state`` a flat tuple of scalars
    and ``y`` a pytree of scalars; ``xs`` is the length-``n`` input block
    (``n % chunk == 0``, ``halo <= chunk``).  The block is split into
    ``C = n // chunk`` chunks evaluated concurrently as ONE scan over
    [C]-wide vector states, so the serial depth drops from ``n`` to
    ``halo + 2*chunk`` iterations:

    * pass 1 runs every chunk from the ``guess`` state through a
      ``halo``-sample warmup (the tail of the previous chunk's input) and
      its own samples, keeping only the end states; chunk 0 starts from
      the true ``init`` with its warmup frozen (it has no left context).
    * pass 2 re-runs every chunk's own samples from the pass-1 end state
      of its left neighbor (exact-by-construction for chunk 0).
    * validity = pass-2 end states are BITWISE equal to the pass-1 end
      states that pass 2's right neighbors consumed.  When that holds the
      concatenated pass-2 outputs are exactly ``lax.scan(step, init, xs)``
      (induction left→right: chunk 0's start is true, so its outputs and
      end state are true; equality hands the true state to chunk 1, …).

    Soundness needs nothing from the dynamics; *liveness* (valid coming
    back True) relies on the map forgetting its state in ≲ ``halo``
    samples — true of the clipped type-II PLL loops here (the NCO clamp
    re-synchronizes frequency exactly at the rails and the phase error
    contracts by (1-alpha) per sample; both demod loops measured to sync
    bit-exactly within ~40 samples on noise, the worst case).  Blocks
    where any boundary misses fall back to the sequential scan (caller's
    lax.cond), so a failed guess costs time, never correctness.
    """
    tmap = jax.tree_util.tree_map
    n = xs.shape[-1]
    if n % chunk or halo > chunk:
        raise ValueError(f"chunked_scan: n={n} chunk={chunk} halo={halo}")
    C = n // chunk
    main = xs.reshape(C, chunk)
    halos = jnp.concatenate(
        [jnp.zeros((1, halo), xs.dtype), main[:-1, chunk - halo:]], axis=0)
    # pass-1 inputs, time-major: [halo+chunk, C]
    xs1 = jnp.concatenate([halos, main], axis=1).T
    frz = jnp.zeros((halo + chunk, C), bool).at[:halo, 0].set(True)
    s0 = tmap(lambda g, i: jnp.broadcast_to(g, (C,)).at[0].set(i),
              tuple(guess), tuple(init))

    def body1(state, inp):
        x, f = inp
        nstate, _ = step(state, x)
        return tmap(lambda old, new: jnp.where(f, old, new), state, nstate), None

    e1, _ = lax.scan(body1, s0, (xs1, frz), unroll=unroll)

    s2 = tmap(lambda e, i: jnp.concatenate([i[None], e[:-1]]),
              e1, tuple(init))
    e2, ys = lax.scan(lambda s, x: step(s, x), s2, main.T, unroll=unroll)

    valid = jnp.array(True)
    for a, b in zip(jax.tree_util.tree_leaves(e1),
                    jax.tree_util.tree_leaves(e2)):
        valid = valid & jnp.all(a[:-1] == b[:-1])
    ys = tmap(lambda y: y.T.reshape(-1), ys)          # [chunk, C] -> [n]
    end = tmap(lambda a: a[-1], e2)
    return valid, ys, end


def solve_locked(kernel: jax.Array, beta: jax.Array, limit: jax.Array,
                 e0: jax.Array, f0: jax.Array, u: jax.Array):
    """Solve e[n], f[n] for x[n+1] = A x[n] + [u[n+1], 0], x[0] = [e0, f0].

    ``u`` has u[0] == 0 by construction (the first sample's error is e0).
    Returns (e, f_next, valid): the error sequence, the post-update
    frequency sequence f[n+1] = f[n] + beta*e[n], and the exactness flag.
    """
    n = u.shape[-1]
    e = _conv_causal(u, kernel[:, 0, 0], n)
    f = _conv_causal(u, kernel[:, 1, 0], n)
    d = min(kernel.shape[0], n)
    e = e.at[:d].add(kernel[:d, 0, 0] * e0 + kernel[:d, 0, 1] * f0)
    f = f.at[:d].add(kernel[:d, 1, 0] * e0 + kernel[:d, 1, 1] * f0)
    f_next = f + beta * e
    valid = ((jnp.max(jnp.abs(e))
              < jnp.asarray(WRAP_MARGIN * jnp.pi, u.dtype))
             & (jnp.max(jnp.abs(f_next)) <= limit))
    return e, f_next, valid
