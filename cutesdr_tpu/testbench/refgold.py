"""Replay the reference-binary fixtures through the production f32 chain.

tests/fixtures/refgold_<name>.npz hold audio produced by the reference's
own compiled DSP chain (tests/make_refgold.py) with the IQ that drove it
and a pinned SNR bound.  Each replay here returns ``(snr_db, bound_db)``;
the CPU test suite (tests/test_refgold_fixtures.py) and the on-card smoke
run (chip_smoke.py) assert ``snr_db > bound_db`` with the same numbers.
"""

from __future__ import annotations

import json
import os

import numpy as np

FIXDIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "fixtures")
NAMES = ("usb", "lsb", "cwu", "am", "sam", "fm", "usb2m")


def load(name: str):
    """(arrays, meta) of one fixture file."""
    d = np.load(os.path.join(FIXDIR, f"{name}.npz"))
    return d, json.loads(str(d["meta"]))


def snr_db(want, got, skip: int = 0) -> float:
    n = min(len(want), len(got))
    err = got[skip:n] - want[skip:n]
    return float(10 * np.log10(np.mean(np.abs(want[skip:n]) ** 2)
                               / max(np.mean(np.abs(err) ** 2), 1e-30)))


def _run_blocks(cfg, re, im, n_blocks):
    """Receiver.process_host over n_blocks fixture blocks; complex (stereo)
    audio comes back joined."""
    from cutesdr_tpu.pipeline.receiver import Receiver, join_complex_pair

    rx = Receiver(cfg)
    got = []
    for b in range(n_blocks):
        sl = slice(b * cfg.block_size, (b + 1) * cfg.block_size)
        out = rx.process_host(re[sl] + 1j * im[sl])
        a = np.asarray(out.audio)
        if cfg.stereo:
            a = join_complex_pair(a)
            a = np.stack([a.real, a.imag], axis=-1)
        got.append(a.astype(np.float64))
    return np.concatenate(got)


def production(name: str) -> tuple[float, float]:
    """One mono mode chain (refgold_<name>) against the reference audio."""
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    ref, meta = load(f"refgold_{name}")
    gold, _ = load(f"golden_{name}")
    cfg = ReceiverConfig(input_rate=meta["input_rate"], mode=meta["mode"],
                         tune_freq=meta["tune_freq"],
                         cw_offset=meta["cw_offset"],
                         audio_rate=None, agc_on=True, agc_thresh_db=-90.0)
    got = _run_blocks(cfg, gold["iq_re"], gold["iq_im"], meta["n_blocks"])
    return snr_db(ref["audio"], got, meta["skip"]), meta["min_snr_prod_db"]


def stereo_sam() -> tuple[float, float]:
    """Stereo SAM (Hilbert sideband split, dsp/samdemod.cpp:149-156)."""
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    d, meta = load("refgold_sam_stereo")
    cfg = ReceiverConfig(input_rate=meta["input_rate"], mode="sam",
                         tune_freq=meta["tune_freq"], audio_rate=None,
                         stereo=True, agc_on=True, agc_thresh_db=-90.0)
    got = _run_blocks(cfg, d["iq_re"], d["iq_im"], meta["n_blocks"])
    return snr_db(d["audio"], got, meta["skip"]), meta["min_snr_prod_db"]


RESAMPLER_MIN_DB = 110.0
BLANKER_MIN_DB = 140.0


def resampler() -> tuple[float, float, int, int]:
    """ops/resampler in reference-exact mode (interp=False) against
    CFractResampler on the same 62.5k->48k stream; also returns the two
    output counts, which must be equal."""
    import jax.numpy as jnp

    from cutesdr_tpu.ops import resampler as R

    d, meta = load("refgold_resampler")
    x = d["iq_re"].astype(np.float32) + 1j * d["iq_im"].astype(np.float32)
    ref = d["out_re"] + 1j * d["out_im"]
    chunk = meta["chunk"]
    p, c = R.init(meta["rate"], complex_input=True)
    got = []
    for pos in range(0, len(x), chunk):
        cap = R.max_out_for(chunk, meta["rate"])
        c, y, nv = R.process(p, c, jnp.asarray(x[pos:pos + chunk]),
                             cap, interp=False)
        got.append(np.asarray(y)[:int(nv)])
    got = np.concatenate(got)
    return (snr_db(ref, got, meta["skip"]), RESAMPLER_MIN_DB, len(got),
            len(ref))


def blanker() -> tuple[float, float, bool]:
    """ops/noiseblanker against CNoiseProc on an impulse-laden stream;
    also returns whether the blanked-sample sets are identical."""
    import jax.numpy as jnp

    from cutesdr_tpu.ops import noiseblanker as NB

    d, meta = load("refgold_blanker")
    x = d["iq_re"].astype(np.float32) + 1j * d["iq_im"].astype(np.float32)
    ref = d["out_re"] + 1j * d["out_im"]
    cfg = NB.BlankerConfig(True, meta["threshold"], meta["width_us"],
                           meta["fs"])
    carry = NB.init_carry(cfg, jnp.complex64, jnp.float32)
    got = []
    for pos in range(0, len(x), meta["chunk"]):
        carry, y = NB.process(cfg, carry,
                              jnp.asarray(x[pos:pos + meta["chunk"]]))
        got.append(np.asarray(y))
    got = np.concatenate(got)
    skip = meta["skip"]
    same_set = bool(np.array_equal(np.abs(got[skip:]) == 0,
                                   np.abs(ref[skip:]) == 0))
    return snr_db(ref, got, skip), BLANKER_MIN_DB, same_set
