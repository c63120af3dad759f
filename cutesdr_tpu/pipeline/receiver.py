"""The full receiver chain as one jittable streaming step.

Reference analogue: CSdrInterface::ProcessIQData + CDemodulator::ProcessData
(interface/sdrinterface.cpp:878-921, dsp/demodulator.cpp:163-215): noise
blanker → NCO-spur DC cal → [display FFT, separate] → downconvert/decimate →
FastFIR channel filter → S-meter → AGC → demod → audio.

Design:
  * mode / rates / plan are *static* configuration → one compiled XLA
    program per (mode, rate) bucket; numeric knobs (tune freq, filter H,
    AGC constants, squelch, resample ratio) are traced params updatable
    between blocks without recompiling (the reference's mutex-guarded live
    reconfiguration becomes pure param swaps);
  * the block length is decimation·1024 so the overlap-save filter sees an
    integer number of frames; every stage is shape-static;
  * state is one pytree (ReceiverState) handed across blocks — and, in the
    sharded runner, across devices;
  * probes: the testbench's 7 fixed taps (gui/testbench.h:29-38) become
    named intermediate outputs, enabled statically by cfg.probes.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from cutesdr_tpu.demod import (DEMOD_AM, DEMOD_FM, DEMOD_SAM, MODE_IDS,
                               am as am_demod, fm as fm_demod,
                               sam as sam_demod, ssb as ssb_demod)
from cutesdr_tpu.design.decimation_plan import DecimationPlan, plan_decimation
from cutesdr_tpu.ops import agc, decimator, fastfir, nco, noiseblanker, resampler, smeter
from cutesdr_tpu.types import complex_zeros

SOUNDCARD_RATE = 48000.0

# Per-mode filter-edge limits (the fixed table the GUI enforces,
# gui/mainwindow.cpp:1000-1054).  (hi_min, hi_max, low_min, low_max, symmetric)
MODE_LIMITS = {
    "am":  (500, 10000, -10000, -500, True),
    "sam": (100, 10000, -10000, -100, False),
    "fm":  (5000, 15000, -15000, -5000, True),
    "usb": (500, 20000, 0, 200, False),
    "lsb": (-200, 0, -20000, -500, False),
    "cwu": (50, 1000, -1000, -50, False),
    "cwl": (50, 1000, -1000, -50, False),
}

# Sensible per-mode default filter edges (the reference persists the user's
# last values in QSettings; these are its typical shipping defaults).
MODE_DEFAULT_CUTS = {
    "am": (-5000, 5000), "sam": (-5000, 5000), "fm": (-7500, 7500),
    "usb": (100, 2800), "lsb": (-2800, -100),
    "cwu": (-250, 250), "cwl": (-250, 250),
}


def mixdec_supported(decimation: int) -> bool:
    """Legality of the fused mix+decimate kernel for a plan
    (kernels/mixdec.py)."""
    from cutesdr_tpu.kernels import mixdec
    return mixdec.supported(decimation)


def resolve_front_end(decimation: int, front_dtype: str = "f32",
                      backend: str | None = None) -> str:
    """Resolve decimator_impl="auto" for this backend: the fused
    mix+decimate kernel on the GPU where the plan allows it (measured
    faster end to end than XLA's mix + strided conv, PERF.md "Kernel
    decisions"), the single fused XLA conv everywhere else.  The bf16
    front end stays on the XLA conv, where its bf16 operands live."""
    backend = jax.default_backend() if backend is None else backend
    if (backend == "gpu" and front_dtype == "f32"
            and mixdec_supported(decimation)):
        return "pallas"
    return "fused"


@dataclass(frozen=True)
class ReceiverConfig:
    input_rate: float = 2_000_000.0
    mode: str = "usb"
    low_cut: float | None = None       # Hz relative to tune freq
    hi_cut: float | None = None
    tune_freq: float = 0.0             # NCO offset within the passband
    cw_offset: float = 0.0             # CW tone offset (cwu/cwl)
    frames_per_block: int = 1          # fastfir frames per step (1024 out each)
    # AGC
    agc_on: bool = True
    agc_hang: bool = False
    agc_thresh_db: float = -100.0
    agc_manual_gain_db: float = 30.0
    agc_slope: float = 0.0
    agc_decay_ms: float = 200.0
    # FM squelch / de-emphasis / noise blanker
    squelch_ui: int = 0
    # one-pole de-emphasis time constant in us (0 = off, reference parity:
    # dsp/fmdemod.cpp has no de-emphasis; BASELINE config 3 names one).
    # Typical NBFM: 75 (Americas) / 50 (Europe).
    fm_deemphasis_us: float = 0.0
    nb_on: bool = False
    nb_threshold: float = 50.0
    nb_width_us: float = 2.0
    # output
    stereo: bool = False
    audio_rate: float | None = SOUNDCARD_RATE   # None: raw demod-rate audio
    # resampler quality: sinc-table interpolation lifts the audio-band SINAD
    # from ~99 dB to ~123 dB (measured, tests/test_ops.py) for one extra
    # gather+FMA — on by default (the reference's truncating lookup is
    # resampler_interp=False); periods=28 is the reference's table length
    # (dsp/fractresampler.cpp:50), longer is available but not the limiter.
    resampler_interp: bool = True
    resampler_periods: int = resampler.SINC_PERIODS
    # channel-filter sizes: smaller -> lower latency (one overlap-save frame
    # = fastfir_nfft - fastfir_ntaps + 1 output samples), larger -> sharper
    # filter + higher throughput.  Defaults match the reference (2048/1025).
    fastfir_nfft: int = fastfir.NFFT
    fastfir_ntaps: int = fastfir.NFIR
    # "auto" resolves at construction to the fastest implementation legal
    # for this config on the current backend (resolve_front_end above).
    # Explicit values pin an implementation.
    decimator_impl: str = "auto"       # "auto" | "fused" | "cascade" | "pallas"
    front_dtype: str = "f32"           # "f32" | "bf16" (fused decim conv in
                                       # bf16 w/ f32 accum; ~50 dB quant SNR)
    pallas_interpret: bool = False     # test-only: interpret the kernel on CPU
    probes: bool = False

    def __post_init__(self):
        if self.mode not in MODE_LIMITS:
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.front_dtype not in ("f32", "bf16"):
            raise ValueError(f"unknown front_dtype {self.front_dtype!r}")
        if self.decimator_impl == "auto":
            object.__setattr__(self, "decimator_impl", resolve_front_end(
                self.plan.decimation, front_dtype=self.front_dtype))
        if self.decimator_impl not in ("fused", "cascade", "pallas"):
            raise ValueError(
                f"unknown decimator_impl {self.decimator_impl!r}")
        if self.front_dtype == "bf16" and self.decimator_impl != "fused":
            raise ValueError("front_dtype='bf16' requires decimator_impl='fused'")
        if self.decimator_impl == "pallas":
            if not mixdec_supported(self.plan.decimation):
                raise ValueError(f"decimator_impl='pallas' does not support "
                                 f"decimation {self.plan.decimation}")
            if not self.pallas_interpret and jax.default_backend() != "gpu":
                raise ValueError("decimator_impl='pallas' compiles only for "
                                 "the GPU; pallas_interpret=True runs it "
                                 "interpreted (tests)")
        lo, hi = MODE_DEFAULT_CUTS[self.mode]
        if self.low_cut is None:
            object.__setattr__(self, "low_cut", float(lo))
        if self.hi_cut is None:
            object.__setattr__(self, "hi_cut", float(hi))

    @cached_property
    def max_output_bw(self) -> float:
        """Demod-driven decimation target: LSB-ish modes key off the low-edge
        limit, others off the high-edge limit (dsp/demodulator.cpp:116-119)."""
        hi_min, hi_max, low_min, low_max, _ = MODE_LIMITS[self.mode]
        if self.mode in ("lsb", "cwl"):
            return float(-low_min)
        return float(hi_max)

    @cached_property
    def plan(self) -> DecimationPlan:
        return plan_decimation(self.input_rate, self.max_output_bw)

    @property
    def output_rate(self) -> float:
        return self.plan.out_rate

    @property
    def fastfir_valid(self) -> int:
        """Decimated samples per overlap-save frame (= intrinsic latency)."""
        return fastfir.valid_per_frame(self.fastfir_nfft, self.fastfir_ntaps)

    @property
    def block_size(self) -> int:
        """Input samples per step: frames_per_block overlap-save frames."""
        return self.plan.decimation * self.fastfir_valid * self.frames_per_block

    @property
    def latency_sec(self) -> float:
        return self.block_size / self.input_rate

    @property
    def audio_block_cap(self) -> int:
        n_demod = self.fastfir_valid * self.frames_per_block
        if self.audio_rate is None:
            return n_demod
        return resampler.max_out_for(n_demod, self.output_rate / self.audio_rate)

    @property
    def mode_id(self) -> int:
        return MODE_IDS[self.mode]


class ReceiverParams(NamedTuple):
    nco: nco.NcoParams
    dec: Any                    # FusedParams or None (cascade keeps taps static)
    chan_filter: fastfir.FastFirParams
    agc: agc.AgcParams
    smeter: smeter.SMeterParams
    demod: Any
    resamp: Any                 # ResamplerParams or None
    dc_offset: jax.Array        # NCO-spur I/Q cal, complex scalar
    audio_gain: jax.Array       # volume (linear)


class ReceiverState(NamedTuple):
    nco: nco.NcoCarry
    blanker: Any
    dec: Any
    chan_filter: fastfir.FastFirCarry
    agc: agc.AgcCarry
    smeter: smeter.SMeterCarry
    demod: Any
    resamp: Any


class StepOutput(NamedTuple):
    audio: jax.Array            # [audio_block_cap] (real) or complex (stereo)
    n_audio: jax.Array          # valid audio samples
    smeter_ave_db: jax.Array
    smeter_peak_db: jax.Array
    probes: Any                 # dict of taps if cfg.probes else None


def _make_mixdec(cfg: ReceiverConfig):
    from cutesdr_tpu.kernels.mixdec import MixDecimate
    return MixDecimate(cfg.plan, cfg.tune_freq - cfg.cw_offset,
                       interpret=cfg.pallas_interpret)


def _demod_init(cfg: ReceiverConfig, rdtype):
    fs = cfg.plan.out_rate
    m = cfg.mode_id
    if m == DEMOD_AM:
        return am_demod.init((cfg.hi_cut - cfg.low_cut) / 2.0, fs, rdtype)
    if m == DEMOD_SAM:
        return sam_demod.init(fs, rdtype)
    if m == DEMOD_FM:
        return fm_demod.init(fs, cfg.squelch_ui, cfg.hi_cut,
                             deemphasis_us=cfg.fm_deemphasis_us,
                             rdtype=rdtype)
    return None, None           # ssb/cw: stateless


def _demod_apply(cfg: ReceiverConfig, params, carry, x, probes=None):
    """Demodulate one block; with a probes dict and a PLL mode (SAM/FM,
    mono) also records the P6 PLL-internals tap — the reference's ad-hoc
    PROFILE_6 sites (dsp/samdemod.cpp:92, dsp/fmdemod.cpp:120): the
    per-sample phase error x100."""
    m = cfg.mode_id
    if m == DEMOD_AM:
        f = am_demod.process_stereo if cfg.stereo else am_demod.process
        return f(params, carry, x)
    if m == DEMOD_SAM:
        if probes is not None and not cfg.stereo:
            c, y, p6, tier = sam_demod.process_probed(params, carry, x)
            probes["p6_pll"] = p6
            probes["pll_tier"] = tier
            return c, y
        f = sam_demod.process_stereo if cfg.stereo else sam_demod.process
        return f(params, carry, x)
    if m == DEMOD_FM:
        if probes is not None and not cfg.stereo:
            c, y, p6, tier = fm_demod.process_probed(params, carry, x)
            probes["p6_pll"] = p6
            probes["pll_tier"] = tier
            return c, y
        f = fm_demod.process_stereo if cfg.stereo else fm_demod.process
        return f(params, carry, x)
    f = ssb_demod.process_stereo if cfg.stereo else ssb_demod.process
    return f(carry, x)


def init(cfg: ReceiverConfig, rdtype=jnp.float32):
    """Build (params, state) for a configuration.  Pure host-side."""
    cdtype = jax.lax.complex(jnp.zeros((), rdtype), jnp.zeros((), rdtype)).dtype
    fs_in, fs_out = cfg.input_rate, cfg.plan.out_rate

    # mixer shifts a tone at f_nco to DC, so the tuned station must land at
    # +cw_offset inside the (offset-shifted) channel filter -> f_nco = tune - off
    nco_p, nco_c = nco.init(cfg.tune_freq - cfg.cw_offset, fs_in)
    if cfg.decimator_impl == "fused":
        dec_p, dec_c = decimator.fused_init(cfg.plan, cdtype, rdtype)
    elif cfg.decimator_impl == "pallas":
        md = _make_mixdec(cfg)
        dec_p, dec_c = md.params, md.init_carry()
    else:
        dec_p, dec_c = None, decimator.cascade_init(cfg.plan, cdtype)
    ff_p, ff_c = fastfir.init(cfg.low_cut, cfg.hi_cut, cfg.cw_offset,
                              fs_out, cdtype, nfft=cfg.fastfir_nfft,
                              ntaps=cfg.fastfir_ntaps)
    agc_cfg = agc.AgcConfig(cfg.agc_on, cfg.agc_hang, fs_out)
    agc_p = agc.make_params(agc_cfg, cfg.agc_thresh_db, cfg.agc_manual_gain_db,
                            cfg.agc_slope, cfg.agc_decay_ms, rdtype)
    agc_c = agc.init_carry(agc_cfg, complex_input=True, rdtype=rdtype)
    sm_p, sm_c = smeter.init(fs_out, rdtype)
    dm_p, dm_c = _demod_init(cfg, rdtype)

    if cfg.audio_rate is not None:
        rs_p, rs_c = resampler.init(fs_out / cfg.audio_rate,
                                    complex_input=cfg.stereo, rdtype=rdtype,
                                    periods=cfg.resampler_periods)
    else:
        rs_p, rs_c = None, None

    nb_cfg = noiseblanker.BlankerConfig(cfg.nb_on, cfg.nb_threshold,
                                        cfg.nb_width_us, fs_in)
    nb_c = noiseblanker.init_carry(nb_cfg, cdtype, rdtype) if cfg.nb_on else None

    params = ReceiverParams(
        nco=nco_p, dec=dec_p, chan_filter=ff_p, agc=agc_p, smeter=sm_p,
        demod=dm_p, resamp=rs_p,
        dc_offset=complex_zeros((), cdtype),
        audio_gain=jnp.asarray(1.0, rdtype))
    state = ReceiverState(
        nco=nco_c, blanker=nb_c, dec=dec_c, chan_filter=ff_c, agc=agc_c,
        smeter=sm_c, demod=dm_c, resamp=rs_c)
    return params, state


def _fit_leaf(old: jax.Array, new: jax.Array) -> jax.Array:
    """Carry an old state leaf into a new template: identical shape/dtype
    passes through; 1-D history buffers keep their most recent samples at
    the end (delay lines / filter tails store newest-last); anything else
    takes the fresh template."""
    old = jnp.asarray(old)
    new = jnp.asarray(new)
    if old.shape == new.shape and old.dtype == new.dtype:
        return old
    if old.ndim == 1 and new.ndim == 1 and old.dtype == new.dtype:
        n = min(old.shape[0], new.shape[0])
        if n == 0:
            return new
        return new.at[new.shape[0] - n:].set(old[old.shape[0] - n:])
    return new


def _fit_tree(old, new):
    """_fit_leaf over a pytree; falls back to the fresh template when the
    tree structures differ."""
    try:
        return jax.tree_util.tree_map(_fit_leaf, old, new)
    except ValueError:
        return new


def migrate_state(old_cfg: ReceiverConfig, old: ReceiverState,
                  new_cfg: ReceiverConfig,
                  fresh: ReceiverState) -> ReceiverState:
    """Carry stream state across a mode / rate / filter-size change.

    The reference retunes and changes demod mode live against a running
    stream under mutexes (dsp/demodulator.cpp:107-157); a mode change there
    rebuilds the decimation chain and re-instantiates the demodulator
    (fresh delay lines) but the stream position and oscillator phase roll
    on.  Here the same semantics, made explicit:

    * NCO phase continues when the input rate is unchanged (the reference's
      oscillator keeps phase across retunes, dsp/downconvert.cpp:98-107);
    * input-rate histories (noise blanker, decimator tail) are *rate-exact*
      regardless of the decimation plan, so their most recent samples carry
      over even when the plan changes (keep-latest, zero-padded);
    * output-rate histories (channel filter tail, AGC delay/mag windows,
      demod filter tails, resampler tail) carry over only when the
      decimated rate is unchanged — at a new rate they restart, giving one
      bounded fill-in transient exactly like the reference's rebuilt chain;
    * scalar level trackers (AGC attack/decay averages, S-meter averages,
      resampler fractional time) always carry, so gain/meters don't slam.
    """
    same_in = old_cfg.input_rate == new_cfg.input_rate
    same_out = old_cfg.output_rate == new_cfg.output_rate
    same_mode = old_cfg.mode == new_cfg.mode

    nco_c = old.nco if same_in else fresh.nco
    if old_cfg.nb_on and new_cfg.nb_on and same_in:
        nb_c = _fit_tree(old.blanker, fresh.blanker)
    else:
        nb_c = fresh.blanker
    if same_in and old_cfg.decimator_impl == new_cfg.decimator_impl:
        dec_c = _fit_tree(old.dec, fresh.dec)
    else:
        dec_c = fresh.dec
    chan_c = _fit_tree(old.chan_filter, fresh.chan_filter) if same_out \
        else fresh.chan_filter

    if same_out:
        agc_c = _fit_tree(old.agc, fresh.agc)
    else:  # keep the level trackers, restart the rate-sized windows
        agc_c = fresh.agc._replace(attack_ave=old.agc.attack_ave,
                                   decay_ave=old.agc.decay_ave)
    sm_c = old.smeter

    dm_c = _fit_tree(old.demod, fresh.demod) if same_mode else fresh.demod

    if (old.resamp is not None and fresh.resamp is not None):
        rs_c = _fit_tree(old.resamp, fresh.resamp) if same_out \
            else fresh.resamp._replace(t0=old.resamp.t0)
    else:
        rs_c = fresh.resamp

    return ReceiverState(nco=nco_c, blanker=nb_c, dec=dec_c,
                         chan_filter=chan_c, agc=agc_c, smeter=sm_c,
                         demod=dm_c, resamp=rs_c)


def _levels(cfg: ReceiverConfig, params: ReceiverParams,
            state: ReceiverState, filt: jax.Array):
    """S-meter + AGC on the channel-filtered samples."""
    agc_cfg = agc.AgcConfig(cfg.agc_on, cfg.agc_hang, cfg.plan.out_rate)
    sm_c, _ = smeter.process(params.smeter, state.smeter, filt)
    agc_c, leveled = agc.process(agc_cfg, params.agc, state.agc, filt)
    return sm_c, agc_c, leveled


def _tail(cfg: ReceiverConfig, params: ReceiverParams, state: ReceiverState,
          audio: jax.Array, sm_c, probes=None, fast: bool = False):
    """Resample → gain → output assembly (post-demod).

    ``fast=True`` (single-stream call sites only) hands the resampler the
    exact nominal ratio so the static-polyphase conv path runs whenever
    the rate-lock correction is zero; under vmap the inner lax.cond would
    lower to select and execute BOTH paths, so the bank path keeps the
    banded evaluator.  The conv path carries a fixed overhead, so blocks
    below 131072 audio samples keep the banded path too (a threshold not
    yet re-measured on the GPU)."""
    if cfg.audio_rate is not None:
        cap = resampler.max_out_for(audio.shape[-1],
                                    cfg.output_rate / cfg.audio_rate)
        use_rat = fast and audio.shape[-1] >= 131072
        rs_c, audio_out, n_audio = resampler.process(
            params.resamp, state.resamp, audio, cap,
            interp=cfg.resampler_interp,
            rational=(resampler.rational_for(cfg.output_rate,
                                             cfg.audio_rate)
                      if use_rat else None))
        audio_out = audio_out * params.audio_gain
        if probes is not None:
            probes["p5_resampled"] = audio_out
    else:
        rs_c, audio_out = state.resamp, audio * params.audio_gain
        n_audio = jnp.asarray(audio.shape[-1], jnp.int32)

    sm_c, peak = smeter.get_peak(sm_c)
    out = StepOutput(audio=audio_out, n_audio=n_audio,
                     smeter_ave_db=smeter.get_ave(sm_c),
                     smeter_peak_db=peak, probes=probes)
    return sm_c, rs_c, out


def back_end(cfg: ReceiverConfig, params: ReceiverParams,
             state: ReceiverState, filt: jax.Array, probes=None):
    """Audio-rate tail of the chain (S-meter → AGC → demod → resample).

    Runs on channel-filtered samples at the decimated rate; shared between
    the single-chip step and the time-sharded runner (where the front-end is
    sharded and this tail runs replicated on the gathered audio-rate data —
    its compute is negligible next to the wideband front-end)."""
    sm_c, agc_c, leveled = _levels(cfg, params, state, filt)
    if probes is not None:
        probes["p3_agc"] = leveled

    dm_c, audio = _demod_apply(cfg, params.demod, state.demod, leveled,
                               probes)
    if probes is not None:
        probes["p4_demod"] = audio

    sm_c, rs_c, out = _tail(cfg, params, state, audio, sm_c, probes,
                            fast=True)
    return sm_c, agc_c, dm_c, rs_c, out


def _front_prefilter(cfg: ReceiverConfig, params: ReceiverParams,
                     state: ReceiverState, iq: jax.Array, probes=None):
    """Blanker → DC cal → mix+decimate (everything before the channel
    filter)."""
    if cfg.nb_on:
        nb_cfg = noiseblanker.BlankerConfig(cfg.nb_on, cfg.nb_threshold,
                                            cfg.nb_width_us, cfg.input_rate)
        nb_c, iq = noiseblanker.process(nb_cfg, state.blanker, iq)
        if probes is not None:
            probes["p7_blanker"] = iq
    else:
        nb_c = state.blanker

    if cfg.decimator_impl == "pallas":
        # fused NCO-mix + polyphase decimation in one Pallas kernel; the
        # NCO params/carry are unused (phase lives in the kernel carry).
        # Plane-native entry: the DC cal rides in the kernel's epilogue
        # and the re/im extraction cancels against the caller's
        # lax.complex, so the wideband stream is never copied.
        nco_c = state.nco
        dec_c, base = _make_mixdec(cfg).process_planes(
            params.dec, state.dec, jnp.real(iq), jnp.imag(iq),
            params.dc_offset)
    else:
        iq = iq - params.dc_offset        # NCO-spur DC cal
        nco_c, mixed = nco.process(params.nco, state.nco, iq)
        if cfg.decimator_impl == "fused":
            cdt = jnp.bfloat16 if cfg.front_dtype == "bf16" else None
            dec_c, base = decimator.fused_process(cfg.plan, params.dec,
                                                  state.dec, mixed,
                                                  compute_dtype=cdt)
        else:
            dec_c, base = decimator.cascade_process(cfg.plan, state.dec, mixed)
    if probes is not None:
        probes["p1_downconvert"] = base
    return nb_c, nco_c, dec_c, base


def _front(cfg: ReceiverConfig, params: ReceiverParams,
           state: ReceiverState, iq: jax.Array, probes=None):
    """Wideband front end: blanker → DC cal → mix+decimate → channel filter.
    Returns the updated front-end carries and the filtered baseband."""
    nb_c, nco_c, dec_c, base = _front_prefilter(cfg, params, state, iq,
                                                probes)
    ff_c, filt = fastfir.process(params.chan_filter, state.chan_filter, base)
    if probes is not None:
        probes["p2_fastfir"] = filt
    return nb_c, nco_c, dec_c, ff_c, filt


def receiver_step(cfg: ReceiverConfig, params: ReceiverParams,
                  state: ReceiverState,
                  iq: jax.Array) -> tuple[ReceiverState, StepOutput]:
    """Process one input block of cfg.block_size complex samples."""
    probes = {} if cfg.probes else None
    nb_c, nco_c, dec_c, ff_c, filt = _front(cfg, params, state, iq, probes)
    sm_c, agc_c, dm_c, rs_c, out = back_end(cfg, params, state, filt, probes)
    new_state = ReceiverState(nco=nco_c, blanker=nb_c, dec=dec_c,
                              chan_filter=ff_c, agc=agc_c, smeter=sm_c,
                              demod=dm_c, resamp=rs_c)
    return new_state, out


def _demod_apply_batch(cfg: ReceiverConfig, params, carry, x):
    """Demod a channel bank (leading channel axis on params/carry/x).

    FM/SAM take the bank-voted PLL path (one real lax.cond over the whole
    bank instead of per-channel cond→select under vmap, which would execute
    the sequential scan every step); the other modes are plain vmap."""
    m = cfg.mode_id
    if m == DEMOD_SAM:
        f = (sam_demod.process_batch_stereo if cfg.stereo
             else sam_demod.process_batch)
        return f(params, carry, x)
    if m == DEMOD_FM:
        f = (fm_demod.process_batch_stereo if cfg.stereo
             else fm_demod.process_batch)
        return f(params, carry, x)
    return jax.vmap(lambda p, c, xx: _demod_apply(cfg, p, c, xx))(
        params, carry, x)


def bank_receiver_step(cfg: ReceiverConfig, params: ReceiverParams,
                       state: ReceiverState, iq: jax.Array,
                       shared_input: bool = True
                       ) -> tuple[ReceiverState, StepOutput]:
    """Batched receiver step for channel banks: params/state carry a leading
    channel axis; ``iq`` is one shared wideband block (shared_input=True,
    ChannelBank) or a per-channel stack (False, StackedReceiver).

    Equivalent to vmap(receiver_step) except the FM/SAM PLL runs through the
    bank-wide validity vote (_demod_apply_batch), keeping the parallel
    locked-loop solve effective under batching.  With cfg.probes the taps
    come back with a leading channel axis (p1/p2/p3 per channel; p4/p5 via
    the vmapped tail) — the testbench probe methodology (SURVEY.md section
    4) applied to the whole bank at once."""
    in_axes = (0, 0, None if shared_input else 0)

    def front(p, s, x):
        pr = {} if cfg.probes else None
        nb_c, nco_c, dec_c, ff_c, filt = _front(cfg, p, s, x, pr)
        return nb_c, nco_c, dec_c, ff_c, filt, pr

    nb_c, nco_c, dec_c, ff_c, filt, probes = jax.vmap(
        front, in_axes=in_axes)(params, state, iq)
    # S-meter vmaps cleanly (pure parallel); the AGC goes through the
    # bank-voted batch path so its scan fallback stays a real branch
    agc_cfg = agc.AgcConfig(cfg.agc_on, cfg.agc_hang, cfg.plan.out_rate)
    sm_c, _ = jax.vmap(lambda p, s, f: smeter.process(p.smeter, s.smeter, f))(
        params, state, filt)
    agc_c, leveled = agc.process_batch(agc_cfg, params.agc, state.agc, filt)
    if cfg.probes:
        probes["p3_agc"] = leveled
    dm_c, audio = _demod_apply_batch(cfg, params.demod, state.demod, leveled)
    if cfg.probes:
        probes["p4_demod"] = audio

    sm_c, rs_c, out = jax.vmap(
        lambda p, s, a, sc: _tail(cfg, p, s, a, sc,
                                  {} if cfg.probes else None))(
        params, state, audio, sm_c)
    if cfg.probes:
        probes.update(out.probes)
        out = out._replace(probes=probes)
    new_state = ReceiverState(nco=nco_c, blanker=nb_c, dec=dec_c,
                              chan_filter=ff_c, agc=agc_c, smeter=sm_c,
                              demod=dm_c, resamp=rs_c)
    return new_state, out


def split_complex_leaves(tree):
    """Device-side: complex leaves -> [..., 2] float stacks, the f32-plane
    host contract of process_host (join_complex_pair inverts it)."""
    def f(a):
        if a is not None and jnp.iscomplexobj(a):
            return jnp.stack([a.real, a.imag], axis=-1)
        return a
    return jax.tree_util.tree_map(f, tree)


def join_complex_pair(a):
    """Host-side inverse of split_complex_leaves for one leaf that is known
    to have been complex: [..., 2] float -> complex64 numpy."""
    import numpy as np
    a = np.asarray(a)
    return (a[..., 0] + 1j * a[..., 1]).astype(np.complex64)


# --- live param updates as pure (cfg, params) -> params functions, shared
#     between Receiver and the dual-RX DiversityReceiver ---
def tune_params(cfg: ReceiverConfig, params: ReceiverParams,
                freq_hz: float) -> ReceiverParams:
    inc = nco.phase_increment(freq_hz - cfg.cw_offset, cfg.input_rate)
    params = params._replace(
        nco=params.nco._replace(phase_inc=jnp.asarray(inc)))
    if cfg.decimator_impl == "pallas":
        # the pallas kernel owns the oscillator
        params = params._replace(
            dec=params.dec._replace(phase_inc=jnp.asarray(inc)))
    return params


def filter_params(cfg: ReceiverConfig, params: ReceiverParams,
                  low_cut: float, hi_cut: float) -> ReceiverParams:
    return params._replace(
        chan_filter=fastfir.retune(params.chan_filter, low_cut, hi_cut,
                                   cfg.cw_offset, cfg.output_rate,
                                   ntaps=cfg.fastfir_ntaps))


def ratio_params(params: ReceiverParams, ratio: float) -> ReceiverParams:
    if params.resamp is None:
        return params
    return params._replace(resamp=resampler.set_rate(params.resamp, ratio))


def volume_params(params: ReceiverParams, vol_0_99: int) -> ReceiverParams:
    # 0..99 -> -50..0 dB, 0 = mute (interface/soundout.cpp:181-190)
    g = 0.0 if vol_0_99 <= 0 else 10.0 ** ((min(vol_0_99, 99) - 99) / 39.2)
    return params._replace(
        audio_gain=jnp.asarray(g, params.audio_gain.dtype))


@dataclass
class Receiver:
    """Convenience stateful wrapper: owns params/state, jits the step.

    Two entry points:
      * process(iq)      — device/CPU path, complex64 in, StepOutput out
        (complex leaves stay complex).  Use on CPU or with device-resident
        arrays.
      * process_host(iq) — production host path: ships the host block as
        float32 re/im planes (the radio's wire format is planar too), forms
        the complex stream inside jit, and splits any complex outputs
        (stereo audio, probe taps) into [..., 2] float stacks for
        transfer; reassemble with join_complex_pair.
    """
    cfg: ReceiverConfig
    rdtype: Any = jnp.float32

    def __post_init__(self):
        self.params, self.state = init(self.cfg, self.rdtype)
        self._step = jax.jit(
            lambda p, s, x: receiver_step(self.cfg, p, s, x))
        self._step_planes = jax.jit(self._planes_step)

    def _planes_step(self, p, s, re, im):
        if re.dtype != jnp.float32:
            # int16 wire planes: halve the H2D bytes and cast on device —
            # the radio's 16-bit format (interface/netiobase.cpp:59-60)
            # carried through to the device untouched; values are already in
            # the reference's +-32767 full-scale convention, so the cast
            # is exact (no scaling needed)
            re = re.astype(jnp.float32)
            im = im.astype(jnp.float32)
        s2, out = receiver_step(self.cfg, p, s, jax.lax.complex(re, im))
        return s2, split_complex_leaves(out)

    def process(self, iq: jax.Array) -> StepOutput:
        self.state, out = self._step(self.params, self.state, iq)
        return out

    def process_host(self, iq) -> StepOutput:
        """Process one host block (numpy, any complex dtype).  Complex
        output leaves come back as [..., 2] float stacks (see class doc)."""
        import numpy as np
        re = np.ascontiguousarray(np.real(iq), np.float32)
        im = np.ascontiguousarray(np.imag(iq), np.float32)
        self.state, out = self._step_planes(self.params, self.state, re, im)
        return out

    def process_planes(self, re, im) -> StepOutput:
        """Process one block given as separate re/im planes — float32, or
        int16 straight off the radio's 16-bit wire format (half the H2D
        bytes; cast to f32 on device).  Planes may be host numpy arrays or
        already-transferred device arrays (the ingest worker's
        double-buffered device_put path)."""
        self.state, out = self._step_planes(self.params, self.state, re, im)
        return out

    # --- live reconfiguration (traced-param updates, no recompile) ---
    def set_tune_freq(self, freq_hz: float) -> None:
        self.params = tune_params(self.cfg, self.params, freq_hz)

    def set_filter(self, low_cut: float, hi_cut: float) -> None:
        self.params = filter_params(self.cfg, self.params, low_cut, hi_cut)

    def set_agc(self, thresh_db=None, manual_gain_db=None, slope=None,
                decay_ms=None) -> None:
        c = self.cfg
        agc_cfg = agc.AgcConfig(c.agc_on, c.agc_hang, c.plan.out_rate)
        self.params = self.params._replace(agc=agc.make_params(
            agc_cfg,
            c.agc_thresh_db if thresh_db is None else thresh_db,
            c.agc_manual_gain_db if manual_gain_db is None else manual_gain_db,
            c.agc_slope if slope is None else slope,
            c.agc_decay_ms if decay_ms is None else decay_ms, self.rdtype))

    def set_resample_ratio(self, ratio: float) -> None:
        self.params = ratio_params(self.params, ratio)

    def set_volume(self, vol_0_99: int) -> None:
        self.params = volume_params(self.params, vol_0_99)

    def set_dc_offset(self, i_off: float, q_off: float) -> None:
        rd = jnp.real(self.params.dc_offset).dtype
        self.params = self.params._replace(dc_offset=jax.lax.complex(
            jnp.asarray(i_off, rd), jnp.asarray(q_off, rd)))

    # --- structural reconfiguration (new program, migrated stream state) ---
    def reconfigure(self, new_cfg: ReceiverConfig,
                    preserve_gain: bool = True) -> None:
        """Switch to a new static configuration (mode / rate / filter
        sizes) without dropping the stream: carries migrate via
        migrate_state, traced knobs (volume, dc cal) are preserved, and
        the jitted step is rebuilt (XLA caches per static config, so
        switching back is compile-free).  The reference's live SetDemod
        under mutex (dsp/demodulator.cpp:107-157), minus the glitch."""
        old_cfg, old_state = self.cfg, self.state
        gain, dc = self.params.audio_gain, self.params.dc_offset
        self.cfg = new_cfg
        self.params, fresh = init(new_cfg, self.rdtype)
        if preserve_gain:
            self.params = self.params._replace(audio_gain=gain, dc_offset=dc)
        self.state = migrate_state(old_cfg, old_state, new_cfg, fresh)
        self._step = jax.jit(
            lambda p, s, x: receiver_step(self.cfg, p, s, x))
        self._step_planes = jax.jit(self._planes_step)
