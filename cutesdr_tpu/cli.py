"""Command-line entry point.

Reference analogue: the Qt application shell (gui/main.cpp + MainWindow
orchestration) — here a headless CLI:

  cutesdr-tpu run       stream a source through the receiver to a WAV file
  cutesdr-tpu spectrum  print/export averaged spectrum frames from a source
  cutesdr-tpu discover  find RFSPACE radios on the LAN
  cutesdr-tpu bench     run the throughput benchmark
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_receiver_args(p: argparse.ArgumentParser,
                       default_latency_ms: float = 0.0) -> None:
    p.add_argument("--source", default="sweep",
                   help="'sweep', 'tone:FREQ', 'file:PATH[:fmt]', "
                        "'udp:PORT' (native ingest), or "
                        "'radio:HOST[:PORT]' (live RFSPACE radio)")
    p.add_argument("--radio-type", default="netsdr",
                   choices=["netsdr", "sdrip", "sdriq", "sdr14"],
                   help="device personality for radio: sources")
    p.add_argument("--bw-index", type=int, default=3,
                   help="radio bandwidth index 0-3 (sets the sample rate "
                        "from the device's rate table; overrides --fs)")
    p.add_argument("--rf-gain", type=int, default=0,
                   help="RF attenuation: 0/-10/-20/-30 dB")
    p.add_argument("--center", type=float, default=None,
                   help="radio RF center frequency Hz; with radio: sources "
                        "--freq is the absolute station frequency and the "
                        "NCO mixes only --freq minus --center (default: "
                        "center on the station)")
    p.add_argument("--fs", type=float, default=2e6, help="input sample rate")
    p.add_argument("--mode", default="usb",
                   choices=["am", "sam", "fm", "usb", "lsb", "cwu", "cwl"])
    p.add_argument("--freq", type=float, default=100e3,
                   help="tune frequency within the passband (Hz)")
    p.add_argument("--low-cut", type=float, default=None)
    p.add_argument("--hi-cut", type=float, default=None)
    p.add_argument("--cw-offset", type=float, default=0.0)
    p.add_argument("--agc-off", action="store_true")
    p.add_argument("--nb-on", action="store_true")
    p.add_argument("--nb-threshold", type=float, default=50.0,
                   help="noise blanker threshold 0-99 (UI scale)")
    p.add_argument("--nb-width-us", type=float, default=2.0,
                   help="noise blanker blank width, microseconds")
    p.add_argument("--squelch", type=int, default=0)
    p.add_argument("--fm-deemphasis-us", type=float, default=0.0,
                   help="FM one-pole de-emphasis tau in us (0 = off; "
                        "75 Americas / 50 Europe)")
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--volume", type=int, default=99)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--probe", type=int, default=0,
                   help="dump probe tap N (1..7) to probeN.npy")
    p.add_argument("--target-latency-ms", type=float,
                   default=default_latency_ms,
                   help="shrink the channel filter until the pipeline "
                        "latency meets this target; 0 = max-throughput "
                        "2048/1025 filter sizes.  run/serve default to the "
                        "reference's ~10 ms operating point "
                        "(dsp/demodulator.cpp:145-146), falling back to "
                        "the smallest filter if 10 ms is unreachable; an "
                        "explicit target that can't be met is an error")
    p.add_argument("--front-dtype", default="f32", choices=["f32", "bf16"],
                   help="decimation-conv compute dtype (bf16 halves HBM "
                        "traffic, ~67 dB SNR vs f32)")
    p.add_argument("--dual", action="store_true",
                   help="dual-RX: radio: sources start in "
                        "CHAN_SETUP_DUAL_AD12 (both A/Ds, coherent) and "
                        "the two streams are MRC-combined before demod "
                        "(up to +3 dB SNR; the reference defines these "
                        "modes but never demodulates channel 2).  Also "
                        "works with --source dualtone:F[:PHASE[:GAIN]]")
    p.add_argument("--rx2-gain", type=float, default=None,
                   help="dual-RX channel balance: ch1 A/D gain as a "
                        "fraction (CI 0x0023)")
    p.add_argument("--rx2-phase", type=float, default=None,
                   help="dual-RX channel balance: ch2 NCO phase offset, "
                        "degrees (CI 0x0022)")


def _radio_type(args):
    from cutesdr_tpu.io.netsdr import RadioType
    return {"netsdr": RadioType.NETSDR, "sdrip": RadioType.SDRIP,
            "sdriq": RadioType.SDRIQ, "sdr14": RadioType.SDR14}[args.radio_type]


def _apply_radio_rate(args) -> None:
    """For radio: sources the device's rate table dictates the sample rate
    (interface/sdrinterface.cpp:51-114) — override --fs before the pipeline
    is configured.  Also resolves the RF-center / baseband-tune split: the
    radio centers its digitized band on --center (default: --freq, i.e.
    center on the station) and the pipeline NCO only mixes by the remaining
    baseband offset --freq − center (the reference's demod-vs-center
    algebra, SetDemodFreq(center − demod) at gui/mainwindow.cpp:835-841)."""
    if not args.source.startswith("radio:"):
        return
    from cutesdr_tpu.io.netsdr import RATE_TABLES
    fs = RATE_TABLES[_radio_type(args)][args.bw_index][0]
    if args.fs not in (2e6, fs):      # 2e6 is the argparse default
        print(f"note: --fs {args.fs:.0f} overridden by the radio's "
              f"bandwidth-index {args.bw_index} rate {fs:.0f} Hz",
              file=sys.stderr)
    args.fs = fs
    if args.center is None:
        args.center = args.freq
    args.freq = args.freq - args.center        # baseband tune for the NCO
    if abs(args.freq) > fs / 2:
        raise SystemExit(f"--freq is {args.freq:.0f} Hz from --center — "
                         f"outside the ±{fs/2:.0f} Hz digitized band")


def _radio_db_cal(args) -> float:
    """Display-dB calibration for radio sources: per-radio offset minus the
    RF attenuation, so the spectrum/S-meter read ~dBm at the antenna
    connector (interface/sdrinterface.cpp:627-646)."""
    from cutesdr_tpu.io.netsdr import gain_cal_offset
    return gain_cal_offset(_radio_type(args), args.bw_index) - args.rf_gain


def _apply_spur_cal(source, receiver) -> None:
    """Feed the radio client's learned NCO-spur DC offsets into the
    pipeline's per-sample subtraction (the reference applies them inside
    ProcessIQData, interface/sdrinterface.cpp:891-894).  No-op for
    non-radio sources or unchanged offsets."""
    client = getattr(source, "client", None)
    if client is None:
        return
    off = client.spur_offsets
    if off != getattr(source, "_applied_spur", (0.0, 0.0)):
        source._applied_spur = off
        receiver.set_dc_offset(*off)


class _RadioSource:
    """Live-radio source: SdrClient in a background asyncio thread feeding
    a bounded queue, re-blocked for the pull-based run/serve loops.

    The reference couples these with threads + a 256-slot FIFO
    (interface/netiobase.cpp:62,571-600); the queue here is that FIFO, and
    SdrClient already carries the keepalive watchdog / reconnect loop /
    sequence-gap accounting."""

    live = True                      # run/serve skip generator pacing

    def __init__(self, host: str, port: int, args, block_size: int):
        import queue
        import threading

        self._q: "queue.Queue[np.ndarray]" = queue.Queue(maxsize=256)
        self._chunks: list[np.ndarray] = []
        self._have = 0
        self._block = block_size
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._err: BaseException | None = None
        self.client = None
        self.dropped_blocks = 0
        self._thread = threading.Thread(target=self._run,
                                        args=(host, port, args), daemon=True)
        self._thread.start()
        self._ready.wait(timeout=20.0)
        if self._err is not None:
            raise SystemExit(f"radio connect failed: {self._err!r}")
        if self.client is None:
            raise SystemExit("radio connect timed out")

    def _run(self, host: str, port: int, args) -> None:
        import asyncio

        from cutesdr_tpu.io.ascp import ci
        from cutesdr_tpu.io.netsdr import SdrClient

        dual = bool(getattr(args, "dual", False))

        async def main():
            client = SdrClient(host=host, port=port,
                               radio_type=_radio_type(args),
                               bandwidth_index=args.bw_index,
                               rf_gain=args.rf_gain,
                               on_iq=None if dual else self._on_iq,
                               on_iq_dual=self._on_iq_dual if dual else None)
            if dual:
                client.channel_mode = ci.CHAN_SETUP_DUAL_AD12
            # resume a previously learned NCO-spur cal (QSettings restore,
            # gui/mainwindow.cpp:311-316): the EMA continues converged
            # instead of restarting from zero and clobbering the saved value
            client._spur_i, client._spur_q = getattr(
                args, "_spur_seed", (0.0, 0.0))
            await client.connect()
            await asyncio.sleep(0.5)          # let the handshake fill in
            client.set_bandwidth_index(args.bw_index)
            client.set_frequency(int(args.center
                                     if args.center is not None
                                     else args.freq))
            client.start()
            if dual and (args.rx2_gain is not None
                         or args.rx2_phase is not None):
                client.set_rx2_parameters(
                    args.rx2_gain if args.rx2_gain is not None else 1.0,
                    args.rx2_phase if args.rx2_phase is not None else 0.0)
            self.client = client
            self._ready.set()
            print(f"radio: {client.device_name or '(unnamed)'} "
                  f"sn={client.serial or '?'} fs={client.sample_rate:.0f}",
                  file=sys.stderr)
            while not self._stop.is_set():
                await asyncio.sleep(0.1)
            client.stop()
            await client.close()

        try:
            asyncio.run(main())
        except BaseException as e:           # surface connect failures
            self._err = e
            self._ready.set()

    def _on_iq(self, iq: np.ndarray) -> None:
        import queue
        try:
            self._q.put_nowait(np.asarray(iq, np.complex64))
        except queue.Full:                   # consumer stalled: drop, count
            self.dropped_blocks += 1

    def _on_iq_dual(self, iq1: np.ndarray, iq2: np.ndarray) -> None:
        import queue
        try:
            self._q.put_nowait(np.stack([iq1, iq2]).astype(np.complex64))
        except queue.Full:
            self.dropped_blocks += 1

    def __call__(self):
        """Next block: [block] complex (single) or [2, block] (dual)."""
        import queue
        while self._have < self._block:
            try:
                c = self._q.get(timeout=5.0)
            except queue.Empty:
                return None                  # stream died (watchdog reports)
            self._chunks.append(c)
            self._have += c.shape[-1]
        cat = np.concatenate(self._chunks, axis=-1)
        out, rest = cat[..., :self._block], cat[..., self._block:]
        self._chunks, self._have = [rest], rest.shape[-1]
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)


def _cfg_from_args(args, probes: bool = False, readback_floor_s=None):
    """Build the receiver config from CLI args.

    ``readback_floor_s``: measured device→host readback round-trip; when
    the chosen low-latency blocks are shorter than it, the audio queue
    drains faster than it fills (every delivered block pays one
    readback), so the latency target is auto-raised with a printed
    explanation.  None =
    measure it now (tests inject a fake floor)."""
    from cutesdr_tpu.design.latency import (choose_fastfir_sizes,
                                            ensure_realtime_blocks,
                                            measure_readback_floor)
    from cutesdr_tpu.pipeline.receiver import ReceiverConfig

    cfg = ReceiverConfig(
        input_rate=args.fs, mode=args.mode, tune_freq=args.freq,
        low_cut=args.low_cut, hi_cut=args.hi_cut, cw_offset=args.cw_offset,
        agc_on=not args.agc_off, nb_on=args.nb_on,
        nb_threshold=args.nb_threshold, nb_width_us=args.nb_width_us,
        squelch_ui=args.squelch, fm_deemphasis_us=args.fm_deemphasis_us,
        stereo=args.stereo, front_dtype=args.front_dtype, probes=probes)
    # negative = the run/serve built-in default: ~10 ms best-effort
    best_effort = args.target_latency_ms < 0
    target_ms = 10.0 if best_effort else args.target_latency_ms
    if target_ms > 0:
        try:
            cfg = choose_fastfir_sizes(cfg, target_ms * 1e-3)
        except ValueError as e:
            if not best_effort:
                raise SystemExit(f"error: {e}")
            from dataclasses import replace

            from cutesdr_tpu.design.latency import MIN_NFFT, latency_report
            cfg = replace(cfg, fastfir_nfft=MIN_NFFT,
                          fastfir_ntaps=MIN_NFFT // 2 + 1,
                          frames_per_block=1)
            print(f"note: 10 ms default unreachable for this config "
                  f"({e}); using the smallest filter "
                  f"({latency_report(cfg)['total'] * 1e3:.1f} ms)",
                  file=sys.stderr)
        print(f"latency target {target_ms} ms -> "
              f"fastfir {cfg.fastfir_nfft}/{cfg.fastfir_ntaps}",
              file=sys.stderr)
        # self-defense against the D2H readback floor: a device whose fixed
        # per-readback latency exceeds the block duration starves the
        # audio queue regardless of compute speed
        floor = (measure_readback_floor() if readback_floor_s is None
                 else readback_floor_s)
        before = cfg.latency_sec
        cfg, after = ensure_realtime_blocks(cfg, floor)
        if after > before:
            print(f"note: device readback floor measured at "
                  f"{floor * 1e3:.1f} ms/block exceeds the "
                  f"{before * 1e3:.1f} ms block budget — raising blocks to "
                  f"{after * 1e3:.1f} ms "
                  f"(frames_per_block={cfg.frames_per_block}, fastfir "
                  f"{cfg.fastfir_nfft}/{cfg.fastfir_ntaps}) so audio "
                  f"streams instead of starving; use --target-latency-ms 0 "
                  f"to pick max-throughput sizes explicitly",
                  file=sys.stderr)
    return cfg


def _make_source(args, block_size):
    from cutesdr_tpu.testbench.generators import GenConfig, SignalGenerator

    import numpy as _np

    def c64(f):
        # the receiver runs complex64; convert on the host
        return lambda: (lambda b: None if b is None
                        else _np.asarray(b, _np.complex64))(f())

    spec = args.source
    if spec == "sweep":
        gen = SignalGenerator(GenConfig(
            sample_rate=args.fs, sweep_start_hz=args.freq - 50e3,
            sweep_stop_hz=args.freq + 50e3, sweep_rate_hz_per_sec=20e3,
            signal_power_db=-20.0, noise_power_db=-90.0))
        return c64(lambda: gen.next_block(block_size))
    if spec.startswith("tone:"):
        gen = SignalGenerator(GenConfig(
            sample_rate=args.fs, sweep_start_hz=float(spec[5:]),
            sweep_stop_hz=float(spec[5:]), signal_power_db=-20.0))
        return c64(lambda: gen.next_block(block_size))
    if spec.startswith("dualtone:"):
        # coherent dual-RX test stimulus: ch2 = gain·e^{jφ}·ch1 (a fixed
        # channel mismatch for the MRC combiner to estimate)
        parts = spec.split(":")
        f0 = float(parts[1])
        phase = _np.radians(float(parts[2]) if len(parts) > 2 else 35.0)
        g = float(parts[3]) if len(parts) > 3 else 0.8
        gen = SignalGenerator(GenConfig(
            sample_rate=args.fs, sweep_start_hz=f0, sweep_stop_hz=f0,
            signal_power_db=-20.0, noise_power_db=-70.0))

        def dual_block():
            x = gen.next_block(block_size).astype(_np.complex64)
            return _np.stack([x, (g * _np.exp(1j * phase) * x)
                              .astype(_np.complex64)])
        return dual_block
    if spec.startswith("file:"):
        from cutesdr_tpu.io.filesource import FileSource
        parts = spec.split(":")
        if ".sigmf" in parts[1]:
            from cutesdr_tpu.io.recorder import open_sigmf
            src, meta = open_sigmf(parts[1])
            print(f"sigmf capture: fs={meta['global']['core:sample_rate']} "
                  f"f0={meta['captures'][0].get('core:frequency', 0)}",
                  file=sys.stderr)
        else:
            src = FileSource(parts[1], parts[2] if len(parts) > 2 else "int16")
        return lambda: src.next_block(block_size)
    if spec.startswith("udp:"):
        from cutesdr_tpu.io.native_ingest import NativeIngest
        ing = NativeIngest(int(spec[4:]))

        class _UdpSource:
            planes = True            # yields (re, im) float32 planes
            live = True
            client = None

            def __call__(self):
                return ing.read_planes(block_size, timeout_ms=2000)

            def close(self):
                ing.close()
        return _UdpSource()
    if spec.startswith("radio:"):
        parts = spec.split(":")
        host = parts[1]
        port = int(parts[2]) if len(parts) > 2 else 50000
        return _RadioSource(host, port, args, block_size)
    raise SystemExit(f"unknown source {spec!r}")


def cmd_run(args) -> int:
    from cutesdr_tpu.io.filesource import WavSink
    from cutesdr_tpu.pipeline.receiver import Receiver, join_complex_pair

    _apply_radio_rate(args)
    if getattr(args, "dual", False):
        return _run_dual(args)
    cfg = _cfg_from_args(args, probes=args.probe > 0)
    rx = Receiver(cfg)
    rx.set_volume(args.volume)
    source = _make_source(args, cfg.block_size)

    n_blocks = max(1, int(args.seconds * args.fs / cfg.block_size))
    probes = []
    t0 = time.time()
    with WavSink(args.out, 48000, args.stereo) as wav:
        for i in range(n_blocks):
            iq = source()
            if iq is None:
                break
            # host-plane path: no complex64 across the device boundary
            # (stereo audio / complex probes arrive as [..., 2] stacks);
            # native udp: sources deliver ready-made (re, im) planes
            out = (rx.process_planes(*iq) if isinstance(iq, tuple)
                   else rx.process_host(iq))
            audio = np.asarray(out.audio)[:int(out.n_audio)]
            if args.stereo:
                audio = audio[..., 0] + 1j * audio[..., 1]
            wav.write(audio)
            if args.probe:
                key = {1: "p1_downconvert", 2: "p2_fastfir", 3: "p3_agc",
                       4: "p4_demod", 5: "p5_resampled",
                       7: "p7_blanker"}[args.probe]
                tap = np.asarray(out.probes[key])
                if tap.ndim == 2 and tap.shape[-1] == 2:
                    tap = join_complex_pair(tap)   # split complex leaf
                probes.append(tap)
            if i % 10 == 0:
                print(f"block {i}/{n_blocks} s-meter "
                      f"{float(out.smeter_ave_db):6.1f} dB", file=sys.stderr)
            _apply_spur_cal(source, rx)
    dt = time.time() - t0
    if hasattr(source, "close"):
        source.close()
    if probes:
        np.save(f"probe{args.probe}.npy", np.concatenate(probes))
        print(f"wrote probe{args.probe}.npy", file=sys.stderr)
    msps = n_blocks * cfg.block_size / dt / 1e6
    print(f"processed {n_blocks * cfg.block_size} samples in {dt:.2f}s "
          f"({msps:.2f} Msps) -> {args.out}", file=sys.stderr)
    return 0


def _run_dual(args) -> int:
    """Dual-RX run: coherent two-channel source → MRC diversity combine →
    one demod chain → WAV.  Drives CHAN_SETUP_DUAL_AD12 end-to-end for
    radio: sources (the reference defines the mode,
    interface/protocoldefs.h:143-152, but never demodulates channel 2)."""
    from cutesdr_tpu.io.filesource import WavSink
    from cutesdr_tpu.shard.coherent import DiversityReceiver

    cfg = _cfg_from_args(args)
    drx = DiversityReceiver(cfg)
    drx.set_volume(args.volume)
    source = _make_source(args, cfg.block_size)

    n_blocks = max(1, int(args.seconds * args.fs / cfg.block_size))
    t0 = time.time()
    with WavSink(args.out, 48000, args.stereo) as wav:
        for i in range(n_blocks):
            iq = source()
            if iq is None:
                break
            if iq.ndim != 2 or iq.shape[0] != 2:
                raise SystemExit("--dual needs a two-channel source "
                                 "(radio:--dual or dualtone:)")
            out = drx.process_host(iq)
            audio = np.asarray(out.audio)[:int(out.n_audio)]
            if args.stereo:
                audio = audio[..., 0] + 1j * audio[..., 1]
            wav.write(audio)
            if i % 10 == 0:
                g = drx.last_gain
                print(f"block {i}/{n_blocks} s-meter "
                      f"{float(out.smeter_ave_db):6.1f} dB  rx2 gain "
                      f"{abs(g):.3f} ∠{np.degrees(np.angle(g)):6.1f}°",
                      file=sys.stderr)
    dt = time.time() - t0
    if hasattr(source, "close"):
        source.close()
    g = drx.last_gain
    msps = n_blocks * cfg.block_size / dt / 1e6
    print(f"processed {n_blocks * cfg.block_size} dual samples in {dt:.2f}s "
          f"({msps:.2f} Msps x2) rx2 gain {abs(g):.3f} "
          f"∠{np.degrees(np.angle(g)):.1f}° -> {args.out}", file=sys.stderr)
    return 0


def cmd_spectrum(args) -> int:
    from cutesdr_tpu.pipeline.spectrum import SpectrumAnalyzer, SpectrumConfig

    _apply_radio_rate(args)
    is_radio = args.source.startswith("radio:")
    cfg = SpectrumConfig(fft_size=args.fft_size, ave_size=args.ave,
                         sample_rate=args.fs,
                         db_compensation=_radio_db_cal(args) if is_radio
                         else 0.0)
    sa = SpectrumAnalyzer(cfg, max_display_rate=1000.0)
    args.mode = "usb"
    if not is_radio:                       # keep --freq/--center for radio:
        args.freq = 0.0
    args.low_cut = args.hi_cut = None
    source = _make_source(args, cfg.fft_size)
    frames = 0
    for _ in range(args.frames * max(1, args.ave)):
        iq = source()
        if iq is None:
            break
        if isinstance(iq, tuple):
            ok = sa.feed_planes(*iq)
        else:
            ok = sa.feed(np.asarray(iq, np.complex64))
        if ok:
            frames += 1
    if hasattr(source, "close"):
        source.close()
    db = sa.spectrum_db()
    if args.out:
        np.save(args.out, db)
        print(f"wrote {args.out}", file=sys.stderr)
    peak = int(np.argmax(db))
    f_peak = (peak - cfg.fft_size // 2) * args.fs / cfg.fft_size
    print(json.dumps({"frames": frames, "peak_bin": peak,
                      "peak_freq_hz": f_peak,
                      "peak_db": float(db[peak]),
                      "noise_floor_db": float(np.median(db))}))
    return 0


def cmd_record(args) -> int:
    """Record raw IQ from a source to a capture file.

    Default output is SigMF (<out>.sigmf-data + .sigmf-meta, interoperable
    with other SDR tools); --legacy writes the bare file + .meta.json
    sidecar.  --pre-trigger-ms N arms a ring recorder instead: the source
    is monitored and the capture starts N ms *before* the first block whose
    peak magnitude exceeds --trigger-level (testbench trigger semantics,
    gui/testbench.cpp:819-898, applied to the raw stream)."""
    import datetime

    from cutesdr_tpu.io.filesource import RawIQWriter
    from cutesdr_tpu.io.recorder import RingRecorder, SigMFWriter

    args.mode = getattr(args, "mode", "usb")
    _apply_radio_rate(args)
    dual = bool(getattr(args, "dual", False))
    if dual and args.pre_trigger_ms > 0:
        raise SystemExit("--dual recording does not support --pre-trigger-ms")
    if dual and args.legacy:
        raise SystemExit("--dual recording needs SigMF (drop --legacy)")
    block = 65536
    source = _make_source(args, block)
    target = int(args.seconds * args.fs)

    if args.start_at:
        if args.start_at.startswith("+"):
            t_start = time.time() + float(args.start_at[1:])
        else:
            t_start = datetime.datetime.fromisoformat(
                args.start_at).timestamp()
        wait = t_start - time.time()
        if wait > 0:
            print(f"scheduled: recording starts in {wait:.1f}s",
                  file=sys.stderr)
            time.sleep(wait)

    # radio captures carry the RF center; generator captures the tune freq
    f0 = (args.center if getattr(args, "center", None) is not None
          and args.source.startswith("radio:") else args.freq)

    def make_writer():
        if args.legacy:
            return RawIQWriter(args.out, args.fmt)
        return SigMFWriter(args.out, "cf32" if args.fmt == "npy" else args.fmt,
                           sample_rate=args.fs, center_freq=f0,
                           num_channels=2 if dual else 1,
                           description=f"cutesdr-tpu record --source={args.source}")

    n_total = 0
    if args.pre_trigger_ms > 0:
        pre = int(args.pre_trigger_ms * 1e-3 * args.fs)
        ring = RingRecorder(pre)
        armed = True
        # monitor until the source ends or the post-trigger capture is done
        while armed or ring.recording:
            iq = source()
            if iq is None:
                break
            if armed and np.max(np.abs(iq)) >= args.trigger_level:
                ring.push(iq)  # history includes the triggering block
                n_total = ring.trigger(make_writer(), post=target)
                armed = False
                print(f"triggered at sample {ring.trigger_index} "
                      f"({n_total} pre-trigger samples)", file=sys.stderr)
                continue
            ring.push(iq)
        ring.close()
        if armed:
            print("no trigger seen; nothing recorded", file=sys.stderr)
            return 1
        n_total += target
    else:
        w = make_writer()
        while n_total < target:
            iq = source()
            if iq is None:
                break
            if isinstance(iq, tuple):          # native plane sources
                iq = iq[0] + 1j * iq[1]
            w.write(iq)
            n_total += iq.shape[-1]
        w.close()

    if hasattr(source, "close"):
        source.close()
    if args.legacy:
        meta = {
            "format": args.fmt,
            "sample_rate": args.fs,
            "center_frequency": f0,
            "samples": n_total,
            "datetime": datetime.datetime.now(
                datetime.timezone.utc).isoformat(),
            "source": args.source,
        }
        with open(args.out + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2)
        print(f"recorded {n_total} samples -> {args.out} (+.meta.json)",
              file=sys.stderr)
    else:
        print(f"recorded {n_total} samples -> {args.out}.sigmf-data "
              f"(+.sigmf-meta)", file=sys.stderr)
    return 0


def _browser_audio_queue(args, sess):
    """The queue to expose at /audio.wav, or None.

    The RateLockedQueue is single-consumer (its depth drives the
    resampler rate lock), so the host soundcard (--audio) and the browser
    cannot both drain it — with --audio the browser endpoint is disabled
    rather than silently splitting the sample stream between the two."""
    if getattr(args, "audio", False):
        import sys as _sys
        print("--audio: host soundcard owns the audio queue; "
              "browser /audio.wav disabled", file=_sys.stderr)
        return None
    return sess.audio_queue


def cmd_serve(args) -> int:
    """Run a source through the receiver with the browser waterfall UI."""
    import time as _time

    from cutesdr_tpu.serve import SpectrumServer
    from cutesdr_tpu.session import ReceiverSession

    from cutesdr_tpu.pipeline.receiver import MODE_LIMITS

    if args.audio_device == "list":    # pure enumeration: no session needed
        from cutesdr_tpu.io.audio_device import list_devices
        for name in list_devices() or ["(no output devices / backend)"]:
            print(name)
        return 0
    _apply_radio_rate(args)
    cfg = _cfg_from_args(args)
    # settings persistence (the MainWindow QSettings workflow,
    # gui/mainwindow.cpp:272-458): load at start, save at clean exit
    settings = None
    if args.settings:
        from cutesdr_tpu.settings import SessionSettings
        settings = SessionSettings.load(args.settings)
    if settings is not None:
        args._spur_seed = (settings.radio.spur_offset_i,
                           settings.radio.spur_offset_q)
    # radio sources: calibrate the display dB scale to ~dBm at the antenna
    spectrum_cfg = None
    if args.source.startswith("radio:"):
        from cutesdr_tpu.pipeline.spectrum import SpectrumConfig
        disp = settings.display if settings else None
        spectrum_cfg = SpectrumConfig(
            fft_size=disp.fft_size if disp else 4096,
            ave_size=disp.fft_ave if disp else 1,
            sample_rate=args.fs, db_compensation=_radio_db_cal(args))
    if args.channels:
        from cutesdr_tpu.bank import BankSession
        freqs = [float(x) for x in args.channels.split(",")]
        kw = {}
        if settings is not None:
            kw["settings"] = settings
        if spectrum_cfg is not None:
            kw["spectrum_cfg"] = spectrum_cfg
        sess = BankSession(cfg, freqs, **kw)

        def on_select(i):
            m = sess.select(i)
            srv.set_view(tune_hz=sess.tune_freqs[m])
            return m

        srv = SpectrumServer(port=args.port, sample_rate=args.fs,
                             on_tune=sess.tune_clicked,
                             on_select=on_select,
                             on_probe=sess.set_probe,
                             on_volume=getattr(sess, "set_volume", None),
                             audio_queue=_browser_audio_queue(args, sess),
                             audio_stereo=cfg.stereo).start()
        srv.set_view(tune_hz=freqs[0], low_hz=cfg.low_cut,
                     hi_hz=cfg.hi_cut, symmetric=MODE_LIMITS[cfg.mode][4],
                     click_res=sess.settings.demod[cfg.mode]
                     .filter_click_resolution)
        sess.on_spectrum = lambda db: srv.update(
            db, smeter_db=float(sess.smeter_db[sess.monitor]),
            channels=sess.channel_info(),
            overload=sess.analyzer.overload,
            probe=sess.probe_frame())
    elif getattr(args, "dual", False):
        # dual-RX toggle: MRC-combined diversity session; display shows
        # channel 1's raw spectrum, audio is the combined stream, status
        # carries the tracked rx2 gain estimate
        from cutesdr_tpu.session import DiversitySession
        kw = {}
        if settings is not None:
            kw["settings"] = settings
        sess = DiversitySession(cfg, **kw)
        srv = SpectrumServer(port=args.port, sample_rate=args.fs,
                             on_tune=sess.tune_clicked,
                             on_filter=sess.set_filter,
                             on_volume=getattr(sess, "set_volume", None),
                             audio_queue=_browser_audio_queue(args, sess),
                             audio_stereo=cfg.stereo).start()
        srv.set_view(tune_hz=cfg.tune_freq, low_hz=cfg.low_cut,
                     hi_hz=cfg.hi_cut, symmetric=MODE_LIMITS[cfg.mode][4],
                     mode=cfg.mode,
                     rf_center=float(args.center or 0.0),
                     click_res=sess.settings.demod[cfg.mode]
                     .filter_click_resolution)
        ad_transient = {"until": 0.0}
        sess.on_spectrum = lambda db: srv.update(
            db, smeter_db=sess.metrics.smeter_ave_db,
            overload=(sess.metrics.overload
                      or _time.time() < ad_transient["until"]))
    else:
        kw = {}
        if settings is not None:
            kw["settings"] = settings
        if spectrum_cfg is not None:
            kw["spectrum_cfg"] = spectrum_cfg
        sess = ReceiverSession(cfg, **kw)
        if settings is not None and (settings.radio.spur_offset_i
                                     or settings.radio.spur_offset_q):
            # saved NCO-spur cal applies from the first sample
            # (gui/mainwindow.cpp:311-316 restores it from QSettings)
            sess.receiver.set_dc_offset(settings.radio.spur_offset_i,
                                        settings.radio.spur_offset_q)

        def on_mode(mode):
            # the demod-setup dialog's mode switch, glitch-free
            sess.set_mode(mode)
            c = sess.cfg
            srv.set_view(low_hz=c.low_cut, hi_hz=c.hi_cut,
                         symmetric=MODE_LIMITS[mode][4],
                         click_res=sess.settings.demod[mode]
                         .filter_click_resolution)
            return mode

        srv = SpectrumServer(port=args.port, sample_rate=args.fs,
                             on_tune=sess.tune_clicked,
                             on_filter=sess.set_filter,
                             on_mode=on_mode,
                             on_probe=sess.set_probe,
                             on_volume=sess.set_volume,
                             audio_queue=_browser_audio_queue(args, sess),
                             audio_stereo=cfg.stereo).start()
        srv.set_view(tune_hz=cfg.tune_freq, low_hz=cfg.low_cut,
                     hi_hz=cfg.hi_cut, symmetric=MODE_LIMITS[cfg.mode][4],
                     mode=cfg.mode,
                     rf_center=float(args.center or 0.0),
                     click_res=sess.settings.demod[cfg.mode]
                     .filter_click_resolution)
        # radio-reported A/D overload shows as a timed transient, OR'd with
        # the signal-derived flag (gui/mainwindow.cpp:776-782)
        ad_transient = {"until": 0.0}
        sess.on_spectrum = lambda db: srv.update(
            db, smeter_db=sess.metrics.smeter_ave_db,
            overload=(sess.metrics.overload
                      or _time.time() < ad_transient["until"]),
            probe=sess.probe_frame())
    source = _make_source(args, cfg.block_size)
    speaker = None
    if args.audio:
        from cutesdr_tpu.io.audio_device import SoundCardSink
        speaker = SoundCardSink(sess.audio_queue, 48000,
                                device=args.audio_device).start()
    sess.start()
    # compile before the stream starts so the first real block is instant
    # and slow first-time compiles are visible instead of looking like a
    # hang (the persistent cache makes reruns fast)
    try:
        rxv = getattr(sess, "receiver", None)
        if rxv is not None and hasattr(rxv, "process_host"):
            print("compiling pipeline (first run may take a while; "
                  "cached afterwards)…", file=sys.stderr)
            t0 = _time.time()
            saved = rxv.state
            saved_comb = getattr(rxv, "comb_state", None)
            shape = ((2, cfg.block_size) if getattr(args, "dual", False)
                     else cfg.block_size)
            rxv.process_host(np.zeros(shape, np.complex64))
            rxv.state = saved
            if saved_comb is not None:
                rxv.comb_state = saved_comb
            print(f"compiled in {_time.time() - t0:.1f}s", file=sys.stderr)
            if hasattr(sess, "precompile") and not args.no_precompile:
                # compile every demod mode up front so the web UI's mode
                # switch is glitch-free instead of blocking the stream on
                # a first-visit compile (the reference's per-mode demod
                # objects always exist, dsp/demodulator.cpp:107-157)
                t0 = _time.time()
                sess.precompile(["am", "sam", "fm", "usb", "lsb",
                                 "cwu", "cwl"])
                # also the current mode's probes program, so the first
                # probe-scope selection doesn't pay a compile
                from dataclasses import replace as _replace
                sess._prebuild(_replace(sess.cfg, probes=True))
                print(f"precompiled all modes in {_time.time() - t0:.1f}s "
                      "(--no-precompile to skip)", file=sys.stderr)
    except Exception as e:                    # warm-up is best-effort
        print(f"note: warm-up compile skipped ({e!r})", file=sys.stderr)
    print(f"serving http://127.0.0.1:{srv.port}/  (Ctrl-C to stop)",
          file=sys.stderr)
    deadline = (_time.time() + args.seconds) if args.seconds > 0 else None
    try:
        while deadline is None or _time.time() < deadline:
            iq = source()
            if iq is None:
                break
            if isinstance(iq, tuple) and hasattr(sess, "pump_planes"):
                sess.pump_planes(*iq)    # native plane sources, no re-pack
            elif isinstance(iq, tuple):
                sess.pump(iq[0] + 1j * iq[1])
            else:
                sess.pump(iq)
            if not args.channels:
                _apply_spur_cal(source, sess.receiver)
                client = getattr(source, "client", None)
                if client is not None and client.ad_overload:
                    client.ad_overload = False
                    ad_transient["until"] = _time.time() + 1.5
            # pace roughly to real time for generator sources (live radio
            # sources pace themselves)
            if ((args.realtime or speaker is not None)
                    and not getattr(source, "live", False)):
                _time.sleep(cfg.block_size / args.fs)
    except KeyboardInterrupt:
        pass
    finally:
        sess.stop()                   # drains in-flight pipelined steps
        if speaker is not None:
            speaker.stop()
        if hasattr(source, "close"):
            source.close()
        srv.stop()
        if settings is not None:
            _save_serve_settings(args, sess, source, settings)
    print(sess.status_line(), file=sys.stderr)
    return 0


def _save_serve_settings(args, sess, source, settings) -> None:
    """Persist the session's last-used state back to the settings file
    (the reference's writeSettings, gui/mainwindow.cpp:272-366)."""
    settings.demod_mode = sess.cfg.mode
    settings.volume = getattr(sess, "settings", settings).volume
    settings.nb_on = sess.cfg.nb_on
    settings.nb_threshold = sess.cfg.nb_threshold
    settings.nb_width_us = sess.cfg.nb_width_us
    # schema relation: baseband tune = demod_frequency - center_frequency
    # (settings.receiver_config_from_settings)
    tune = getattr(sess, "current_tune", None)
    client = getattr(source, "client", None)
    center = int(client.current_frequency) if client is not None else 0
    settings.radio.center_frequency = center
    if tune is not None:
        settings.radio.demod_frequency = center + int(tune)
    if client is not None:
        settings.radio.ip = client.host
        settings.radio.port = client.port
        settings.radio.radio_type = client.radio_type.value
        settings.radio.bandwidth_index = client.bandwidth_index
        settings.radio.rf_gain = client.rf_gain
        i, q = client.spur_offsets
        settings.radio.spur_offset_i = i
        settings.radio.spur_offset_q = q
    settings.save(args.settings)
    print(f"settings saved -> {args.settings}", file=sys.stderr)


def cmd_latency(args) -> int:
    """Print the per-component latency budget for a configuration."""
    from cutesdr_tpu.design.latency import latency_report

    # pure report: skip the device readback-floor probe (floor 0 = no-op)
    cfg = _cfg_from_args(args, readback_floor_s=0.0)
    rep = latency_report(cfg, include_queue=args.with_queue)
    print(json.dumps({
        "fastfir_nfft": cfg.fastfir_nfft, "fastfir_ntaps": cfg.fastfir_ntaps,
        "decimation": cfg.plan.decimation, "block_size": cfg.block_size,
        **{k: round(v * 1e3, 3) for k, v in rep.items()},
        "unit": "ms"}))
    return 0


def cmd_discover(args) -> int:
    from cutesdr_tpu.io.discover import discover

    devs = discover(timeout=args.timeout)
    for d in devs:
        print(json.dumps({"name": d.name, "serial": d.serial, "ip": d.ip,
                          "port": d.port, "running": d.status_running}))
    if not devs:
        print("no devices found", file=sys.stderr)
    return 0


def cmd_bench(args) -> int:
    import bench
    bench.main()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cutesdr-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="demodulate a stream to WAV")
    _add_receiver_args(p_run, default_latency_ms=-1.0)
    p_run.add_argument("--out", default="audio.wav")
    p_run.set_defaults(fn=cmd_run)

    p_spec = sub.add_parser("spectrum", help="spectrum frames from a source")
    _add_receiver_args(p_spec)
    p_spec.add_argument("--fft-size", type=int, default=4096)
    p_spec.add_argument("--ave", type=int, default=4)
    p_spec.add_argument("--frames", type=int, default=10)
    p_spec.add_argument("--out", default="")
    p_spec.set_defaults(fn=cmd_spectrum)

    p_rec = sub.add_parser("record", help="record raw IQ to a capture file")
    _add_receiver_args(p_rec)
    p_rec.add_argument("--out", default="capture")
    p_rec.add_argument("--fmt", default="int16",
                       choices=["int16", "cf32", "npy"])
    p_rec.add_argument("--legacy", action="store_true",
                       help="bare file + .meta.json instead of SigMF")
    p_rec.add_argument("--pre-trigger-ms", type=float, default=0.0,
                       help="arm a ring recorder with this much history")
    p_rec.add_argument("--start-at", default="",
                       help="schedule the recording: ISO timestamp "
                            "(e.g. 2026-08-19T21:00) or +SECONDS delay")
    p_rec.add_argument("--trigger-level", type=float, default=1000.0,
                       help="|IQ| level that fires the ring trigger")
    p_rec.set_defaults(fn=cmd_record)

    p_srv = sub.add_parser("serve", help="browser spectrum/waterfall UI")
    _add_receiver_args(p_srv, default_latency_ms=-1.0)
    p_srv.add_argument("--port", type=int, default=8765)
    p_srv.add_argument("--settings", default="",
                       help="JSON settings file: loaded at start (per-mode "
                            "demod table, display, volume), saved at exit "
                            "with last-used mode/tune/radio params and "
                            "learned spur cal (the QSettings workflow)")
    p_srv.add_argument("--realtime", action="store_true",
                       help="pace generator sources to wall-clock")
    p_srv.add_argument("--no-precompile", action="store_true",
                       help="skip compiling every demod mode at startup "
                            "(faster start; first mode switch then pays "
                            "its compile while the stream waits)")
    p_srv.add_argument("--channels", default="",
                       help="comma-separated tune freqs -> channel-bank "
                            "mode (N demodulators, per-channel S-meters, "
                            "select the monitor channel from the table)")
    p_srv.add_argument("--audio", action="store_true",
                       help="play audio to the sound card (needs the "
                            "optional 'sounddevice' package; implies "
                            "--realtime)")
    p_srv.add_argument("--audio-device", default=None,
                       help="output device name for --audio ('list' prints "
                            "the available devices and exits — the sound "
                            "dialog's device pick, gui/sounddlg.cpp)")
    p_srv.set_defaults(fn=cmd_serve)

    p_lat = sub.add_parser("latency", help="latency budget for a config")
    _add_receiver_args(p_lat)
    p_lat.add_argument("--with-queue", action="store_true",
                       help="include the audio-queue half-fill delay")
    p_lat.set_defaults(fn=cmd_latency)

    p_disc = sub.add_parser("discover", help="find radios on the LAN")
    p_disc.add_argument("--timeout", type=float, default=0.5)
    p_disc.set_defaults(fn=cmd_discover)

    p_bench = sub.add_parser("bench", help="throughput benchmark")
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from cutesdr_tpu.cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
