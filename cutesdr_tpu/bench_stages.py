"""On-chip stage budget for the flagship chain (VERDICT r3 'do this' #1).

Times TRUNCATED variants of the production receiver step with chained
state — mix+decimate only → +channel filter → +S-meter/AGC → +demod →
full (+resample tail) — on the flagship 2 MSPS ×32 config and derives the
per-stage share by subtraction.

Per-step time is the SLOPE between two chain lengths,
t_step = (T(k2) - T(k1)) / (k2 - k1), each T fenced by a scalar
device->host readback, so the fixed readback latency cancels.

Every variant runs the PRODUCTION code (the receiver module's own _front /
_levels / _demod_apply / receiver_step).  Reference hot loop being
budgeted: dsp/fastfir.cpp:266 (600 ns/sample on the author's ~3 GHz x86).

Usage:  python -m cutesdr_tpu.bench_stages [--frames N] [--k1 N] [--k2 N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


REPS = 5      # r5: >=5 reps so per-stage shares carry intervals (the r4
              # subtraction of two single best-of fits produced negative
              # shares — differencing noise exceeded small stage costs)


def fence(out):
    """Force device completion: D2H readback of a scalar derived from the
    output (see module docstring)."""
    import jax
    import jax.numpy as jnp
    leaf = jax.tree_util.tree_leaves(out)[0]
    return float(jnp.real(jnp.sum(leaf)))


def slope_times(step, params, state, re, im, k1=2, k2=8, reps=REPS):
    """Per-rep seconds/step via the two-length slope, state chained.
    Returns the full list so callers can form medians AND intervals."""
    out = step(params, state, re, im)
    fence(out[1])
    s0 = out[0]
    slopes = []
    for _ in range(reps):
        ts = {}
        for k in (k1, k2):
            t0 = time.perf_counter()
            s = s0
            for _ in range(k):
                o = step(params, s, re, im)
                s = o[0]
            fence(o[1])
            ts[k] = time.perf_counter() - t0
        slopes.append((ts[k2] - ts[k1]) / (k2 - k1))
    return slopes


def slope_time(step, params, state, re, im, k1=2, k2=8, reps=REPS):
    """Median seconds/step (back-compat wrapper around slope_times)."""
    s = sorted(slope_times(step, params, state, re, im, k1, k2, reps))
    return s[len(s) // 2]


def _share_stats(ta, tb):
    """Distribution of the stage cost t_a - t_b from two rep lists: median
    of all cross-pair differences, clamped at 0 (a stage cannot cost
    negative time — the r4 artifact), with the raw [lo, hi] interval kept
    so a clamp is visible rather than silent."""
    diffs = sorted(a - b for a in ta for b in tb)
    med = diffs[len(diffs) // 2]
    return {"ms": round(max(med, 0.0) * 1e3, 4),
            "ms_interval": [round(diffs[0] * 1e3, 4),
                            round(diffs[-1] * 1e3, 4)],
            "clamped": med < 0.0}


def make_variants(cfg):
    """Jitted truncated steps, all built from the receiver module's own
    stage functions.  Each returns (carried_state, f32 output) — complex64
    never crosses the device boundary (CLAUDE.md)."""
    import jax
    import jax.numpy as jnp

    from cutesdr_tpu.pipeline import receiver as rx

    def front_only(p, s, re, im):
        iq = jax.lax.complex(re, im)
        nb_c, nco_c, dec_c, ff_c, filt = rx._front(cfg, p, s, iq)
        ns = s._replace(nco=nco_c, blanker=nb_c, dec=dec_c, chan_filter=ff_c)
        return ns, jnp.sum(jnp.abs(filt))

    def mixdec_only(p, s, re, im):
        # the front end minus the channel filter: production dispatches on
        # cfg.decimator_impl exactly as rx._front does
        if cfg.decimator_impl == "pallas":
            dec_c, base = rx._make_mixdec(cfg).process_planes(
                p.dec, s.dec, re, im, p.dc_offset)
            ns = s._replace(dec=dec_c)
        else:
            from cutesdr_tpu.ops import decimator, nco
            iq = jax.lax.complex(re, im) - p.dc_offset
            nco_c, mixed = nco.process(p.nco, s.nco, iq)
            if cfg.decimator_impl == "fused":
                dec_c, base = decimator.fused_process(cfg.plan, p.dec,
                                                      s.dec, mixed)
            else:
                dec_c, base = decimator.cascade_process(cfg.plan, s.dec,
                                                        mixed)
            ns = s._replace(nco=nco_c, dec=dec_c)
        return ns, jnp.sum(jnp.abs(base))

    def levels(p, s, re, im):
        iq = jax.lax.complex(re, im)
        nb_c, nco_c, dec_c, ff_c, filt = rx._front(cfg, p, s, iq)
        sm_c, agc_c, leveled = rx._levels(cfg, p, s, filt)
        ns = s._replace(nco=nco_c, blanker=nb_c, dec=dec_c, chan_filter=ff_c,
                        agc=agc_c, smeter=sm_c)
        return ns, jnp.sum(jnp.abs(leveled))

    def demod(p, s, re, im):
        iq = jax.lax.complex(re, im)
        nb_c, nco_c, dec_c, ff_c, filt = rx._front(cfg, p, s, iq)
        sm_c, agc_c, leveled = rx._levels(cfg, p, s, filt)
        dm_c, audio = rx._demod_apply(cfg, p.demod, s.demod, leveled)
        ns = s._replace(nco=nco_c, blanker=nb_c, dec=dec_c, chan_filter=ff_c,
                        agc=agc_c, smeter=sm_c, demod=dm_c)
        return ns, jnp.sum(jnp.abs(audio))

    def full(p, s, re, im):
        ns, out = rx.receiver_step(cfg, p, s, jax.lax.complex(re, im))
        return ns, out.audio   # f32 — safe D2H

    return {"mixdec": jax.jit(mixdec_only), "front": jax.jit(front_only),
            "levels": jax.jit(levels), "demod": jax.jit(demod),
            "full": jax.jit(full)}


def make_serve_variant(cfg):
    """The serve-path step: probes-enabled receiver + one display-FFT
    accumulate per block — the cost the reference's ProcessIQData always
    pays (testbench hook -> FFT display accumulate -> demod,
    interface/sdrinterface.cpp:895-908).  One 4096-pt accumulate per block
    matches the throttled display rate (the flagship 131 ms block vs the
    reference's <=10 updates/s, sdrinterface.cpp:112-114)."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace

    from cutesdr_tpu.pipeline import receiver as rx
    from cutesdr_tpu.pipeline import spectrum as sp

    pcfg = replace(cfg, probes=True)
    params, state = rx.init(pcfg)
    scfg = sp.SpectrumConfig(fft_size=4096, ave_size=4,
                             sample_rate=cfg.input_rate)
    sstate = sp.init(scfg)

    def serve_step(p, s, re, im):
        rstate, spstate = s
        iq = jax.lax.complex(re, im)
        ns, out = rx.receiver_step(pcfg, p, rstate, iq)
        sps, _ = sp.accumulate(scfg, spstate, iq[:scfg.fft_size])
        # fence value touches the audio, a probe leaf, and the spectrum
        # average so no branch is dead-code-eliminated
        probe_leaf = jax.tree_util.tree_leaves(out.probes)[0]
        val = (jnp.sum(out.audio) + jnp.real(jnp.sum(probe_leaf))
               + jnp.sum(sps.pwr_ave))
        return (ns, sps), val

    return jax.jit(serve_step), params, (state, sstate)


def run_budget(frames_per_block=256, k1=4, k2=32,
               input_rate=2_000_000.0, mode="usb", name="usb2m"):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cutesdr_tpu.pipeline import receiver as rx

    cfg = rx.ReceiverConfig(input_rate=input_rate, mode=mode,
                            tune_freq=input_rate / 20.0, audio_rate=48000.0,
                            frames_per_block=frames_per_block)
    params, state = rx.init(cfg)
    rng = np.random.default_rng(7)
    re = jax.device_put(jnp.asarray(
        (rng.standard_normal(cfg.block_size) * 100).astype(np.float32)))
    im = jax.device_put(jnp.asarray(
        (rng.standard_normal(cfg.block_size) * 100).astype(np.float32)))

    print(f"block: {cfg.block_size} samples "
          f"({cfg.block_size / cfg.input_rate * 1e3:.0f} ms of radio time), "
          f"decimator={cfg.decimator_impl}",
          file=sys.stderr)

    dists = {}
    for vname, step in make_variants(cfg).items():
        ts = slope_times(step, params, state, re, im, k1, k2)
        dists[vname] = ts
        med = sorted(ts)[len(ts) // 2]
        print(f"{vname:>8}: {med * 1e3:8.3f} ms/step  "
              f"[{min(ts) * 1e3:.3f}, {max(ts) * 1e3:.3f}]  "
              f"({cfg.block_size / med / 1e6:8.1f} Msps)", file=sys.stderr)

    # serve-path row: probes-enabled receiver + display FFT (the cost the
    # reference always pays in ProcessIQData) — absolute, not a share
    sstep, sparams, sstate = make_serve_variant(cfg)
    ts = slope_times(sstep, sparams, sstate, re, im, k1, k2)
    serve_med = sorted(ts)[len(ts) // 2]
    print(f"{'serve':>8}: {serve_med * 1e3:8.3f} ms/step  "
          f"[{min(ts) * 1e3:.3f}, {max(ts) * 1e3:.3f}]  "
          f"({cfg.block_size / serve_med / 1e6:8.1f} Msps)", file=sys.stderr)
    dists["serve"] = ts

    zero = [0.0] * len(dists["mixdec"])
    shares = {
        "mix_decimate": _share_stats(dists["mixdec"], zero),
        "channel_filter": _share_stats(dists["front"], dists["mixdec"]),
        "smeter_agc": _share_stats(dists["levels"], dists["front"]),
        "demod": _share_stats(dists["demod"], dists["levels"]),
        "resample_tail": _share_stats(dists["full"], dists["demod"]),
        "display_probes": _share_stats(dists["serve"], dists["full"]),
    }
    meds = {k: sorted(v)[len(v) // 2] for k, v in dists.items()}
    total = meds["full"]
    budget = {
        # tolerate callers passing an already-prefixed --name
        "config": name if name.startswith("stage_budget_")
        else f"stage_budget_{name}",
        "frames_per_block": frames_per_block,
        "block": cfg.block_size,
        "fence": "d2h_slope",
        "reps": len(dists["full"]),
        "ms_per_step": {k: round(v * 1e3, 4) for k, v in meds.items()},
        "stage_ms": shares,
        "stage_share_pct": {k: round(100 * (v["ms"] / 1e3) / total, 1)
                            for k, v in shares.items()},
        "full_iq_msps": round(cfg.block_size / total / 1e6, 1),
        "serve_iq_msps": round(cfg.block_size / meds["serve"] / 1e6, 1),
        "note": ("shares from median of all cross-pair slope differences "
                 "over >=5 reps; clamped-at-0 stages keep their raw "
                 "interval in stage_ms (r4's negative shares were "
                 "differencing noise); display_probes = serve-path extra "
                 "(probes program + one 4096-pt display accumulate/block)"),
    }
    print("stage shares of the full step:", file=sys.stderr)
    for k, v in budget["stage_share_pct"].items():
        iv = shares[k]["ms_interval"]
        flag = "  (clamped from <0)" if shares[k]["clamped"] else ""
        print(f"  {k:>16}: {v:6.1f} %  [{iv[0]:.3f}, {iv[1]:.3f}] ms{flag}",
              file=sys.stderr)
    return budget


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=256)
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=32)
    ap.add_argument("--rate", type=float, default=2_000_000.0)
    ap.add_argument("--mode", default="usb")
    ap.add_argument("--name", default=None,
                    help="row suffix (default derived from rate/mode)")
    ap.add_argument("--out", default="bench_out/stage_budget.json")
    args = ap.parse_args(argv)
    from cutesdr_tpu.cache import enable_compile_cache
    enable_compile_cache()
    import jax
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    name = args.name or f"{args.mode}{args.rate / 1e6:g}m"
    budget = run_budget(args.frames, args.k1, args.k2,
                        input_rate=args.rate, mode=args.mode, name=name)
    print(json.dumps(budget))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(budget, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
