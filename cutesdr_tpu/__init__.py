"""cutesdr_tpu — a software-defined-radio framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of CuteSDR 1.02
(reference: C++/Qt desktop SDR receiver).  The signal chain
(tune -> decimate -> filter -> AGC -> demodulate -> resample) is expressed as
pure functional block processors ``f(params, carry, x) -> (carry, y)`` that
compile to a single fused XLA program per configuration, batch over channels
with ``vmap`` and shard over time with ``shard_map`` + ``ppermute`` halos.

Layer map (mirrors reference SURVEY.md section 1, re-architected):

  L4  cli / session        cutesdr_tpu.cli, cutesdr_tpu.session
  L3  radio control plane  cutesdr_tpu.io (ascp, netsdr, discover, ad6620)
  L2  DSP pipeline         cutesdr_tpu.{design,ops,demod,pipeline,kernels}
  L1  I/O transport        cutesdr_tpu.io (ingest, audio_sink) + native/
"""

__version__ = "0.1.0"

from cutesdr_tpu import types as types
