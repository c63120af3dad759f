"""Host-side I/O plane: ASCP protocol, device discovery, radio client,
AD6620 loader, file sources/sinks, rate-locked audio output.

This is the control/transport layer around the device compute path — the
equivalent of the reference's interface/ directory, redesigned as asyncio
host code (with an optional native C++ UDP ingest, see native/).
"""

from cutesdr_tpu.io.ascp import AscpMessage, ci
from cutesdr_tpu.io.filesource import FileSource, WavSink, RawIQWriter
