"""Native runtime components (C++ with ctypes bindings).

PyTorch port of ``landhydrology_tpu/runtime``: the forcing reader
(``native/forcingreader.cpp``, compiled at first use) mmaps per-column
forcing time series and prefetches the next window of timesteps while the
card integrates the current one; ``run_forced`` is the pipeline that
consumes it.  The trajectory sink (``native/trajsink.cpp``) is not ported
yet (ROADMAP A16).
"""

from landhydrology_tpu_torch.runtime.forcing import ForcingReader, stream_windows, write_forcing
from landhydrology_tpu_torch.runtime.forcing_driver import make_forced_segment_run, run_forced

__all__ = [
    "ForcingReader",
    "write_forcing",
    "stream_windows",
    "make_forced_segment_run",
    "run_forced",
]
