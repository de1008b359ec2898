"""Forcing-data pipeline: binary writer and the native windowed reader.

PyTorch port of ``landhydrology_tpu/runtime/forcing.py``, with the same file
format.  Large per-column forcing time series (wind, air temperature,
humidity, rain ...) are written once with :func:`write_forcing` and consumed
in windows of timesteps through :class:`ForcingReader`, whose backend,
``native/forcingreader.cpp``, mmaps the file and stages the *next* window on
a background thread while the card integrates the current one
(:func:`stream_windows` and :func:`~landhydrology_tpu_torch.runtime.run_forced`
drive that overlap).

The reader is always the native one: ``forcingreader.cpp`` is compiled with
``g++`` at first use into ``landhydrology_tpu_torch/_build/`` (behind a file
lock, so concurrent processes build it once) and bound with ``ctypes``; a
failed build raises with the compiler's output.  There is no ``np.memmap``
fallback.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_MAGIC = 0x31304352464A484C  # "LHJFRC01"
_HEADER = "<QII QQ"
_DTYPE_BY_CODE = {0: np.float32, 1: np.float64}
_CODE_BY_DTYPE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}

_PACKAGE = Path(__file__).resolve().parents[1]
#: the framework-neutral reader the JAX package builds too
SOURCE = _PACKAGE.parent / "native" / "forcingreader.cpp"
BUILD_DIR = _PACKAGE / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None


def build_library() -> Path:
    """Compile ``native/forcingreader.cpp`` into ``_build/`` once per
    content of the source and flag set; concurrent processes serialize on a
    lock file and publish the library by atomic rename.  Returns its path."""
    if not SOURCE.exists():
        raise FileNotFoundError(f"the forcing reader's source is missing: {SOURCE}")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libforcingreader_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "forcingreader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except FileNotFoundError as e:
                raise RuntimeError("g++ not found: the forcing reader is compiled with g++") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, lib)
    return lib


def _load():
    """Build (if needed) and load the reader library; cached per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        c_u32, c_u64, c_p = ctypes.c_uint32, ctypes.c_uint64, ctypes.c_void_p
        signatures = {
            "forcing_open": (c_p, [ctypes.c_char_p]),
            "forcing_info": (ctypes.c_int, [c_p] + [ctypes.POINTER(t) for t in (c_u32, c_u32, c_u64, c_u64)]),
            "forcing_field_name": (ctypes.c_int, [c_p, c_u32, ctypes.c_char_p, c_u32]),
            "forcing_get_times": (ctypes.c_int, [c_p, ctypes.POINTER(ctypes.c_double)]),
            "forcing_prefetch": (ctypes.c_int, [c_p, c_u64, c_u64]),
            "forcing_read": (ctypes.c_int, [c_p, c_u64, c_u64, c_p]),
            "forcing_prefetch_hits": (c_u64, [c_p]),
            "forcing_close": (None, [c_p]),
        }
        for name, (restype, argtypes) in signatures.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def write_forcing(path: str, times: np.ndarray, fields: Dict[str, np.ndarray]) -> None:
    """Write a forcing file (format documented in ``forcingreader.cpp``).

    ``times``: (n_times,) float64 sample times; every field: (n_times,
    n_cols) arrays of one common float dtype (float32 or float64)."""
    times = np.ascontiguousarray(times, dtype=np.float64)
    if not fields:
        raise ValueError("at least one forcing field is required")
    names = sorted(fields)
    arrs = [np.ascontiguousarray(fields[k]) for k in names]
    dtype = arrs[0].dtype
    if dtype not in _CODE_BY_DTYPE:
        raise TypeError(f"unsupported forcing dtype {dtype}")
    n_times = times.shape[0]
    n_cols = arrs[0].shape[1] if arrs[0].ndim == 2 else 1
    for k, a in zip(names, arrs):
        if a.dtype != dtype:
            raise TypeError(f"field {k!r} dtype {a.dtype} != {dtype}")
        if a.reshape(n_times, -1).shape != (n_times, n_cols):
            raise ValueError(f"field {k!r} shape {a.shape} != ({n_times}, {n_cols})")
    with open(path, "wb") as f:
        f.write(struct.pack(_HEADER, _MAGIC, _CODE_BY_DTYPE[dtype], len(names), n_times, n_cols))
        for k in names:
            b = k.encode()
            f.write(struct.pack("<I", len(b)))
            f.write(b)
        f.write(times.tobytes())
        # t-major, field-minor blocks of n_cols
        stacked = np.stack([a.reshape(n_times, n_cols) for a in arrs], axis=1)
        f.write(np.ascontiguousarray(stacked).tobytes())


def _open_error(path: str) -> Exception:
    """Why the native reader refused ``path``."""
    if not os.path.exists(path):
        return FileNotFoundError(f"{path}: no such forcing file")
    with open(path, "rb") as f:
        head = f.read(struct.calcsize(_HEADER))
    if len(head) < 8 or struct.unpack("<Q", head[:8])[0] != _MAGIC:
        return ValueError(f"{path}: not a forcing file (bad magic)")
    return ValueError(f"{path}: truncated forcing file (shorter than its header declares)")


class ForcingReader:
    """Windowed reader over a forcing file: the native reader (mmap and a
    prefetch thread).  ``window`` returns ``{field: (nt, n_cols)}`` arrays;
    ``read_into`` fills a caller's ``(nt, n_fields, n_cols)`` buffer (a
    numpy array or a CPU tensor, pinned or not) straight from the staged
    window."""

    def __init__(self, path: str):
        self._path = path
        self._handle = None
        self._lib = _load()
        self._handle = self._lib.forcing_open(os.fsencode(path))
        if not self._handle:
            raise _open_error(path)
        dc, nf, nt, nc = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint64(), ctypes.c_uint64()
        self._lib.forcing_info(self._handle, ctypes.byref(dc), ctypes.byref(nf), ctypes.byref(nt),
                               ctypes.byref(nc))
        self.dtype = np.dtype(_DTYPE_BY_CODE[dc.value])
        self.n_times, self.n_cols = int(nt.value), int(nc.value)
        self.field_names = []
        buf = ctypes.create_string_buffer(256)
        for i in range(nf.value):
            if self._lib.forcing_field_name(self._handle, i, buf, 256) != 0:
                raise ValueError(f"{path}: field name {i} longer than 255 bytes")
            self.field_names.append(buf.value.decode())
        t = np.empty(self.n_times, dtype=np.float64)
        self._lib.forcing_get_times(self._handle, t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        self.times = t

    @property
    def is_native(self) -> bool:
        """Always true: the port has no other reader."""
        return True

    @property
    def prefetch_hits(self) -> int:
        """Reads served from a window the prefetch thread had staged."""
        return int(self._lib.forcing_prefetch_hits(self._require_open()))

    def _require_open(self):
        if not self._handle:
            raise ValueError(f"{self._path}: the reader is closed")
        return self._handle

    def _check_range(self, i0: int, nt: int) -> None:
        if i0 < 0 or nt < 0 or i0 + nt > self.n_times:
            raise IndexError(f"window [{i0}, {i0 + nt}) out of range [0, {self.n_times})")

    def prefetch(self, i0: int, nt: int) -> None:
        """Stage window [i0, i0+nt) in the background."""
        self._check_range(i0, nt)
        self._lib.forcing_prefetch(self._require_open(), i0, nt)

    def read_into(self, i0: int, nt: int, out) -> None:
        """Blocking read of window [i0, i0+nt) into ``out``, a C-contiguous
        numpy array or CPU tensor of ``nt * n_fields * n_cols`` values of
        the file's dtype, laid out ``(nt, n_fields, n_cols)``."""
        self._check_range(i0, nt)
        n = nt * len(self.field_names) * self.n_cols
        if isinstance(out, torch.Tensor):
            ok = (out.device.type == "cpu" and out.is_contiguous() and out.numel() == n
                  and out.dtype == torch.from_numpy(np.empty(0, self.dtype)).dtype)
            ptr = out.data_ptr()
        else:
            ok = out.flags.c_contiguous and out.size == n and out.dtype == self.dtype
            ptr = out.ctypes.data
        if not ok:
            raise ValueError(
                f"read_into needs a contiguous host buffer of {n} {self.dtype} values; got "
                f"{type(out).__name__} of {out.dtype}, {tuple(out.shape)}"
            )
        rc = self._lib.forcing_read(self._require_open(), i0, nt, ctypes.c_void_p(ptr))
        if rc != 0:
            raise IOError(f"forcing_read failed with code {rc}")

    def window(self, i0: int, nt: int) -> Dict[str, np.ndarray]:
        """Blocking read of window [i0, i0+nt): {field: (nt, n_cols)}."""
        out = np.empty((nt, len(self.field_names), self.n_cols), dtype=self.dtype)
        self.read_into(i0, nt, out)
        return {k: out[:, i, :] for i, k in enumerate(self.field_names)}

    def close(self) -> None:
        if self._handle:
            self._lib.forcing_close(self._handle)
            self._handle = None

    def __enter__(self) -> "ForcingReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()


def stream_windows(
    reader: ForcingReader, window: int, start: int = 0, stop: Optional[int] = None
) -> Iterator[Tuple[int, Dict[str, np.ndarray]]]:
    """Yield ``(i0, fields)`` windows, prefetching window k+1 while the
    caller consumes window k: the host-side half of IO/compute overlap."""
    stop = reader.n_times if stop is None else stop
    i0 = start
    first = min(window, stop - i0)
    if first <= 0:
        return
    reader.prefetch(i0, first)
    while i0 < stop:
        nt = min(window, stop - i0)
        nxt = i0 + nt
        cur = reader.window(i0, nt)
        if nxt < stop:
            reader.prefetch(nxt, min(window, stop - nxt))
        yield i0, cur
        i0 = nxt
