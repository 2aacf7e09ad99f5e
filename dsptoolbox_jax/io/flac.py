"""FLAC reading through the native C++ decoder.

The reference reads FLAC via libsndfile/soundfile
(`classes/signal.py:106`); here the decode runs in
`dsptoolbox_jax/native/flac_decoder.cpp`, compiled on first use with g++
and bound with ctypes (pybind11 is not available in this environment).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native"
)
_SRC = os.path.join(_NATIVE_DIR, "flac_decoder.cpp")

_lib = None
_lib_lock = threading.Lock()


def _build_library() -> str:
    """Compile the decoder into a shared object (cached next to the
    source; falls back to a per-user temp dir if the package directory is
    read-only)."""
    candidates = [
        os.path.join(_NATIVE_DIR, "libflacdec.so"),
        os.path.join(
            "/tmp", f"dsptoolbox_jax_native_{os.getuid()}", "libflacdec.so"
        ),
    ]
    for so_path in candidates:
        if os.path.exists(so_path) and os.path.getmtime(
            so_path
        ) >= os.path.getmtime(_SRC):
            return so_path
    last_error: Exception | None = None
    for so_path in candidates:
        try:
            os.makedirs(os.path.dirname(so_path), exist_ok=True)
            tmp = so_path + ".tmp"
            subprocess.run(
                [
                    "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                    "-o", tmp, _SRC,
                ],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, so_path)
            return so_path
        except (OSError, subprocess.CalledProcessError) as e:
            last_error = e
    raise RuntimeError(
        f"Could not build native FLAC decoder: {last_error}"
    )


def _get_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(_build_library())
            lib.flac_probe.restype = ctypes.c_int
            lib.flac_probe.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.POINTER(ctypes.c_uint32),
            ]
            lib.flac_decode.restype = ctypes.c_int
            lib.flac_decode.argtypes = [
                ctypes.c_char_p,
                ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int32),
            ]
            _lib = lib
    return _lib


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (float64 in [-1, 1), sampling rate).

    Mono files return shape ``(samples,)``, multichannel
    ``(samples, channels)`` — matching ``soundfile.read``.
    """
    lib = _get_lib()
    with open(path, "rb") as f:
        raw = f.read()
    total = ctypes.c_uint64()
    channels = ctypes.c_uint32()
    rate = ctypes.c_uint32()
    bps = ctypes.c_uint32()
    rc = lib.flac_probe(
        raw, len(raw),
        ctypes.byref(total), ctypes.byref(channels),
        ctypes.byref(rate), ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"Invalid FLAC stream ({rc}): {path}")
    n, ch = int(total.value), int(channels.value)
    out = np.empty(n * ch, dtype=np.int32)
    rc = lib.flac_decode(
        raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    )
    if rc != 0:
        raise ValueError(f"FLAC decode failed ({rc}): {path}")
    scale = float(1 << (int(bps.value) - 1))
    data = out.astype(np.float64) / scale
    if ch > 1:
        data = data.reshape(n, ch)
    return data, int(rate.value)


def write_flac(
    path: str, data: np.ndarray, sampling_rate_hz: int, bits: int = 16
) -> None:
    """Encode ``data (samples,)`` or ``(samples, channels)`` float in
    [-1, 1) as FLAC (verbatim subframes via the native encoder)."""
    lib = _get_lib()
    if not hasattr(lib, "_encode_ready"):
        lib.flac_encode.restype = ctypes.c_int64
        lib.flac_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib._encode_ready = True
    data = np.asarray(data, dtype=np.float64)
    if data.ndim == 1:
        data = data[:, None]
    assert data.ndim == 2, "data must be (samples, channels)"
    # (frames, channels) preserved as-is, like soundfile — no orientation
    # guessing
    n, ch = data.shape
    assert bits in (8, 16, 24), "bits must be 8, 16 or 24"
    max_val = float(2 ** (bits - 1) - 1)
    scaled = np.clip(np.round(data * (2 ** (bits - 1))), -(max_val + 1),
                     max_val).astype(np.int32)
    interleaved = np.ascontiguousarray(scaled.reshape(-1))
    out = np.empty(128 + interleaved.size * 4 + (n // 4096 + 2) * 64,
                   dtype=np.uint8)
    written = lib.flac_encode(
        interleaved.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, ch, int(sampling_rate_hz), bits,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if written < 0:
        raise ValueError(f"FLAC encode failed ({written})")
    with open(path, "wb") as f:
        f.write(out[:written].tobytes())
