"""COBS framing codec: the native C++ library through ctypes, and the pure
Python codec as its plain version.

Port of ``mpc_rs_tpu/io/cobs.py:1-125``. ``cobs_encode(payload)`` is
``cobs_rs::stuff(buf, 0)`` (src/packet.rs:43-61): one overhead byte a run
of at most 254 bytes and a trailing 0x00 delimiter, so len(payload) + 2
bytes for a payload of at most 253; ``cobs_decode(frame)`` is ``unstuff``.
A frame with a 0x00 inside or cut short raises ``ValueError`` in both codecs.

The native library is ``native/mpcio.cpp``. This module never rebuilds it
in place: it loads the committed ``native/libmpcio.so`` read-only when the
stamp beside it (``libmpcio.so.src.sha256``) is the sha256 of
``native/mpcio.cpp``, and otherwise compiles that source with
``g++ -O2 -fPIC -shared`` into ``mpc_rs_tpu_torch/_build/``. Loading is
lazy (the first call that needs the library), never at import.
``use_native``: None takes the library when it loads and the Python codec
otherwise; True raises when it does not load; False takes the Python codec.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from mpc_rs_tpu_torch.io.native import NativeLibrary, load_stamped

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
SOURCE = NATIVE_DIR / "mpcio.cpp"
COMMITTED = NATIVE_DIR / "libmpcio.so"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """The six ``mpcio_*`` signatures (``mpc_rs_tpu/io/cobs.py:37-48``)."""
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mpcio_cobs_stuff.restype = ctypes.c_int
    lib.mpcio_cobs_stuff.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int]
    lib.mpcio_cobs_unstuff.restype = ctypes.c_int
    lib.mpcio_cobs_unstuff.argtypes = [ctypes.c_char_p, ctypes.c_int, u8p, ctypes.c_int]
    lib.mpcio_serial_open.restype = ctypes.c_int
    lib.mpcio_serial_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.mpcio_serial_read_until_zero.restype = ctypes.c_int
    lib.mpcio_serial_read_until_zero.argtypes = [ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int]
    lib.mpcio_serial_write.restype = ctypes.c_int
    lib.mpcio_serial_write.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.mpcio_serial_close.restype = None
    lib.mpcio_serial_close.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def native_library() -> NativeLibrary | None:
    """The loaded library, or None when neither the committed binary (stamp
    matching the source) nor a build of the source loads."""
    if not SOURCE.is_file():
        return None
    try:
        return load_stamped(SOURCE, COMMITTED, BUILD_DIR, _declare)
    except OSError:
        return None


def native_available() -> bool:
    return native_library() is not None


def _lib(use_native: bool | None):
    if use_native is False:
        return None
    native = native_library()
    if native is None and use_native is True:
        raise RuntimeError("native mpcio library unavailable")
    return None if native is None else native.lib


def _py_cobs_encode(data: bytes) -> bytes:
    out = bytearray()
    code_idx = 0
    out.append(0)  # placeholder for the first code byte
    code = 1
    for b in data:
        if b == 0:
            out[code_idx] = code
            code_idx = len(out)
            out.append(0)
            code = 1
        else:
            out.append(b)
            code += 1
            if code == 0xFF:
                out[code_idx] = code
                code_idx = len(out)
                out.append(0)
                code = 1
    out[code_idx] = code
    out.append(0x00)
    return bytes(out)


def _py_cobs_decode(frame: bytes) -> bytes:
    if frame and frame[-1] == 0:
        frame = frame[:-1]
    out = bytearray()
    i = 0
    n = len(frame)
    while i < n:
        code = frame[i]
        if code == 0:
            raise ValueError("unexpected 0x00 inside COBS frame")
        i += 1
        if i + code - 1 > n:
            raise ValueError("truncated COBS frame")
        out.extend(frame[i : i + code - 1])
        i += code - 1
        if code != 0xFF and i < n:
            out.append(0)
    return bytes(out)


def cobs_encode(data: bytes, use_native: bool | None = None) -> bytes:
    lib = _lib(use_native)
    if lib is None:
        return _py_cobs_encode(data)
    cap = len(data) + 2 + len(data) // 254 + 2
    buf = (ctypes.c_uint8 * cap)()
    n = lib.mpcio_cobs_stuff(data, len(data), buf, cap)
    if n < 0:
        raise ValueError("COBS encode failed")
    return bytes(buf[:n])


def cobs_decode(frame: bytes, use_native: bool | None = None) -> bytes:
    lib = _lib(use_native)
    if lib is None:
        return _py_cobs_decode(frame)
    cap = max(len(frame), 1)
    buf = (ctypes.c_uint8 * cap)()
    n = lib.mpcio_cobs_unstuff(frame, len(frame), buf, cap)
    if n < 0:
        raise ValueError("COBS decode failed")
    return bytes(buf[:n])
