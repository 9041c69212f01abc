"""ctypes loader for the native host kernels.

The shared library is compiled from ``msanative.cpp`` at first use
(``msa_tpu/native/build.py``) into a git-ignored directory. A host without
a C++ compiler has no native kernel (``native_available()`` is False and
``backend="auto"`` uses numpy); a compiler that fails raises, it is never
papered over.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        from msa_tpu.native.build import build, host_compiler

        if host_compiler() is None:
            from msa_tpu.utils.logging import get_logger

            get_logger("msa_tpu.native").warning(
                "no C++ compiler: native host kernel unavailable"
            )
            _TRIED = True
            return None
        lib = ctypes.CDLL(build())
        _configure(lib)
        _LIB = lib
        _TRIED = True
        return _LIB


def _configure(lib: ctypes.CDLL) -> None:
    lib.nw_score.restype = ctypes.c_int
    lib.nw_score.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.nw_align.restype = ctypes.c_int
    lib.nw_align.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_char_p,  # out align1 buffer (m+n+1)
        ctypes.c_char_p,  # out align2 buffer
        ctypes.POINTER(ctypes.c_int),  # out aligned length
    ]


def native_available() -> bool:
    return _load() is not None


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native backend needs a C++ compiler (g++)")
    return lib


def nw_score_native(x: str, y: str, pxy: int, pgap: int) -> int:
    lib = _require()
    return int(
        lib.nw_score(x.encode(), len(x), y.encode(), len(y), pxy, pgap)
    )


def nw_align_native(
    x: str, y: str, pxy: int, pgap: int
) -> Tuple[int, str, str]:
    lib = _require()
    m, n = len(x), len(y)
    buf1 = ctypes.create_string_buffer(m + n + 1)
    buf2 = ctypes.create_string_buffer(m + n + 1)
    out_len = ctypes.c_int(0)
    penalty = lib.nw_align(
        x.encode(), m, y.encode(), n, pxy, pgap, buf1, buf2,
        ctypes.byref(out_len),
    )
    la = out_len.value
    return (
        int(penalty),
        buf1.raw[:la].decode("latin-1"),
        buf2.raw[:la].decode("latin-1"),
    )
