"""The native fingerprint core, built at first use with the system C
compiler.

A copy of ``stateright_tpu/_native`` (``fphash.c`` verbatim): the host's
hottest hash — the chunk audit re-hashes every audited chunk's fresh
rows, ``checker/resilience.py`` ``oracle_fps`` — runs in C. The library
is compiled once into ``<repo>/build/native/`` (git-ignored), named by a
hash of the source so a stale build is never loaded, written to a
temporary file and moved into place (parallel test workers may build at
once), and bound with ``ctypes``. Without a compiler :func:`load` answers
``None`` and ``fingerprint.py`` keeps its pure-Python body, which stays
the reference the tests hold the C core to.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "fphash.c"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"libfphash_{tag}.so"


def _build(path: Path) -> bool:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    for cc in ("cc", "gcc", "clang"):
        try:
            result = subprocess.run(
                [cc, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if result.returncode == 0:
            os.replace(tmp, path)
            return True
    return False


def load() -> Optional[ctypes.CDLL]:
    """The fphash library, built on first use; ``None`` if no compiler
    could build it."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _library_path()
        try:
            if not path.exists() and not _build(path):
                return None
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.fp64_words.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.c_size_t]
        lib.fp64_words.restype = ctypes.c_uint64
        lib.fp64_rows.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.c_size_t, ctypes.c_size_t,
                                  ctypes.POINTER(ctypes.c_uint64)]
        lib.fp64_rows.restype = None
        _lib = lib
        return _lib
