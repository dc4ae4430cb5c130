"""The artifact integrity chain and the crash-safe checkpoint write.

A copy of the checkpoint half of ``stateright_tpu/checker/resilience.py``
(``payload_digest``, ``chain_integrity``, ``atomic_savez`` and
``AUTOSAVE_PREV_SUFFIX``), so a file written by either package verifies
and loads in the other. The rest of that module (the error taxonomy,
retry, the watchdog, the host shadow, the degrade ladder, spill, audit
and autosave) is not ported. Without a shadow the chain head a
checkpoint is signed against is ``""``, as in the JAX package when it
runs without one.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import Dict

import numpy as np

#: the previous autosave generation's suffix: ``<path>`` is always the
#: newest loadable checkpoint, ``<path>.g1`` the one before it. A
#: corrupt or truncated ``<path>`` rolls back one generation on resume.
AUTOSAVE_PREV_SUFFIX = ".g1"


def payload_digest(arrays: Dict[str, np.ndarray]) -> str:
    """Deterministic sha256 over a checkpoint payload: sorted array
    names with dtype, shape and raw bytes — what the integrity chain
    signs, independent of npz compression details."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def chain_integrity(payload_sha: str, chain_head: str) -> str:
    """The integrity field an artifact carries: its payload sha256
    chained to the run's chunk-digest head at write time, so a tampered
    or corrupt payload and a payload transplanted from a different run
    history both fail verification."""
    return hashlib.sha256(
        (payload_sha + ":" + chain_head).encode()).hexdigest()


def atomic_savez(path, **arrays) -> None:
    """``np.savez_compressed`` into a temp file in the target directory,
    fsync, then ``os.replace`` into place — an interrupted write
    (SIGKILL, full disk, a dying host) can never leave a truncated file
    where a good checkpoint stood. The file object (not a path) keeps
    numpy from appending its own ``.npz`` suffix."""
    path = os.fspath(path)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".",
        prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
