"""Stable 64-bit state fingerprints (a copy of ``stateright_tpu.fingerprint``).

``fp64_words`` and ``fp64_rows`` dispatch to the native C core
(``_native/fphash.c``, built at first use) when a compiler could build
it, as the JAX package's do; the pure-Python body is the reference and
the fallback, and :func:`core` names the one that answers.

The same hash is computed on the host (here), by the plain torch version
(``ops/hash_kernel.py``) and by the CUDA kernels (``csrc/fused_step.cu``)
over a canonical ``uint32``-word encoding of a state, so host and device
fingerprints agree bit for bit.

Layout contract (shared with the C core and the device kernel), all
arithmetic mod 2^32:

  P_i  = fmix32((i + 1) * GOLDEN)          # per-position whitening key
  x_i  = w_i ^ P_i
  h1   = XOR_i fmix32(x_i * C1_1)          # two independent 32-bit lanes
  h2   = XOR_i fmix32(x_i * C1_2)
  fp64 = (fmix32(h1 ^ SEED1 ^ n) << 32) | fmix32(h2 ^ SEED2 ^ n * C1_1)

where n = len(words). Each lane XOR-combines a bijective whitening of each
(word, position) pair, so single-word differences always change both lanes
and multi-word collisions require a simultaneous 64-bit match across two
independently-mixed lanes. A zero digest is mapped to 1 (fingerprints are
non-zero, mirroring ``NonZeroU64`` in the reference).
"""

from __future__ import annotations

import ctypes as _ctypes
import dataclasses
import enum
import struct
import threading as _threading
from array import array as _array
from typing import Any, Iterable, List

M32 = 0xFFFFFFFF

# Lane multipliers: murmur3_x86_32's first constant and murmur3_x86_128's
# first constant. GOLDEN = 2^32 / golden ratio keys the per-position
# whitening. The seeds separate the two lanes' finalizers.
C1_1 = 0xCC9E2D51
C1_2 = 0x239B961B
GOLDEN = 0x9E3779B9
SEED1 = 0x9747B28C
SEED2 = 0x85EBCA6B


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & M32
    h ^= h >> 16
    return h


# Version of the fingerprint layout. Bump whenever the algorithm changes:
# checkpoints embed it so a resume against differently-hashed history is
# rejected instead of silently corrupting the search.
FP_VERSION = 2

_COL_KEYS: List[int] = []
_COL_KEYS_LOCK = _threading.Lock()


def col_keys(n: int) -> List[int]:
    """The first ``n`` per-position whitening keys ``P_i`` (host cache;
    the device kernel materializes the same values as a constant)."""
    if len(_COL_KEYS) < n:
        with _COL_KEYS_LOCK:
            # re-check under the lock; compute each key from its target
            # index so concurrent extenders can never shift positions
            for i in range(len(_COL_KEYS), n):
                _COL_KEYS.append(_fmix32((i + 1) * GOLDEN & M32))
    return _COL_KEYS[:n]


def _native_lib():
    """The C fingerprint core, or ``None`` (the pure-Python body)."""
    from . import _native
    return _native.load()


def core() -> str:
    """Which fingerprint core answers: ``"native"`` or ``"python"``."""
    return "python" if _native_lib() is None else "native"


def fp64_words(words: Iterable[int]) -> int:
    """Hash a sequence of uint32 words into a non-zero 64-bit fingerprint,
    through the native core when it is built (:func:`_fp64_words_py` is
    the reference). The device versions (``ops/hash_kernel.py`` and the
    CUDA kernels) must match it bit for bit."""
    lib = _native_lib()
    if lib is None:
        return _fp64_words_py(words)
    if not isinstance(words, (list, tuple)):
        words = list(words)  # the masked retry below reads them again
    try:
        buf = _array("I", words)
    except (OverflowError, TypeError):
        buf = _array("I", [w & M32 for w in words])
    if not len(buf):
        return lib.fp64_words(None, 0)
    addr, n = buf.buffer_info()
    return lib.fp64_words(
        _ctypes.cast(addr, _ctypes.POINTER(_ctypes.c_uint32)), n)


def fp64_rows(rows) -> list:
    """Fingerprint a batch of packed states on the host: ``rows`` uint32
    ``[N, W]``; returns N fingerprints, equal row for row to
    :func:`fp64_words` (one C call with the native core)."""
    import numpy as np
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    count, width = rows.shape
    lib = _native_lib()
    if lib is None:
        return [_fp64_words_py(row.tolist()) for row in rows]
    out = np.empty((count,), dtype=np.uint64)
    if count:
        lib.fp64_rows(
            rows.ctypes.data_as(_ctypes.POINTER(_ctypes.c_uint32)),
            count, width,
            out.ctypes.data_as(_ctypes.POINTER(_ctypes.c_uint64)))
    return out.tolist()


def _fp64_words_py(words: Iterable[int]) -> int:
    """The pure-Python body of :func:`fp64_words`: the reference."""
    h1 = 0
    h2 = 0
    n = 0
    keys = _COL_KEYS
    for w in words:
        if n >= len(keys):
            col_keys(n + 1)  # extend the shared cache in place
        x = (w & M32) ^ keys[n]
        h1 ^= _fmix32((x * C1_1) & M32)
        h2 ^= _fmix32((x * C1_2) & M32)
        n += 1

    h1 = _fmix32(h1 ^ SEED1 ^ n)
    h2 = _fmix32(h2 ^ SEED2 ^ ((n * C1_1) & M32))
    fp = (h1 << 32) | h2
    return fp if fp != 0 else 1


def fp64_node(fp: int, ebits_mask: int) -> int:
    """Dedup identity of a search NODE under sound-eventually checking:
    the state fingerprint combined with the pending eventually-bits, as
    the words ``[lo, hi, ebits]`` (``ops/hash_kernel.py``
    ``fp64_node_device`` and the kernels' ``fp64_node`` match it bit for
    bit). The Rust crate leaves the bits out of the state identity and
    documents the counterexamples it then misses (``bfs.rs:239-244``);
    ``CheckerBuilder.sound_eventually()`` opts into including them."""
    return fp64_words([fp & M32, (fp >> 32) & M32, ebits_mask & M32])


# ---------------------------------------------------------------------------
# Canonical word encoding of Python state values.
#
# Mirrors the reference's reliance on Rust ``#[derive(Hash)]`` plus the
# order-insensitive containers in ``src/util.rs`` (``HashableHashSet`` hashes
# each element, sorts the 64-bit hashes, and feeds them to the outer hasher —
# ``util.rs:124-145``; ``HashableHashMap`` does the same per (k, v) entry —
# ``util.rs:321-343``).
# ---------------------------------------------------------------------------

_TAG_NONE = 0
_TAG_BOOL = 1
_TAG_INT = 2
_TAG_STR = 3
_TAG_BYTES = 4
_TAG_SEQ = 5
_TAG_SET = 6
_TAG_MAP = 7
_TAG_OBJ = 8
_TAG_ENUM = 9
_TAG_FLOAT = 10


def _emit_packed_bytes(data: bytes, out: List[int]) -> None:
    out.append(len(data))
    for i in range(0, len(data), 4):
        out.append(int.from_bytes(data[i:i + 4], "little"))


_CLASS_FP_CACHE: dict = {}
_FIELD_NAMES_CACHE: dict = {}


def _field_names(cls: type) -> tuple:
    names = _FIELD_NAMES_CACHE.get(cls)
    if names is None:
        names = tuple(f.name for f in dataclasses.fields(cls))
        _FIELD_NAMES_CACHE[cls] = names
    return names


def _class_fp(cls: type) -> int:
    fp = _CLASS_FP_CACHE.get(cls)
    if fp is None:
        words: List[int] = []
        _emit_packed_bytes(cls.__qualname__.encode(), words)
        fp = fp64_words(words)
        _CLASS_FP_CACHE[cls] = fp
    return fp


def stable_words(value: Any, out: List[int]) -> None:
    """Append the canonical uint32-word encoding of ``value`` to ``out``."""
    if value is None:
        out.append(_TAG_NONE)
    elif value is True or value is False:
        out.append(_TAG_BOOL)
        out.append(1 if value else 0)
    elif isinstance(value, int) and not isinstance(value, enum.Enum):
        out.append(_TAG_INT)
        sign = 1 if value < 0 else 0
        mag = -value if sign else value
        mag_words: List[int] = []
        while mag:
            mag_words.append(mag & M32)
            mag >>= 32
        out.append(sign)
        out.append(len(mag_words))
        out.extend(mag_words)
    elif isinstance(value, str):
        out.append(_TAG_STR)
        _emit_packed_bytes(value.encode(), out)
    elif isinstance(value, (bytes, bytearray)):
        out.append(_TAG_BYTES)
        _emit_packed_bytes(bytes(value), out)
    elif isinstance(value, enum.Enum):
        out.append(_TAG_ENUM)
        cfp = _class_fp(type(value))
        out.append(cfp & M32)
        out.append((cfp >> 32) & M32)
        _emit_packed_bytes(value.name.encode(), out)
    elif isinstance(value, (tuple, list)):
        out.append(_TAG_SEQ)
        out.append(len(value))
        for item in value:
            stable_words(item, out)
    elif isinstance(value, (set, frozenset)):
        # Order-insensitive: sorted element fingerprints (util.rs:124-145).
        out.append(_TAG_SET)
        out.append(len(value))
        for fp in sorted(stable_fingerprint(item) for item in value):
            out.append(fp & M32)
            out.append((fp >> 32) & M32)
    elif isinstance(value, dict):
        # Order-insensitive: sorted entry fingerprints (util.rs:321-343).
        out.append(_TAG_MAP)
        out.append(len(value))
        for fp in sorted(stable_fingerprint((k, v)) for k, v in value.items()):
            out.append(fp & M32)
            out.append((fp >> 32) & M32)
    elif isinstance(value, float):
        out.append(_TAG_FLOAT)
        bits = struct.unpack("<Q", struct.pack("<d", value))[0]
        out.append(bits & M32)
        out.append((bits >> 32) & M32)
    elif hasattr(value, "__stable_words__"):
        value.__stable_words__(out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        out.append(_TAG_OBJ)
        cfp = _class_fp(type(value))
        out.append(cfp & M32)
        out.append((cfp >> 32) & M32)
        for name in _field_names(type(value)):
            stable_words(getattr(value, name), out)
    else:
        raise TypeError(
            f"cannot stably fingerprint value of type {type(value)!r}; "
            f"implement __stable_words__(out) or use a supported type")


def stable_fingerprint(value: Any) -> int:
    """Non-zero 64-bit stable fingerprint of an arbitrary state value."""
    words: List[int] = []
    stable_words(value, words)
    return fp64_words(words)
