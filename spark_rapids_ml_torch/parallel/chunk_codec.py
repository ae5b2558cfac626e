#
# Spill codecs of the chunk cache (parallel/device_cache.py `ChunkCache`):
# the port of spark_rapids_ml_tpu/parallel/chunk_codec.py, a copy.  A chunk
# that leaves the host tier is serialized through one of these codecs into
# the spill tier, and every spilled buffer carries a crc32 of its RAW bytes,
# so a torn blob is found when it is served again instead of corrupting an
# epoch.
#
# The registry is pluggable: `register_codec` takes any (compress,
# decompress) pair over bytes.  "lz4" and "zstd" resolve only where their
# optional wheels are installed; "zlib" (the standard library) and "none"
# (raw bytes) always resolve.  numpy- and torch-free.
#
from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, Tuple

Compress = Callable[[bytes], bytes]
Decompress = Callable[[bytes], bytes]

_lock = threading.RLock()


def _zlib_pair() -> Tuple[Compress, Decompress]:
    # level 1: the spill sits on the epoch loop; decoded float chunks
    # rarely reward a higher level
    return (lambda b: zlib.compress(b, 1)), zlib.decompress


def _none_pair() -> Tuple[Compress, Decompress]:
    return (lambda b: b), (lambda b: b)


def _lz4_pair() -> Tuple[Compress, Decompress]:
    import lz4.frame  # optional wheel

    return lz4.frame.compress, lz4.frame.decompress


def _zstd_pair() -> Tuple[Compress, Decompress]:
    import zstandard  # optional wheel

    c = zstandard.ZstdCompressor(level=1)
    d = zstandard.ZstdDecompressor()
    return c.compress, d.decompress


# name -> zero-argument factory of (compress, decompress); a factory
# imports its optional wheel only when resolved
_FACTORIES: Dict[str, Callable[[], Tuple[Compress, Decompress]]] = {
    "none": _none_pair,
    "zlib": _zlib_pair,
    "lz4": _lz4_pair,
    "zstd": _zstd_pair,
}


def register_codec(name: str, compress: Compress, decompress: Decompress) -> None:
    """Register a spill codec under `name` (it replaces a built-in of the
    same name)."""
    with _lock:
        _FACTORIES[str(name)] = lambda: (compress, decompress)


def available_codecs() -> Tuple[str, ...]:
    """The registered codecs that resolve here, sorted."""
    with _lock:
        names = tuple(sorted(_FACTORIES))
    out = []
    for n in names:
        try:
            resolve_codec(n)
        except (ImportError, ValueError):
            continue
        out.append(n)
    return tuple(out)


def resolve_codec(name: str) -> Tuple[str, Compress, Decompress]:
    """(name, compress, decompress) of a registered codec.  ValueError for
    an unknown name, ImportError when its optional wheel is missing
    (nothing is installed on its behalf)."""
    name = str(name).lower()
    with _lock:
        factory = _FACTORIES.get(name)
    if factory is None:
        raise ValueError(
            f"unknown chunk_cache_codec {name!r}; registered: "
            f"{', '.join(sorted(_FACTORIES))}"
        )
    try:
        compress, decompress = factory()
    except ImportError as e:
        raise ImportError(
            f"chunk_cache_codec={name!r} needs an optional dependency that is "
            f"not installed ({e}); use 'zlib' or 'none'"
        ) from e
    return name, compress, decompress


def checksum(data: bytes) -> int:
    """crc32 of the RAW (uncompressed) chunk bytes, checked whenever a
    spilled chunk is served again."""
    return zlib.crc32(data) & 0xFFFFFFFF


__all__ = ["available_codecs", "checksum", "register_codec", "resolve_codec"]
