"""Keyed blob cache with serialization & checksums.

Counterpart of libplacebo_tpu/core/cache.py (the reference's pl_cache,
src/cache.c): a locked keyed object store with size caps and
least-recently-used eviction, and the same wire format (magic
b"PLTPUCCH", version 1, per object a little-endian <QQI key / size /
CRC32 header), so a blob saved by either package loads in the other.
Corrupt or stale entries are dropped on load.

The reference's XLA compile-cache switches (`_machine_key`,
`set_xla_cache_dir`, `enable_default_xla_cache`) have no CUDA
counterpart and are not ported: the port's compiled artifacts are its
kernel libraries, whose directory `runtime.GpuContext.set_disk_cache`
sets (`_build.set_build_dir`).
"""
from __future__ import annotations

import io
import os
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, Optional

__all__ = ["Cache", "CacheParams", "cache_create"]

_MAGIC = b"PLTPUCCH"
_VERSION = 1


def _checksum(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


@dataclass
class CacheParams:
    """Reference pl_cache_params (cache.h:32-74)."""
    max_object_size: int = 0       # 0 = unlimited
    max_total_size: int = 0
    get: Optional[Callable] = None  # external backing get(key)->bytes|None
    set: Optional[Callable] = None  # external backing set(key, bytes)


@dataclass
class _Obj:
    key: int
    data: bytes
    atime: float


class Cache:
    """Reference pl_cache object (cache.h:94-212)."""

    def __init__(self, params: Optional[CacheParams] = None):
        self.params = params or CacheParams()
        self._objs: Dict[int, _Obj] = {}
        self._lock = threading.Lock()

    # -- primitive API ------------------------------------------------

    def try_set(self, key: int, data: Optional[bytes]) -> bool:
        """Insert/replace an object; None or b'' deletes. Returns False
        if rejected (over max_object_size)."""
        with self._lock:
            if not data:
                self._objs.pop(key, None)
                return True
            if self.params.max_object_size and \
                    len(data) > self.params.max_object_size:
                return False
            self._objs[key] = _Obj(key, bytes(data), time.monotonic())
            self._evict_locked()
            if self.params.set:
                self.params.set(key, bytes(data))
            return True

    def set(self, key: int, data: Optional[bytes]):
        self.try_set(key, data)

    def get(self, key: int) -> Optional[bytes]:
        with self._lock:
            obj = self._objs.get(key)
            if obj is not None:
                obj.atime = time.monotonic()
                return obj.data
        if self.params.get:
            data = self.params.get(key)
            if data:
                self.try_set(key, data)
            return data
        return None

    def _evict_locked(self):
        if not self.params.max_total_size:
            return
        total = sum(len(o.data) for o in self._objs.values())
        if total <= self.params.max_total_size:
            return
        # LRU eviction by access time (reference evicts oldest)
        for obj in sorted(self._objs.values(), key=lambda o: o.atime):
            del self._objs[obj.key]
            total -= len(obj.data)
            if total <= self.params.max_total_size:
                break

    @property
    def num_objects(self) -> int:
        with self._lock:
            return len(self._objs)

    @property
    def total_size(self) -> int:
        with self._lock:
            return sum(len(o.data) for o in self._objs.values())

    def reset(self):
        with self._lock:
            self._objs.clear()

    def signature(self) -> int:
        """Order-independent hash (XOR of keys) of all stored objects —
        used to avoid re-saving unmodified caches (reference
        pl_cache_signature, cache.c:262)."""
        with self._lock:
            sig = 0
            for key in self._objs:
                sig ^= key & (2**64 - 1)
            return sig

    def iterate(self):
        """Yield (key, data) for every stored object (reference
        pl_cache_iterate, cache.h:212 — the callback form becomes a
        generator)."""
        with self._lock:
            items = [(o.key, o.data) for o in self._objs.values()]
        yield from items

    # -- serialization (reference cache.c:283-360) --------------------

    def save(self) -> bytes:
        """Serialize all objects: magic, version, count, then per object
        (key, size, checksum, payload)."""
        with self._lock:
            buf = io.BytesIO()
            buf.write(_MAGIC)
            buf.write(struct.pack("<II", _VERSION, len(self._objs)))
            for obj in self._objs.values():
                buf.write(struct.pack("<QQI", obj.key & (2**64 - 1),
                                      len(obj.data), _checksum(obj.data)))
                buf.write(obj.data)
            return buf.getvalue()

    def load(self, data: bytes) -> int:
        """Deserialize; returns number of objects accepted. Corrupt
        entries/trailing garbage silently dropped."""
        n_ok = 0
        try:
            buf = io.BytesIO(data)
            if buf.read(8) != _MAGIC:
                return 0
            version, count = struct.unpack("<II", buf.read(8))
            if version != _VERSION:
                return 0
            for _ in range(count):
                hdr = buf.read(20)
                if len(hdr) < 20:
                    break
                key, size, chk = struct.unpack("<QQI", hdr)
                payload = buf.read(size)
                if len(payload) < size or _checksum(payload) != chk:
                    continue
                if self.try_set(key, payload):
                    n_ok += 1
        except struct.error:        # a truncated header
            pass
        return n_ok

    # -- file helpers (reference cache.h:173-179) ---------------------

    def save_file(self, path: str):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(self.save())
        os.replace(tmp, path)

    def load_file(self, path: str) -> int:
        try:
            with open(path, "rb") as f:
                return self.load(f.read())
        except OSError:
            return 0


def cache_create(params: Optional[CacheParams] = None) -> Cache:
    return Cache(params)
