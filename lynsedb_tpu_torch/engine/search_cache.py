"""LRU + TTL search-result cache (reference: python/lynse/configs/config.py
:138-225 SEARCH_CACHE_SIZE / SEARCH_CACHE_EXPIRE_SECONDS).

Keys fold in the collection's write version, so any mutation naturally
invalidates every cached entry without a flush hook. Sized/expired via
LYNSE_SEARCH_CACHE_SIZE / LYNSE_SEARCH_CACHE_EXPIRE_SECONDS; size 0 turns
the cache off.
"""

from __future__ import annotations

import hashlib
import time
from collections import OrderedDict
from typing import Any, Optional


class SearchCache:
    def __init__(self, max_size: int, expire_seconds: float):
        self.max_size = int(max_size)
        self.expire_seconds = float(expire_seconds)
        self._entries: "OrderedDict[tuple, tuple[float, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    @property
    def enabled(self) -> bool:
        return self.max_size > 0

    @staticmethod
    def query_key(q_bytes: bytes, *parts) -> tuple:
        digest = hashlib.blake2b(q_bytes, digest_size=16).digest()
        return (digest,) + tuple(parts)

    def get(self, key: tuple) -> Optional[Any]:
        if not self.enabled:
            return None
        hit = self._entries.get(key)
        if hit is None:
            self.misses += 1
            return None
        stamp, value = hit
        if self.expire_seconds > 0 and time.monotonic() - stamp > self.expire_seconds:
            del self._entries[key]
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return value

    def put(self, key: tuple, value: Any) -> None:
        if not self.enabled:
            return
        self._entries[key] = (time.monotonic(), value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_size:
            self._entries.popitem(last=False)

    def clear(self) -> None:
        self._entries.clear()

    def stats(self) -> dict:
        return {
            "entries": len(self._entries),
            "hits": self.hits,
            "misses": self.misses,
            "max_size": self.max_size,
            "expire_seconds": self.expire_seconds,
        }
