"""Packed u64 bitset for tombstones and filter subsets
(reference: src/storage/bitset.rs:17)."""

from __future__ import annotations

import numpy as np


class BitSet:
    __slots__ = ("_words", "_nbits")

    def __init__(self, nbits: int = 0):
        self._nbits = int(nbits)
        self._words = np.zeros((self._nbits + 63) // 64, dtype=np.uint64)

    @classmethod
    def from_bool_array(cls, arr: np.ndarray) -> "BitSet":
        bs = cls(len(arr))
        if len(arr):
            bits = np.packbits(np.asarray(arr, dtype=bool), bitorder="little")
            pad = (-len(bits)) % 8
            if pad:
                bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
            bs._words = bits.view(np.uint64).copy()
        return bs

    def _ensure(self, bit: int) -> None:
        if bit >= self._nbits:
            self._nbits = bit + 1
            need = (self._nbits + 63) // 64
            if need > len(self._words):
                grown = np.zeros(max(need, len(self._words) * 2 or 1), dtype=np.uint64)
                grown[: len(self._words)] = self._words
                self._words = grown

    def set(self, bit: int, value: bool = True) -> None:
        self._ensure(bit)
        w, off = divmod(bit, 64)
        if value:
            self._words[w] |= np.uint64(1) << np.uint64(off)
        else:
            self._words[w] &= ~(np.uint64(1) << np.uint64(off))

    def get(self, bit: int) -> bool:
        if bit >= self._nbits:
            return False
        w, off = divmod(bit, 64)
        return bool((self._words[w] >> np.uint64(off)) & np.uint64(1))

    def count(self) -> int:
        return int(np.unpackbits(self._words.view(np.uint8), bitorder="little").sum())

    def to_bool_array(self, n: int | None = None) -> np.ndarray:
        n = self._nbits if n is None else int(n)
        if n == 0:
            return np.zeros(0, dtype=bool)
        bits = np.unpackbits(self._words.view(np.uint8), bitorder="little")
        if len(bits) < n:
            bits = np.concatenate([bits, np.zeros(n - len(bits), dtype=np.uint8)])
        return bits[:n].astype(bool)

    def iter_set_bits(self):
        return iter(np.nonzero(self.to_bool_array())[0].tolist())

    def __len__(self) -> int:
        return self._nbits

    # ── persistence ──────────────────────────────────────────────────────

    def to_bytes(self) -> bytes:
        nwords = (self._nbits + 63) // 64
        return self._nbits.to_bytes(8, "little") + self._words[:nwords].tobytes()

    @classmethod
    def from_bytes(cls, data: bytes) -> "BitSet":
        nbits = int.from_bytes(data[:8], "little")
        bs = cls(nbits)
        words = np.frombuffer(data[8:], dtype=np.uint64)
        bs._words[: len(words)] = words
        return bs
