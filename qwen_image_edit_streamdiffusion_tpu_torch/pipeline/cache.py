"""Condition caches.

A copy of ``qwen_image_edit_streamdiffusion_tpu/pipeline/cache.py`` kept in
the port, which imports nothing of the JAX package:

- :class:`PromptCache` — LRU over (prompt, image-content-hash) → prompt
  embeddings; a hit skips the VL encode;
- :class:`LatentCache` — LRU over image-content-hash → packed VAE condition
  tokens; a hit skips the VAE encode.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Generic, Hashable, Optional, Sequence, Tuple, TypeVar

import numpy as np

T = TypeVar("T")


def image_fingerprint(arr: np.ndarray) -> str:
    """Content hash of an image array (cheap vs a VL forward pass)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


class LRUCache(Generic[T]):
    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self._d: "OrderedDict[Hashable, T]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable) -> Optional[T]:
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return None

    def put(self, key: Hashable, value: T) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._d),
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else 0.0,
        }


class PromptCache:
    """(prompt, images) → encoded prompt embedding (device arrays)."""

    def __init__(self, encoder, capacity: int = 32):
        self.encoder = encoder
        self.cache: LRUCache = LRUCache(capacity)

    def key(self, prompt: str, images: Sequence[np.ndarray]) -> Tuple:
        return (prompt, tuple(image_fingerprint(a) for a in images))

    def encode(self, prompt: str, images: Sequence[np.ndarray] = ()):
        k = self.key(prompt, images)
        hit = self.cache.get(k)
        if hit is not None:
            return hit
        emb = self.encoder.encode(prompt, images)
        self.cache.put(k, emb)
        return emb

    def encode_many(self, requests):
        """Wave-of-requests twin of :meth:`encode`: per-item cache lookup,
        misses deduplicated within the wave (a dynamic batch's items often
        share the negative prompt + image) and encoded in ONE batched
        encoder call (models.text_encoder.encode_many)."""
        from qwen_image_edit_streamdiffusion_tpu_torch.models.text_encoder import (
            encode_many as _encode_many,
        )

        out: list = [None] * len(requests)
        miss_by_key: dict = {}
        for i, (prompt, images) in enumerate(requests):
            k = self.key(prompt, images)
            hit = self.cache.get(k)
            if hit is not None:
                out[i] = hit
            else:
                miss_by_key.setdefault(k, []).append(i)
        if miss_by_key:
            keys = list(miss_by_key)
            embs = _encode_many(
                self.encoder,
                [requests[idxs[0]] for idxs in miss_by_key.values()],
            )
            for k, emb in zip(keys, embs):
                self.cache.put(k, emb)
                for i in miss_by_key[k]:
                    out[i] = emb
        return out

    def stats(self) -> dict:
        return self.cache.stats()


class LatentCache:
    """image-content-hash → packed VAE condition tokens + rope shapes."""

    def __init__(self, capacity: int = 32):
        self.cache: LRUCache = LRUCache(capacity)

    def get_or_encode(self, arrays: Sequence[np.ndarray], encode_fn):
        k = tuple(image_fingerprint(a) for a in arrays)
        hit = self.cache.get(k)
        if hit is not None:
            return hit
        val = encode_fn(arrays)
        self.cache.put(k, val)
        return val

    def lookup(self, arrays: Sequence[np.ndarray]):
        """Cache probe without an encode fallback (the batched condition
        encoder collects all misses first, then encodes them together)."""
        return self.cache.get(tuple(image_fingerprint(a) for a in arrays))

    def store(self, arrays: Sequence[np.ndarray], val) -> None:
        self.cache.put(tuple(image_fingerprint(a) for a in arrays), val)

    def stats(self) -> dict:
        return self.cache.stats()
