"""Prompt encoding interface.

A copy of ``qwen_image_edit_streamdiffusion_tpu/models/text_encoder.py`` kept
in the port, which imports nothing of the JAX package:

- :class:`PromptEmbedding` — fixed-length (L, joint_dim) conditioning + mask;
- :class:`PromptEncoder` — the interface ``models/qwen_vl.py::QwenVLEncoder``
  implements;
- :class:`StubEncoder` — a deterministic, dependency-free pseudo-encoder with
  the same output contract (hashes whitespace tokens into embedding rows and
  pools image statistics), used when the VL encoder is off.

Sequences are bucketed (pad + mask), as in the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, NamedTuple, Protocol, Sequence

import numpy as np

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import VLConfig

# The edit-plus chat template (structure mirrored from the upstream
# pipeline; the system prompt steers the VL model to describe the image and
# apply the instruction).
SYSTEM_PROMPT = (
    "Describe the key features of the input image (color, shape, size, "
    "texture, objects, background), then explain how the user's text "
    "instruction should alter or modify the image. Generate a new image "
    "that meets the user's requirements while maintaining consistency "
    "with the original input where appropriate."
)


class PromptEmbedding(NamedTuple):
    """Fixed-length prompt conditioning.

    embeds: (L, joint_dim) float32/bf16 — a numpy array or a tensor (the
            VL encoder keeps its embeddings on the device)
    mask:   (L,) bool — True at real token positions
    """

    embeds: "np.ndarray | object"
    mask: np.ndarray


class PromptEncoder(Protocol):
    joint_dim: int
    max_len: int

    def encode(
        self, prompt: str, images: Sequence[np.ndarray] = ()
    ) -> PromptEmbedding:
        """images: list of HWC uint8/float arrays (the VL-resolution
        conditioning images, ~384² area)."""
        ...


def encode_many(encoder, requests):
    """Encode a wave of (prompt, images) requests through ``encoder``,
    using its batched ``encode_many`` when it has one (QwenVLEncoder
    coalesces the wave into shared vision work + vmapped LM dispatches)
    and falling back to a sequential loop otherwise. Callers (the edit
    pipeline's CFG pair, the engine's dynamic-batch leader) stay agnostic
    of the encoder implementation."""
    fn = getattr(encoder, "encode_many", None)
    if fn is not None:
        return fn(requests)
    return [encoder.encode(p, imgs) for p, imgs in requests]


def _hash_floats(token: str, dim: int, salt: str = "") -> np.ndarray:
    """Deterministic pseudo-embedding row for a token."""
    seed = int.from_bytes(
        hashlib.sha256((salt + token).encode()).digest()[:8], "little"
    )
    rng = np.random.default_rng(seed)
    return rng.standard_normal(dim).astype(np.float32)


@dataclass
class StubEncoder:
    """Deterministic stand-in for Qwen2.5-VL with the same output contract."""

    joint_dim: int = 3584
    max_len: int = 64

    @classmethod
    def from_config(cls, cfg: VLConfig, max_len: int = 64) -> "StubEncoder":
        return cls(joint_dim=cfg.hidden_size, max_len=max_len)

    def encode(
        self, prompt: str, images: Sequence[np.ndarray] = ()
    ) -> PromptEmbedding:
        rows: List[np.ndarray] = []
        # one pooled row per image (stands in for vision tokens)
        for i, img in enumerate(images):
            arr = np.asarray(img, np.float32)
            stats = np.concatenate(
                [arr.mean(axis=(0, 1)).ravel(), arr.std(axis=(0, 1)).ravel()]
            )
            base = _hash_floats(f"<image:{i}>", self.joint_dim)
            base[: stats.size] += stats / 255.0
            rows.append(base)
        for i, tok in enumerate(prompt.split()):
            rows.append(_hash_floats(tok, self.joint_dim, salt=f"pos{i}:"))
        if not rows:
            rows.append(_hash_floats("<empty>", self.joint_dim))
        rows = rows[: self.max_len]
        n = len(rows)
        embeds = np.zeros((self.max_len, self.joint_dim), np.float32)
        embeds[:n] = np.stack(rows)
        mask = np.zeros((self.max_len,), bool)
        mask[:n] = True
        return PromptEmbedding(embeds=embeds, mask=mask)

    def encode_many(self, requests) -> List[PromptEmbedding]:
        """Protocol parity with QwenVLEncoder.encode_many (no batching to
        exploit in the host-side stub — a plain loop)."""
        return [self.encode(p, imgs) for p, imgs in requests]
