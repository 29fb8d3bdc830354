"""Deterministic torch generators, one per named stream.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/core/rng.py``: one
user-facing seed, with independent named streams (weights of each model, the
initial latents, the noise of each stream frame) derived from it by hashing
the name. Torch's generators give other numbers than ``jax.random`` for the
same seed; that divergence is accepted, and parity tests hand both sides the
same weights and noise.
"""

from __future__ import annotations

import hashlib

import torch

DEFAULT_SEED = 42


def stream_seed(seed: int, name: str) -> int:
    """A 63-bit seed for the stream ``name`` of ``seed`` (stable across runs)."""
    h = int.from_bytes(hashlib.sha256(f"{seed}:{name}".encode()).digest()[:8],
                       "little")
    return h & ((1 << 63) - 1)


def stream(seed: int, name: str, device="cpu") -> torch.Generator:
    """A generator on ``device`` for the named stream of ``seed``."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(stream_seed(seed, name))
    return g


def frame_stream(seed: int, name: str, frame_index: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` for frame ``frame_index`` of the named stream
    of ``seed`` (the JAX ``frame_key(stream(key, name), i)``): the stream's
    noise of each stream frame, drawn on the device with no host copy."""
    return stream(seed, f"{name}/{int(frame_index)}", device)
