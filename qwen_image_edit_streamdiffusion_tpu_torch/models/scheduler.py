"""Flow-matching Euler scheduler with dynamic exponential timestep shifting.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/scheduler.py``:
:func:`make_schedule` builds the f32 sigma/timestep tables once per (steps,
resolution) and :func:`euler_step` applies x ← x + (σ_next − σ)·v in f32;
:func:`scale_noise` is the forward process the stream re-noises a cached
latent with. The tables stay on the host: a step reads its σ as a Python
float (the f32 value, exactly), so a loop on the card copies nothing to it.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.core.config import SchedulerConfig


class Schedule(NamedTuple):
    sigmas: torch.Tensor     # (num_steps + 1,) f32, descending, last 0
    timesteps: torch.Tensor  # (num_steps,) f32 = sigmas[:-1] · num_train_timesteps


def compute_mu(image_seq_len: int, cfg: SchedulerConfig) -> float:
    m = (cfg.max_shift - cfg.base_shift) / (
        cfg.max_image_seq_len - cfg.base_image_seq_len)
    b = cfg.base_shift - m * cfg.base_image_seq_len
    return image_seq_len * m + b


def _time_shift_exponential(mu: float, sigmas: torch.Tensor) -> torch.Tensor:
    """sigma ↦ e^mu / (e^mu + (1/sigma − 1)) — the "exponential" shift."""
    e = math.exp(mu)
    return e / (e + (1.0 / sigmas - 1.0))


def make_schedule(num_steps: int, image_seq_len: int,
                  cfg: SchedulerConfig = SchedulerConfig()) -> Schedule:
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    sigmas = torch.linspace(1.0, 1.0 / num_steps, num_steps, dtype=torch.float32)
    if cfg.use_dynamic_shifting:
        sigmas = _time_shift_exponential(compute_mu(image_seq_len, cfg), sigmas)
    else:
        s = cfg.shift
        sigmas = s * sigmas / (1.0 + (s - 1.0) * sigmas)
    if cfg.shift_terminal and num_steps > 1:
        one_minus = 1.0 - sigmas
        scale = one_minus[-1] / (1.0 - cfg.shift_terminal)
        sigmas = 1.0 - one_minus / scale
    sigmas = torch.cat([sigmas, torch.zeros(1, dtype=torch.float32)])
    return Schedule(sigmas=sigmas, timesteps=sigmas[:-1] * cfg.num_train_timesteps)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def euler_step(latents: torch.Tensor, velocity: torch.Tensor,
               sigma, sigma_next) -> torch.Tensor:
    """x ← x + (σ_next − σ)·v in f32, cast back to the latents' dtype. The
    σ are host values (schedule entries); σ_next − σ is taken in f32 and
    enters the product as a scalar, so no copy to the device is made."""
    dt = float(_f32(sigma_next) - _f32(sigma))
    return (latents.float() + dt * velocity.float()).to(latents.dtype)


def scale_noise(sample: torch.Tensor, noise: torch.Tensor, sigma) -> torch.Tensor:
    """Forward process x_σ = (1−σ)·x₀ + σ·ε in f32, cast back to the sample's
    dtype (the stream re-noises the previous frame's latent with it)."""
    s = _f32(sigma)
    return (float(1.0 - s) * sample.float() + float(s) * noise.float()).to(sample.dtype)
