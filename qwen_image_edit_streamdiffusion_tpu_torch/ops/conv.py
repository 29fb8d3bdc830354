"""The small-channel 3×3 conv (K3).

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/ops/conv.py``: the Pallas
``_conv_kernel`` becomes ``csrc/conv3x3.cu``. Layout NHWC activations, HWIO
weights, as in the JAX package. The wrapper takes the plain PyTorch version
only for tensors on the CPU; a CUDA tensor launches the kernel or raises. The
kernel has no backward (nor has the Pallas conv a VJP): with grad mode on, an
input that needs a gradient is refused before the launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qwen_image_edit_streamdiffusion_tpu_torch.runtime import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def supported(x: torch.Tensor, w: torch.Tensor, stride: int, padding) -> bool:
    """The JAX gate without its TPU tiling and VMEM clauses: stride-1 SAME
    3×3 with C_in <= 128 and C_in % 8 == 0."""
    if stride != 1 or padding != "SAME":
        return False
    if tuple(w.shape[:2]) != (3, 3):
        return False
    cin = x.shape[-1]
    return cin <= 128 and cin % 8 == 0


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """x (B, H, W, C) · w (3, 3, C, F) + b (F,), stride 1, SAME padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K3: x (B, H, W, C) · w (3, 3, C, F) + b (F,) — stride 1, SAME."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, b)
    kernels.refuse_grad("conv3x3", x, w, b)
    if x.device.type != "cuda":
        raise RuntimeError(f"conv3x3: unsupported device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3: dtype must be float32 or bfloat16, got {x.dtype}")
    bsz, h, wid, cin = x.shape
    if tuple(w.shape[:3]) != (3, 3, cin) or w.dim() != 4:
        raise ValueError(f"conv3x3: weight {tuple(w.shape)} for input {tuple(x.shape)}")
    f = w.shape[3]
    if tuple(b.shape) != (f,):
        raise ValueError(f"conv3x3: bias {tuple(b.shape)}, expected ({f},)")
    if cin > 128 or cin % 8:
        raise ValueError(f"conv3x3: C_in {cin} outside the kernel's gate")
    if bsz * -(-f // 32) > 65535:  # grid.z = batch × 32-channel output slices
        raise ValueError(f"conv3x3: batch {bsz} × {f} output channels too large")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(f"conv3x3: {name} is {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"conv3x3: {name} must be contiguous")
        if name != "b" and t.data_ptr() % 16:  # 16-byte copies of x and w
            raise ValueError(f"conv3x3: {name} must be 16-byte aligned")
    lib = kernels.library()
    y = torch.empty((bsz, h, wid, f), dtype=x.dtype, device=x.device)
    err = lib.qie_conv3x3(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                          bsz, h, wid, cin, f, _DTYPES[x.dtype],
                          kernels.current_stream_handle(x.device))
    kernels.check(err, "conv3x3")
    kernels.LAUNCHES["conv3x3"] += 1
    return y
