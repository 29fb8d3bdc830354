"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, at first use, into ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), and loaded with
``ctypes``. The library's file name carries a hash of the sources, so an edit
rebuilds and a stale library is never loaded. Nothing here is imported or
built when a module is imported: :func:`library` runs only when a wrapper is
handed a CUDA tensor.

``LAUNCHES`` holds one plain integer per kernel. Each wrapper adds one to its
count right after it launches its kernel, and nowhere else, so a run can show
that the main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("flash_fwd_sm90.cu", "flash_attention_bwd.cu", "conv3x3.cu",
           "int8_gemm.cu")
HEADERS = ("mma_bf16.cuh", "sm90.cuh")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

# kernel name -> launches since the last reset
# (flash_joint_stream counts the joint launches whose K/V per head exceed the
# JAX package's resident budget: the role of its streaming kernel, K4)
LAUNCHES: Dict[str, int] = {"flash_joint": 0, "flash_joint_stream": 0,
                            "flash_causal": 0, "conv3x3": 0,
                            "quantize_rows": 0, "int8_gemm": 0,
                            "flash_fwd_lse": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    objs = [out.parent / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
    cmds = [[nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", str(o), str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_suffix(f".{tag}.so")
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [c for c, p in zip(cmds, procs) if p.returncode != 0]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        cmds.append(link)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(link)
    build_log = "".join(" ".join(c) + "\n" + log for c, log in zip(cmds, logs))
    (out.parent / "build.log").write_text(build_log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    os.replace(tmp, out)


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built; its
    compiler log is ``build.log`` beside it."""
    return BUILD_DIR / f"libqie_kernels_{_source_hash()}.so"


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.qie_flash_fwd_sm90.argtypes = [
            vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.qie_flash_fwd_sm90.restype = ci
        lib.qie_flash_causal_sm90.argtypes = [
            vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, ci, vp]
        lib.qie_flash_causal_sm90.restype = ci
        lib.qie_flash_bwd_dq_bf16.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.qie_flash_bwd_dq_bf16.restype = ci
        lib.qie_flash_bwd_dkv_bf16.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.qie_flash_bwd_dkv_bf16.restype = ci
        lib.qie_conv3x3.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
        lib.qie_conv3x3.restype = ci
        lib.qie_quantize_rows_bf16.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.qie_quantize_rows_bf16.restype = ci
        lib.qie_int8_gemm_sm90.argtypes = [vp] * 8 + [ci] * 6 + [vp]
        lib.qie_int8_gemm_sm90.restype = ci
        lib.qie_quantize_rows_given_bf16.argtypes = [vp, vp, vp, ci, ci, vp]
        lib.qie_quantize_rows_given_bf16.restype = ci
        lib.qie_int8_gemm_sm90_acc.argtypes = [vp] * 5 + [ci] * 6 + [vp]
        lib.qie_int8_gemm_sm90_acc.restype = ci
        lib.qie_row_scales_bf16.argtypes = [vp, vp, ci, ci, vp]
        lib.qie_row_scales_bf16.restype = ci
        lib.qie_int8_epilogue_bf16.argtypes = [vp] * 5 + [ci] * 2 + [vp]
        lib.qie_int8_epilogue_bf16.restype = ci
        lib.qie_int8_gemm_mma.argtypes = [vp] * 6 + [ci] * 3 + [vp]
        lib.qie_int8_gemm_mma.restype = ci
        _lib = lib
        return lib


def refuse_grad(what: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise before a launch when autograd would record the call: a kernel
    without a backward would return a result with no graph, and the
    gradient would be lost without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward, and an input "
                           "needs a gradient; run it under torch.no_grad()")


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error from its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def current_stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
