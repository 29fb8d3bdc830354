"""The port's converted checkpoints, and the offline HF → port conversion.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/models/checkpoint.py``,
which writes Orbax; the card host has no orbax, so the port keeps its own
format: a directory of ``.safetensors`` shards of the flattened params
(``models/common.py::flatten`` keys, such as ``blocks.0.attn.img_qkv.w_q``)
and the index ``model.safetensors.index.json``. Every shard's
``__metadata__`` (and the index's ``metadata``) holds the format, the
component (``transformer``, ``vae`` or ``vl``), the preset name, the rung
(``""``, ``"8"`` or ``"4"``) and whether q/k/v are fused (``"1"`` or
``"0"``). :func:`layout` reads them from the shard headers alone and holds
them against the saved keys; a mismatch raises.

CLI for the offline conversion, one shard in host memory at a time:

  python -m qwen_image_edit_streamdiffusion_tpu_torch.models.checkpoint convert \\
      --src /path/to/hf_checkpoint/transformer --component transformer \\
      --preset qwen-image-edit-2509 --out /ckpt/transformer \\
      [--lora adapter.safetensors] [--fuse-qkv] [--quantize int8|int4] [--device cuda]

It keeps the JAX order, LoRA fuse → q/k/v fuse → quantize, applied to each
linear as soon as its tensors (and, for a fused q/k/v, all three
projections) have arrived, on ``--device``: a quantized flagship never holds
its bf16 copy beside the quantized one. ``--component vl`` also copies the
checkpoint's ``tokenizer.json`` and ``tokenizer_config.json`` into ``--out``
(:func:`find_tokenizer`), where ``EditPipeline.from_checkpoint`` finds them.
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Any, Dict, Optional, Set, Tuple

import torch

from qwen_image_edit_streamdiffusion_tpu_torch.models import convert as cv
from qwen_image_edit_streamdiffusion_tpu_torch.models import lora, quantize
from qwen_image_edit_streamdiffusion_tpu_torch.models.common import flatten, unflatten
from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_three

FORMAT = "qwen_image_edit_streamdiffusion_tpu_torch"
BASENAME = "model"
SHARD_BYTES = 5 << 30  # HF's default shard size
COMPONENTS = ("transformer", "vae", "vl")


def save(path: str, params: Any, meta: Dict[str, Any]) -> None:
    """Write ``params`` (on any device; one tensor at a time is copied to the
    host) under the directory ``path`` with ``meta``'s ``component`` and
    ``preset``; the rung and the q/k/v layout are read off the tree. An
    existing checkpoint there is not overwritten."""
    if os.path.exists(os.path.join(path, f"{BASENAME}.safetensors.index.json")):
        raise FileExistsError(f"{path!r} already holds a checkpoint")
    bits = quantize.saved_bits(params)
    keys = _parts(flatten(params))
    metadata = {"format": FORMAT, "component": str(meta["component"]),
                "preset": str(meta["preset"]), "rung": str(bits or ""),
                "fused_qkv": "1" if "img_qkv" in keys else "0"}
    lora.save_safetensors(path, flatten(params), metadata=metadata,
                          max_shard_bytes=SHARD_BYTES, basename=BASENAME)


def _parts(keys) -> Set[str]:
    return {p for k in keys for p in k.split(".")}


def saved_keys(path: str) -> Set[str]:
    """Every component of every saved key (``blocks``, ``img_qkv``, ``w_q``,
    ...), from the shard headers alone: no array is read."""
    keys: Set[str] = set()
    for fn in cv.shard_files(path):
        header, _ = cv.read_header(fn)
        keys |= _parts(k for k in header if k != "__metadata__")
    return keys


def metadata(path: str) -> Dict[str, str]:
    """The shards' ``__metadata__``, which must agree and name this format."""
    seen = None
    for fn in cv.shard_files(path):
        header, _ = cv.read_header(fn)
        md = header.get("__metadata__") or {}
        if md.get("format") != FORMAT:
            raise ValueError(f"{fn}: not a checkpoint of {FORMAT} (convert HF "
                             "weights with `python -m "
                             f"{__name__} convert`)")
        if seen is not None and md != seen:
            raise ValueError(f"{path}: shards disagree on their metadata: {seen} vs {md}")
        seen = md
    return seen


def layout(path: str, component: Optional[str] = None) -> Tuple[str, Optional[int], bool]:
    """(component, rung bits or None, q/k/v fused) of a checkpoint, from its
    metadata, held against its saved keys; raises when they disagree or the
    component is not ``component``."""
    md = metadata(path)
    if component is not None and md["component"] != component:
        raise ValueError(f"{path!r} holds a {md['component']} checkpoint, not a "
                         f"{component} one")
    bits = int(md["rung"]) if md["rung"] else None
    fused = md["fused_qkv"] == "1"
    keys = saved_keys(path)
    key_bits = 4 if "w_q4" in keys else (8 if "w_q" in keys else None)
    if key_bits != bits or ("img_qkv" in keys) != fused:
        raise ValueError(
            f"{path!r}: metadata says rung {md['rung']!r}, fused_qkv "
            f"{md['fused_qkv']!r}, but the saved keys hold rung {key_bits}, "
            f"fused q/k/v {'img_qkv' in keys}")
    return md["component"], bits, fused


def skeleton(component: str, preset, bits: Optional[int], fused: bool) -> Any:
    """The port's init of ``preset``'s ``component`` on the meta device, in
    the saved layout."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl
    from qwen_image_edit_streamdiffusion_tpu_torch.models import transformer as tfm
    from qwen_image_edit_streamdiffusion_tpu_torch.models import vae
    from qwen_image_edit_streamdiffusion_tpu_torch.models.optimize import fuse_qkv

    meta = torch.device("meta")
    if component == "transformer":
        p = tfm.init(None, preset.model, meta)
        if fused:
            fuse_qkv(p)
        return quantize.quantize_transformer(p, bits=bits) if bits else p
    if component == "vl":
        p = qwen_vl.init(None, preset.vl, meta)
        return quantize.quantize_vl(p, bits=bits) if bits else p
    return vae.init(None, preset.vae, meta)


def load(path: str, device="cuda", preset=None, component: Optional[str] = None,
         mapped: bool = False) -> Any:
    """The param tree saved at ``path``, read one tensor at a time straight
    onto ``device``. With ``preset``, its layout (:func:`layout`, which must
    be a ``component`` checkpoint when that is given) is held against the
    preset's init: a missing, unused or misshapen leaf raises. ``mapped``:
    a tree of host views of the mapped files, nothing read yet: a rank of a
    mesh copies its slices of them onto its device
    (``parallel/sharding.py::shard_module``)."""
    comp, bits, fused = layout(path, component)
    tree = unflatten(dict(cv.load_safetensors(path, torch.device(device), mapped)))
    if preset is not None:
        cv.check_total(tree, skeleton(comp, preset, bits, fused),
                       f"{comp} checkpoint {path!r} for preset {preset.name!r}")
    return tree


# ---------------------------------------------------------------------------
# Offline conversion
# ---------------------------------------------------------------------------


class _TransformerFinish:
    """Per completed MMDiT linear, in the JAX order: fuse its LoRA delta,
    hold q/k/v until all three of a stream have arrived and fuse them, then
    quantize."""

    def __init__(self, entries: Dict, fuse: bool, bits: Optional[int]):
        self.entries, self.fuse, self.bits = entries, fuse, bits
        self.done: Set[Tuple] = set()

    def __call__(self, tree: Any, module: Tuple) -> None:
        if module[0] != "blocks":
            return
        idx, rel = module[1], tuple(module[2:])
        block = tree["blocks"][idx]
        entry = self.entries.pop((idx, rel), None)
        if entry is not None:
            lora.fuse_entry(block, rel, entry, idx=idx)
        name = rel[-1]
        if self.fuse and name in lora.FUSED_SLOT:
            self.done.add(module)
            fused = lora.FUSED_SLOT[name][0]
            parts = [f"{fused[:3]}_{c}" for c in "qkv"]
            if all(module[:-1] + (p,) in self.done for p in parts):
                attn = block["attn"]
                attn[fused] = fuse_three(*(attn.pop(p) for p in parts))
                self._quantize(attn[fused], fused)
            return
        self._quantize(cv.node_at(tree, module), name)

    def _quantize(self, leaf: dict, name: str) -> None:
        if self.bits and name in quantize.DEFAULT_QUANTIZE:
            quantize.quantize_leaf(leaf, self.bits)


def _vl_finish(bits: int):
    def finish(tree: Any, module: Tuple) -> None:
        leaf = cv.node_at(tree, module)
        w = leaf.get("weight") if isinstance(leaf, dict) else None
        if module[-1] in quantize.VL_QUANTIZE and w is not None and w.dim() == 2:
            quantize.quantize_leaf(leaf, bits)
    return finish


def convert(src: str, component: str, preset, device="cuda",
            lora_path: Optional[str] = None, fuse_qkv: bool = False,
            bits: Optional[int] = None) -> Any:
    """The port's tree of ``component`` from the HF checkpoint at ``src``
    (a file, an index json's shards or a directory of shards), read shard by
    shard onto ``device``, with the LoRA at ``lora_path`` fused, q/k/v fused
    and the linears quantized to ``bits`` as each arrives."""
    items = cv.load_safetensors(src, torch.device(device))
    if component == "transformer":
        entries = {}
        if lora_path:
            entries = lora.parse_lora_state_dict(lora.load_lora_weights(lora_path))
            beyond = sorted(i for i, _ in entries if i >= preset.model.num_layers)
            if beyond:
                raise ValueError(f"LoRA targets block {beyond[0]} but model has "
                                 f"{preset.model.num_layers}")
        finish = _TransformerFinish(entries, fuse_qkv, bits)
        params = cv.convert_transformer(items, preset.model, on_module=finish)
        if finish.entries:
            raise ValueError(f"LoRA entries matched no linear: {sorted(finish.entries)[:4]}")
        return params
    if component == "vae":
        return cv.convert_vae(items, preset.vae)
    return cv.convert_vl(items, preset.vl, on_module=_vl_finish(bits) if bits else None)


# a tokenizer's files: tokenizer.json, or the slow set vocab.json + merges.txt
# with the added and special tokens beside them; the config goes with either
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "merges.txt",
                   "added_tokens.json", "special_tokens_map.json")


def find_tokenizer(src: str) -> Optional[str]:
    """The directory of the VL checkpoint's tokenizer (``tokenizer.json``, or
    ``vocab.json`` + ``merges.txt``): the one ``src`` names (or holds
    ``src``), else its sibling ``tokenizer/`` (the diffusers layout); None
    where neither has one. The files are read, so a tokenizer the port cannot
    tokenize with raises here, before any conversion."""
    from qwen_image_edit_streamdiffusion_tpu_torch.models.tokenizer import Tokenizer, files_in

    here = src if os.path.isdir(src) else os.path.dirname(os.path.abspath(src))
    for d in (here, os.path.join(os.path.dirname(os.path.abspath(here)), "tokenizer")):
        if files_in(d):
            Tokenizer.from_dir(d)
            return d
    return None


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog=f"python -m {__name__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("convert", help="HF safetensors → the port's checkpoint")
    c.add_argument("--src", required=True)
    c.add_argument("--component", required=True, choices=list(COMPONENTS))
    c.add_argument("--preset", default="qwen-image-edit-2509")
    c.add_argument("--out", required=True)
    c.add_argument("--lora", help="optional LoRA safetensors to fuse first "
                                  "(transformer only)")
    c.add_argument("--fuse-qkv", action="store_true",
                   help="fuse separate q/k/v into one qkv linear before saving "
                        "(transformer only): the serving config.fuse_qkv layout")
    c.add_argument("--quantize", choices=["int8", "int4"],
                   help="save weight-quantized leaves (transformer or vl): the "
                        "deployment loads them directly, with no boot-time "
                        "quantize pass. Order: LoRA fuse -> qkv fuse -> quantize "
                        "(as EditPipeline.create)")
    c.add_argument("--device", default="cuda",
                   help="torch device the conversion runs on (cuda, cuda:N or cpu)")
    args = ap.parse_args(argv)

    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset

    preset = get_preset(args.preset)
    if args.fuse_qkv and args.component != "transformer":
        ap.error("--fuse-qkv applies to --component transformer only")
    if args.quantize and args.component == "vae":
        ap.error("--quantize applies to transformer/vl (the VAE is ~100 MB "
                 "and stays high-precision)")
    if args.lora and args.component != "transformer":
        ap.error("--lora applies to --component transformer only")
    tok_dir = find_tokenizer(args.src) if args.component == "vl" else None
    params = convert(args.src, args.component, preset, args.device, args.lora,
                     args.fuse_qkv, {"int8": 8, "int4": 4}.get(args.quantize))
    save(args.out, params, {"component": args.component, "preset": preset.name})
    print(f"saved {args.component} → {args.out}")
    if tok_dir:
        for name in TOKENIZER_FILES:
            if os.path.isfile(os.path.join(tok_dir, name)):
                shutil.copyfile(os.path.join(tok_dir, name), os.path.join(args.out, name))
        print(f"copied the tokenizer of {tok_dir} → {args.out}")
    elif args.component == "vl":
        print(f"no tokenizer.json or vocab.json + merges.txt beside {args.src}: prompts "
              f"will get SimpleTokenizer's hashed ids")


if __name__ == "__main__":
    main()
