"""Training data: datasets of files → geometry-bucketed, prefetched batches.

Counterpart of ``qwen_image_edit_streamdiffusion_tpu/training/data.py``, the
loader that the LoRA and distillation trainers consume:

- **Geometry buckets.** Items are grouped by their resolved geometry (the
  pipeline's own ``_prepare_images``: output size × condition count), so
  every batch has one shape; a bucket's partial tail rolls over to the next
  epoch.
- **Host work overlaps the step.** A producer thread reads and decodes the
  files and builds each batch (``lora_train.build_batch``: the VL prompt
  encode and the VAE encodes) while the consumer trains. On a card, that
  thread queues its device work on the same default stream as the step, so
  device order is kept and the host's work (file reads, JPEG/PNG decode,
  tokenizing, launches) is what overlaps. The queue is bounded; an exception
  in the producer is raised in the consumer; closing the iterator stops the
  producer, drains the queue and joins the thread.
- **Under a mesh** (a pipeline built with ``mesh=``) every rank reads the
  same files in the same order and builds the same batch through its own
  sharded encoders, whose collectives must not interleave with the train
  step's: the producer thread then reads and decodes the files only, and
  the consumer builds each batch before it yields it. World rank 0 writes
  the state file (``lora_train.save_train_state``).
- **Determinism.** Each epoch's order is ``np.random.RandomState((seed ·
  1_000_003 + epoch) mod 2³¹).permutation``, the JAX package's generator, so
  both packages visit the items in the same order. :func:`train_loop`
  resumed at step k continues the batch sequence at batch k (the JAX loop
  starts it again from the first batch), so a resumed run trains on what an
  unbroken run would have.

Images are read with ``core/codec.py::decode`` (EXIF-transposed RGB (H, W, 3)
uint8, the serving input convention), not PIL. Two sources:

- a JSONL manifest, one item per line::

    {"image": "in.jpg" | ["a.jpg", "b.jpg"], "target": "out.jpg",
     "prompt": "...", "negative_prompt": "..." (optional)}

  (paths relative to the manifest's directory), or
- a directory of item directories, each with input.(png|jpg), target.(png|jpg),
  prompt.txt and an optional negative.txt.

``.webp`` and ``.bmp`` files are found as in the JAX package and decoded as
Pillow decodes them; a file the codec cannot decode raises a ``ValueError``
that names the format and the feature.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")


def _find(dirpath: str, stem: str) -> Optional[str]:
    for ext in _IMG_EXTS:
        p = os.path.join(dirpath, stem + ext)
        if os.path.isfile(p):
            return p
    return None


def _read_text(path: str) -> str:
    with open(path) as f:
        return f.read().strip()


def read_image(path: str) -> np.ndarray:
    """An image file of any format ``codec.decode`` reads (JPEG, PNG, BMP,
    GIF, WebP, TIFF) → (H, W, 3) uint8 RGB, EXIF orientation applied."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import codec

    with open(path, "rb") as f:
        return codec.decode(f.read())


class EditDataset:
    """Lazy (condition image(s), prompt, target image) items."""

    def __init__(self, items: Sequence[Dict[str, Any]], root: str = ""):
        if not items:
            raise ValueError("empty dataset")
        self.items = list(items)
        self.root = root

    @classmethod
    def from_manifest(cls, path: str) -> "EditDataset":
        root = os.path.dirname(os.path.abspath(path))
        items = []
        with open(path) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    it = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{path}:{line_no}: invalid JSON: {e}") from e
                for k in ("image", "target", "prompt"):
                    if k not in it:
                        raise ValueError(f"{path}:{line_no}: missing key {k!r}")
                items.append(it)
        return cls(items, root=root)

    @classmethod
    def from_directory(cls, path: str) -> "EditDataset":
        items = []
        for name in sorted(os.listdir(path)):
            d = os.path.join(path, name)
            if not os.path.isdir(d):
                continue
            inp, tgt = _find(d, "input"), _find(d, "target")
            prompt = os.path.join(d, "prompt.txt")
            if not (inp and tgt and os.path.isfile(prompt)):
                continue
            it = {"image": inp, "target": tgt, "prompt": _read_text(prompt)}
            neg = os.path.join(d, "negative.txt")
            if os.path.isfile(neg):
                it["negative_prompt"] = _read_text(neg)
            items.append(it)
        return cls(items, root="")

    def __len__(self) -> int:
        return len(self.items)

    def load(self, idx: int) -> Dict[str, Any]:
        """Item ``idx`` with its paths read into uint8 arrays (an array in an
        in-memory dataset is kept as it is)."""
        it = dict(self.items[idx])

        def load_img(p):
            if not isinstance(p, str):
                return p
            return read_image(os.path.join(self.root, p))

        image = it["image"]
        it["image"] = ([load_img(p) for p in image] if isinstance(image, list)
                       else load_img(image))
        it["target"] = load_img(it["target"])
        return it


class BatchLoader:
    """Geometry-bucketed batch iterator, prefetched on a thread.

    Yields ``build_batch`` dicts of exactly ``batch_size`` rows whose items
    share one geometry bucket (output size × condition count). Partial
    bucket tails roll over to the next epoch."""

    def __init__(self, pipe, dataset: EditDataset, batch_size: int,
                 seed: int = 0, prefetch: int = 2,
                 height: Optional[int] = None, width: Optional[int] = None):
        self.pipe = pipe
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.seed = seed
        self.prefetch = max(1, int(prefetch))
        self.height, self.width = height, width
        self._geom_cache: Dict[int, tuple] = {}

    def _geometry(self, idx: int, item: Dict[str, Any]) -> tuple:
        """Bucket key (out_h, out_w, condition count) through the pipeline's
        own sizing rules."""
        if idx not in self._geom_cache:
            image = item["image"]
            images = [image] if isinstance(image, np.ndarray) else list(image)
            out_h, out_w, _, _ = self.pipe._prepare_images(
                images, self.height, self.width)
            self._geom_cache[idx] = (out_h, out_w, len(images))
        return self._geom_cache[idx]

    def _epoch_batches(self, epoch: int,
                       carry: Dict[tuple, List[Any]]) -> Iterator[List[Any]]:
        order = np.random.RandomState(
            (self.seed * 1_000_003 + epoch) % (2 ** 31)
        ).permutation(len(self.dataset))
        for idx in order:
            item = self.dataset.load(int(idx))
            key = self._geometry(int(idx), item)
            bucket = carry.setdefault(key, [])
            bucket.append(item)
            if len(bucket) == self.batch_size:
                yield carry.pop(key)

    def _on_consumer(self) -> bool:
        """Batches are built on the consumer's thread: the pipeline's
        encoders are sharded over several ranks, whose collectives follow
        the train step's in one order on every rank."""
        mesh = getattr(self.pipe, "mesh", None)
        return mesh is not None and mesh.size > 1

    def _build(self, items: List[Any]) -> Dict[str, Any]:
        from qwen_image_edit_streamdiffusion_tpu_torch.training.lora_train import (
            build_batch,
        )

        return build_batch(self.pipe, items, height=self.height, width=self.width)

    def _produce(self, steps: int, start: int, q: "queue.Queue",
                 stop: threading.Event):
        """The producer thread: ``steps`` built batches (their loaded items,
        where :meth:`_on_consumer`) after skipping ``start`` (not built),
        then None; an exception instead when one is raised. Every put gives
        up once the consumer has stopped."""
        on_consumer = self._on_consumer()

        def put(obj) -> bool:
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.05)
                    return True
                except queue.Full:
                    pass
            return False

        try:
            produced, skipped, epoch = 0, 0, 0
            carry: Dict[tuple, List[Any]] = {}
            while produced < steps and not stop.is_set():
                got = False
                for items in self._epoch_batches(epoch, carry):
                    got = True
                    if skipped < start:
                        skipped += 1
                        continue
                    if not put(items if on_consumer else self._build(items)):
                        return
                    produced += 1
                    if produced >= steps or stop.is_set():
                        break
                epoch += 1
                if not got and not carry:
                    raise ValueError("dataset yields no batches")
                if not got and carry and epoch > 2 * self.batch_size:
                    raise ValueError(
                        f"buckets {list(carry)} never fill batch_size="
                        f"{self.batch_size}: reduce the batch size or unify "
                        "image geometries")
            put(None)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)

    def batches(self, steps: int, start: int = 0) -> Iterator[Dict[str, Any]]:
        """``steps`` built batches, from batch ``start`` of the sequence on,
        prefetched by a background thread."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(steps, start, q, stop),
                             name="BatchLoader", daemon=True)
        t.start()
        try:
            while True:
                got = q.get()
                if got is None:
                    return
                if isinstance(got, BaseException):
                    raise got
                yield self._build(got) if isinstance(got, list) else got
        finally:
            stop.set()
            try:  # drain, so nothing the producer queued stays referenced
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join()


def train_loop(trainer, loader: BatchLoader, steps: int, log_every: int = 10,
               state_path: Optional[str] = None, save_every: int = 100,
               resume: bool = True) -> List[float]:
    """Drive the trainer to ``steps`` optimizer steps with periodic
    train-state files (``lora_train.save_train_state``: one ``torch.save``
    file); a rerun of the same call resumes from the file where it stopped,
    on the batch it would have taken next. Returns the losses of the steps
    run."""
    from qwen_image_edit_streamdiffusion_tpu_torch.training.lora_train import (
        restore_train_state,
        save_train_state,
    )

    if state_path and resume and os.path.isfile(state_path):
        restore_train_state(state_path, trainer)
        print(f"resumed from {state_path} at step {trainer.steps}", flush=True)
    remaining = steps - trainer.steps
    losses: List[float] = []
    if remaining <= 0:
        print(f"already at step {trainer.steps} >= {steps}; nothing to do")
        return losses
    for batch in loader.batches(remaining, start=trainer.steps):
        loss = trainer.step(batch)
        losses.append(loss)
        if trainer.steps % log_every == 0:
            print(f"step {trainer.steps:5d}  loss {loss:.5f}", flush=True)
        if state_path and save_every and trainer.steps % save_every == 0:
            save_train_state(state_path, trainer)
    if state_path:
        save_train_state(state_path, trainer)
    return losses
