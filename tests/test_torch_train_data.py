"""The port's training data path (``training/data.py``) against the JAX
package's: the manifest and directory sources, the named manifest errors,
the pixels of a loaded item (JPEG, PNG, EXIF-rotated, two condition images),
the batch order of the geometry buckets with their tails rolling over, the
prefetching thread (batches of one geometry, errors raised in the consumer,
the thread joined on close) and ``train_loop``'s train-state file and resume.

The JAX side runs without a JAX pipeline: its ``BatchLoader`` only reads the
pipeline's ``_prepare_images``, bound here to a stand-in with the same
config."""

import functools
import json
import os
import threading
import types

import numpy as np
import pytest
import torch
from PIL import Image

from qwen_image_edit_streamdiffusion_tpu.core import config as jconfig
from qwen_image_edit_streamdiffusion_tpu.pipeline import edit_pipeline as jep
from qwen_image_edit_streamdiffusion_tpu.training import data as jdata
from qwen_image_edit_streamdiffusion_tpu_torch.core import codec, imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep
from qwen_image_edit_streamdiffusion_tpu_torch.training import data
from qwen_image_edit_streamdiffusion_tpu_torch.training import lora_train as lt

torch.set_num_threads(2)

AREA = dict(vae_image_area=64 * 64, vl_image_area=64 * 64)
SQUARE, WIDE = (64, 64), (48, 96)  # (h, w): two geometry buckets at AREA
BATCH = 2


def _image(i, hw):
    rng = np.random.default_rng(i)
    img = imaging.make_test_image(hw[1], hw[0], ("gradient", "circle", "sine")[i % 3])
    return np.clip(img.astype(np.int32) + rng.integers(0, 64, (3,)), 0, 255
                   ).astype(np.uint8)


def _items():
    """Five square items, three wide, one with two condition images; JPEG
    and PNG files; one JPEG rotated by its EXIF orientation; negatives on
    some."""
    out = []
    for i in range(9):
        hw = SQUARE if i < 5 else WIDE
        it = {"prompt": f"edit number {i}", "src": _image(i, hw),
              "tgt": _image(100 + i, hw), "ext": (".png", ".jpg")[i % 2]}
        if i % 3 == 0:
            it["negative_prompt"] = f"not {i}"
        out.append(it)
    out[8]["two"] = _image(200, SQUARE)
    return out


def _write(path, arr, exif_orientation=None):
    if path.endswith(".png"):
        imaging.write_png(path, arr)
    elif exif_orientation:
        exif = Image.Exif()
        exif[0x0112] = exif_orientation
        Image.fromarray(arr).save(path, quality=90, exif=exif)
    else:
        with open(path, "wb") as f:
            f.write(codec.encode_jpeg(arr, 90))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The items written twice: a manifest with relative paths, and one
    directory per item. Returns (manifest path, directory root)."""
    root = str(tmp_path_factory.mktemp("data"))
    os.makedirs(os.path.join(root, "imgs"))
    lines = []
    for i, it in enumerate(_items()):
        d = os.path.join(root, "items", f"item{i:02d}")
        os.makedirs(d)
        src, tgt = f"imgs/in{i}{it['ext']}", f"imgs/out{i}.png"
        rot = 6 if i == 3 else None
        for p in (os.path.join(root, src), os.path.join(d, "input" + it["ext"])):
            _write(p, it["src"], rot)
        for p in (os.path.join(root, tgt), os.path.join(d, "target.png")):
            _write(p, it["tgt"])
        line = {"image": src, "target": tgt, "prompt": it["prompt"]}
        with open(os.path.join(d, "prompt.txt"), "w") as f:
            f.write(it["prompt"] + "\n")
        if "negative_prompt" in it:
            line["negative_prompt"] = it["negative_prompt"]
            with open(os.path.join(d, "negative.txt"), "w") as f:
                f.write(it["negative_prompt"])
        if "two" in it:
            _write(os.path.join(root, "imgs/two.png"), it["two"])
            line["image"] = [src, "imgs/two.png"]
        lines.append(json.dumps(line))
    os.makedirs(os.path.join(root, "items", "incomplete"))  # no prompt: skipped
    manifest = os.path.join(root, "train.jsonl")
    with open(manifest, "w") as f:
        f.write("\n".join(lines[:4]) + "\n\n" + "\n".join(lines[4:]) + "\n")
    return manifest, os.path.join(root, "items")


@pytest.fixture(scope="module")
def pipe():
    config = StreamConfig(num_inference_steps=2, model_preset="tiny", **AREA)
    return tep.EditPipeline.create("tiny", config, seed=0, device="cpu")


def _jax_loader(manifest, seed):
    stub = types.SimpleNamespace(config=jconfig.StreamConfig(model_preset="tiny", **AREA))
    stub._prepare_images = functools.partial(jep.EditPipeline._prepare_images, stub)
    return jdata.BatchLoader(stub, jdata.EditDataset.from_manifest(manifest), BATCH,
                             seed=seed)


def _arrays(x):
    return [np.asarray(i) for i in x] if isinstance(x, list) else np.asarray(x)


def test_loaded_pixels_equal_jax(files):
    """Every item's condition image(s) and target as the JAX
    ``EditDataset.load`` gives them (Pillow, EXIF-transposed), byte for
    byte; the other keys as they are."""
    manifest, _ = files
    ours, theirs = data.EditDataset.from_manifest(manifest), \
        jdata.EditDataset.from_manifest(manifest)
    assert len(ours) == len(theirs) == 9
    for i in range(9):
        a, b = ours.load(i), theirs.load(i)
        assert sorted(a) == sorted(b)
        for k in a:
            if k in ("image", "target"):
                got, want = a[k], _arrays(b[k])
                if isinstance(want, list):
                    assert len(got) == len(want) == 2
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w)
                else:
                    np.testing.assert_array_equal(got, want)
            else:
                assert a[k] == b[k]
    assert ours.load(3)["image"].shape == (64, 64, 3)


def test_webp_and_bmp_items_load_as_jax_loads_them(tmp_path):
    """A directory source whose items are ``.webp`` (lossy, lossless with
    alpha, EXIF-rotated) and ``.bmp`` (24-bit, 8-bit palette, RLE8) files,
    found and read as the JAX ``EditDataset`` finds and reads them."""
    import io
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    from codec_fixtures import bmp_file

    rng = np.random.default_rng(7)
    src = _image(4, WIDE)
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, WIDE)
    idx[:, :30] = 5  # runs for RLE8

    def webp(arr, **kw):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "WEBP", **kw)
        return buf.getvalue()

    exif = Image.Exif()
    exif[0x0112] = 6
    rgba = np.concatenate([src, rng.integers(0, 256, WIDE + (1,), np.uint8)], -1)
    files = [("input.webp", webp(src, quality=80)), ("target.bmp", bmp_file(src, 24)),
             ("input.bmp", bmp_file(idx, 8, palette=pal)),
             ("target.webp", webp(rgba, lossless=True)),
             ("input.webp", webp(src, quality=95, exif=exif)),
             ("target.bmp", bmp_file(idx, 8, palette=pal, compression=1))]
    for i in range(3):
        d = tmp_path / f"item{i}"
        d.mkdir()
        for name, blob in files[2 * i:2 * i + 2]:
            (d / name).write_bytes(blob)
        (d / "prompt.txt").write_text(f"item {i}")
    ours, theirs = (data.EditDataset.from_directory(str(tmp_path)),
                    jdata.EditDataset.from_directory(str(tmp_path)))
    assert len(ours) == len(theirs) == 3
    for i in range(3):
        a, b = ours.load(i), theirs.load(i)
        for k in ("image", "target"):
            np.testing.assert_array_equal(a[k], _arrays(b[k]))
    assert ours.load(2)["image"].shape == (WIDE[1], WIDE[0], 3)  # EXIF 6: rotated


def test_read_image_takes_progressive_and_interlaced_files(tmp_path):
    """``read_image`` of a progressive JPEG (EXIF-rotated), an Adam7 PNG and a
    16-bit PNG equals the JAX ``open_rgb`` array of the same file."""
    from qwen_image_edit_streamdiffusion_tpu.core.imaging import open_rgb
    from scripts.codec_fixtures import png_file

    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (37, 52, 3), np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    Image.fromarray(arr).save(tmp_path / "p.jpg", "JPEG", quality=90, progressive=True,
                              exif=exif.tobytes())
    (tmp_path / "a.png").write_bytes(png_file(arr, 2, interlace=True, seed=1))
    (tmp_path / "w.png").write_bytes(png_file(rng.integers(0, 1 << 16, (9, 11, 4)), 6, 16))
    for name in ("p.jpg", "a.png", "w.png"):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(data.read_image(path), np.asarray(open_rgb(path)))
    assert data.read_image(str(tmp_path / "p.jpg")).shape == (52, 37, 3)


def test_sources_agree(files):
    """The manifest and the item directories give the same prompts,
    negatives and pixels (the directories hold the one-image items, and
    the incomplete directory is skipped)."""
    manifest, root = files
    m, d = data.EditDataset.from_manifest(manifest), data.EditDataset.from_directory(root)
    assert len(d) == 9
    for i in range(8):
        a, b = m.load(i), d.load(i)
        assert a["prompt"] == b["prompt"]
        assert a.get("negative_prompt") == b.get("negative_prompt")
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["target"], b["target"])


def test_manifest_errors_name_the_line(tmp_path):
    good = json.dumps({"image": "a.png", "target": "b.png", "prompt": "p"})
    cases = {":3: invalid JSON": [good, "", "{not json"],
             ":2: missing key 'target'": [good, json.dumps({"image": "a", "prompt": "p"})],
             "empty dataset": ["", ""]}
    for want, lines in cases.items():
        path = str(tmp_path / "m.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match=want):
            data.EditDataset.from_manifest(path)


@pytest.mark.parametrize("seed", [0, 5])
def test_batch_order_equals_jax_and_tails_roll_over(files, pipe, seed):
    """Four epochs of ``_epoch_batches``: the same items in the same batches
    as the JAX ``BatchLoader`` on the same files; each batch one geometry;
    an odd bucket's tail carried into the next epoch's first batch of that
    bucket (the lone two-image item fills its bucket every other epoch)."""
    manifest, _ = files
    ours = data.BatchLoader(pipe, data.EditDataset.from_manifest(manifest), BATCH,
                            seed=seed)
    theirs = _jax_loader(manifest, seed)
    carry, jcarry = {}, {}
    for epoch in range(4):
        before = {k: [it["prompt"] for it in v] for k, v in carry.items()}
        got = [[it["prompt"] for it in b] for b in ours._epoch_batches(epoch, carry)]
        want = [[it["prompt"] for it in b] for b in theirs._epoch_batches(epoch, jcarry)]
        assert got == want and got
        assert {k: [it["prompt"] for it in v] for k, v in carry.items()} == \
            {k: [it["prompt"] for it in v] for k, v in jcarry.items()}
        for batch in got:
            keys = {ours._geometry(int(p.split()[-1]), None) for p in batch}
            assert len(batch) == BATCH and len(keys) == 1
        for key, tail in before.items():
            first = next((b for b in got
                          if ours._geometry(int(b[0].split()[-1]), None) == key), None)
            if key[2] == 1:
                assert first is not None and first[0] == tail[0]


def test_batches_prefetch_and_close(files, pipe):
    """``batches``: built batches of two rows and one geometry, negatives
    where an item has one, the batch sequence continued at ``start``; closing
    the iterator early joins the producer; an error in the producer (a
    corrupt ``.webp`` file, which the codec refuses by name) is raised in
    the consumer."""
    manifest, root = files
    loader = data.BatchLoader(pipe, data.EditDataset.from_manifest(manifest), BATCH,
                              seed=0, prefetch=1)
    order = [[it["prompt"] for it in b] for b in loader._epoch_batches(0, {})]
    gen = loader.batches(3)
    first = next(gen)
    assert first["x0_tokens"].shape[0] == BATCH
    assert len(first["img_shapes"]) == 2  # one target grid, one condition grid
    wants_neg = any(int(p.split()[-1]) % 3 == 0 for p in order[0])
    assert ("neg_txt" in first) == wants_neg
    gen.close()
    assert not any(t.name == "BatchLoader" for t in threading.enumerate())

    again = list(loader.batches(2, start=1))
    ref = lt.build_batch(pipe, [data.EditDataset.from_manifest(manifest).load(
        int(p.split()[-1])) for p in order[1]])
    for k in ("x0_tokens", "cond_tokens", "txt"):
        torch.testing.assert_close(again[0][k], ref[k], rtol=0, atol=0)
    assert len(again) == 2

    bad = os.path.join(os.path.dirname(root), "bad")
    os.makedirs(os.path.join(bad, "x"))
    with open(os.path.join(bad, "x", "input.webp"), "wb") as f:
        f.write(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
    imaging.write_png(os.path.join(bad, "x", "target.png"), _image(0, SQUARE))
    with open(os.path.join(bad, "x", "prompt.txt"), "w") as f:
        f.write("p")
    ds = data.EditDataset.from_directory(bad)
    assert ds.items[0]["image"].endswith(".webp")
    with pytest.raises(ValueError, match="(corrupt|truncated) WebP"):
        list(data.BatchLoader(pipe, ds, 1).batches(1))
    assert not any(t.name == "BatchLoader" for t in threading.enumerate())


def test_train_loop_saves_and_resumes(tmp_path, files, pipe, capsys):
    """``train_loop`` to step 2 with a state file, then a fresh trainer to
    step 3 resumes at step 2 (adapters, AdamW moments and generator
    restored exactly) and takes batch 3 of the sequence: its adapters equal
    an unbroken 3-step run's bit for bit. A rerun at the goal does nothing."""
    manifest, _ = files
    cfg = lt.TrainConfig(rank=2, alpha=2.0, remat=False, targets=("attn.to_q",))
    loader = lambda: data.BatchLoader(pipe, data.EditDataset.from_manifest(manifest),
                                      BATCH, seed=1)
    state = str(tmp_path / "state.pt")

    unbroken = lt.LoRATrainer.from_pipeline(pipe, cfg)
    assert len(data.train_loop(unbroken, loader(), 3)) == 3

    first = lt.LoRATrainer.from_pipeline(pipe, cfg)
    data.train_loop(first, loader(), 2, state_path=state, save_every=1)
    assert torch.load(state, weights_only=True)["step"] == 2
    second = lt.LoRATrainer.from_pipeline(pipe, cfg)
    capsys.readouterr()
    losses = data.train_loop(second, loader(), 3, log_every=1, state_path=state)
    out = capsys.readouterr().out
    assert f"resumed from {state} at step 2" in out and "step     3" in out
    assert len(losses) == 1 and second.steps == 3
    for a, b in zip(lt.lora_leaves(second.lora), lt.lora_leaves(unbroken.lora)):
        assert torch.equal(a, b)
    assert data.train_loop(lt.LoRATrainer.from_pipeline(pipe, cfg), loader(), 3,
                           state_path=state) == []
    assert "already at step 3" in capsys.readouterr().out
