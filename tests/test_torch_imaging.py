"""The port's resize against Pillow, and its image preparation against the
JAX package's.

The JAX package resizes with Pillow (LANCZOS for the VAE condition images,
the train target and the VL image; BICUBIC inside the VL encoder's
smart-resize). The port computes the same resampling in torch without PIL;
these tests hold it to Pillow's bytes exactly. They import PIL; the port
does not.
"""

import types

import numpy as np
import pytest
from PIL import Image

from qwen_image_edit_streamdiffusion_tpu.core import imaging as jimaging
from qwen_image_edit_streamdiffusion_tpu.core.config import StreamConfig as JStreamConfig
from qwen_image_edit_streamdiffusion_tpu.core.config import get_preset
from qwen_image_edit_streamdiffusion_tpu.models import qwen_vl as jvl
from qwen_image_edit_streamdiffusion_tpu.pipeline import edit_pipeline as jep
from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
from qwen_image_edit_streamdiffusion_tpu_torch.core.config import get_preset as port_preset
from qwen_image_edit_streamdiffusion_tpu_torch.models import qwen_vl as vl
from qwen_image_edit_streamdiffusion_tpu_torch.pipeline import edit_pipeline as tep

_PIL = {"lanczos": Image.LANCZOS, "bicubic": Image.BICUBIC}


def _noise(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)


def _circle(h, w, seed=1):
    """The JAX package's gradient-and-circle fixture with noise on top, so
    sharp edges and every code level meet the filters' negative lobes."""
    base = np.asarray(jimaging.make_test_image(w, h, "circle"), np.int32)
    noise = np.random.default_rng(seed).integers(-24, 25, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


# (filter, (H, W) in, (H, W) out): the flagship's VL image (1024² → 384²), a
# 4:3 VL image, an upscale to a VAE size, the VL smart-resize 384² → 392²,
# and a BICUBIC downscale
CASES = [("lanczos", (1024, 1024), (384, 384)),
         ("lanczos", (768, 1024), (320, 448)),
         ("lanczos", (200, 300), (864, 1184)),
         ("bicubic", (384, 384), (392, 392)),
         ("bicubic", (384, 384), (224, 224))]


@pytest.mark.parametrize("make", [_noise, _circle], ids=["noise", "circle"])
@pytest.mark.parametrize("filt,src,dst", CASES)
def test_resize_equals_pillow(filt, src, dst, make):
    img = make(*src)
    got = imaging.resize(img, dst[1], dst[0], filt)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), _PIL[filt]))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filt", ["lanczos", "bicubic"])
def test_resize_one_axis_and_no_op(filt):
    """A pass whose size does not change is skipped, as in Pillow, and an
    image already at its size comes back as it is."""
    img = _noise(90, 70, 3)
    for w, h in ((70, 41), (133, 90)):
        want = np.asarray(Image.fromarray(img).resize((w, h), _PIL[filt]))
        np.testing.assert_array_equal(imaging.resize(img, w, h, filt), want)
    assert imaging.resize(img, 70, 90, filt) is img
    with pytest.raises(ValueError, match="filter"):
        imaging.resize(img, 10, 10, "nearest")


def test_prepare_images_matches_jax():
    """The edit's image preparation on a 4:3 input at no target size: the
    VAE image (area 1024², LANCZOS) and the VL image (area 384², LANCZOS)
    and the output size equal the JAX package's exactly."""
    img = _circle(600, 800, 5)
    jself = types.SimpleNamespace(config=JStreamConfig())
    want = jep.EditPipeline._prepare_images(jself, [Image.fromarray(img)], None, None)
    tself = types.SimpleNamespace(config=StreamConfig(), device="cpu")
    got = tep.EditPipeline._prepare_images(tself, [img], None, None)
    assert got[:2] == want[:2]
    for g, w in zip(got[2] + got[3], want[2] + want[3]):
        assert g.shape != img.shape
        np.testing.assert_array_equal(g, np.asarray(w))


def test_resize_for_vl_matches_jax():
    """The VL encoder's smart-resize (BICUBIC) on an image off its grid."""
    img = _noise(384, 384, 7)
    want = jvl.resize_for_vl(img, get_preset("qwen-image-edit-2509").vl)
    got = vl.resize_for_vl(img, port_preset("qwen-image-edit-2509").vl)
    assert got[1:] == want[1:] and got[0].shape == (392, 392, 3)
    np.testing.assert_array_equal(got[0], want[0])
