"""qwen_image_edit_streamdiffusion_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX reference ``qwen_image_edit_streamdiffusion_tpu``,
with the same layout so each module has a findable counterpart:

- ``core/``     — torch generators per named stream, the jax- and PIL-free
                  image geometry and resize, and the JPEG/PNG codec of the
                  wire (``codec.py`` over ``csrc/host/image_codec.cc``).
- ``ops/``      — RoPE, attention dispatch, and the wrappers of the
                  hand-written Hopper kernels in ``csrc/`` (joint and causal
                  flash attention, the small-channel 3×3 conv).
- ``models/``   — MMDiT transformer, VAE, Qwen2.5-VL encoder, scheduler, and
                  ``convert.from_jax`` (JAX param trees → the port's params).
- ``pipeline/`` — ``EditPipeline`` (edits) and ``RealtimePipeline`` (the stream).
- ``runtime/``  — builds ``csrc/`` with nvcc at first use and counts launches;
                  ``engine.py``, the inference engine behind the server.
- ``serving/``  — the HTTP ``/edit`` server, the websocket ``/stream`` and the
                  browser UI page, the JAX package's wire.

The port imports torch and never jax, nor anything of the JAX package: it
keeps its own copies of the reference's dependency-free modules
(``core/config.py``, ``models/text_encoder.py``, ``pipeline/cache.py``).
"""

__version__ = "0.1.0"
