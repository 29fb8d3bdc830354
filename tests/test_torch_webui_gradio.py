"""The port's Gradio UI (``serving/webui.py::create_ui``) against a stub
``gradio``, as ``tests/test_webui_gradio.py`` drives the JAX package's: the
stub records every component and callback, the port's Blocks are held to
the JAX package's (the same components, arguments and wiring, the title's
accelerator name aside), and the callbacks run on a tiny CPU engine."""

import sys
import types

import numpy as np
import pytest

SIZE = 64


class _Recorder:
    def __init__(self):
        self.components = []  # (kind, args, kwargs)
        self.callbacks = []   # (component kind, event, fn, inputs, outputs)


def _fake_gradio(rec: _Recorder):
    class _Component:
        def __init__(self, *a, **k):
            self._index = len(rec.components)
            rec.components.append((type(self).__name__, a, k))

        def _register(self, event, fn, inputs, outputs):
            ids = lambda xs: None if xs is None else [  # noqa: E731
                x._index for x in (xs if isinstance(xs, list) else [xs])]
            rec.callbacks.append((type(self).__name__, event, fn, ids(inputs), ids(outputs)))
            return self

        def click(self, fn, inputs=None, outputs=None):
            return self._register("click", fn, inputs, outputs)

        def change(self, fn, inputs=None, outputs=None):
            return self._register("change", fn, inputs, outputs)

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Markdown", "Textbox", "Button", "Image",
                 "Slider", "Examples", "Tab"):
        setattr(gr, name, type(name, (_Component,), {}))
    return gr


def _build(monkeypatch, create_ui, engine=None):
    rec = _Recorder()
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio(rec))
    demo = create_ui(engine=engine)
    assert demo is not None
    return rec


def _tiny_engine():
    from qwen_image_edit_streamdiffusion_tpu_torch.core.config import StreamConfig
    from qwen_image_edit_streamdiffusion_tpu_torch.runtime.engine import InferenceEngine

    cfg = StreamConfig(width=SIZE, height=SIZE, vae_image_area=SIZE * SIZE,
                       vl_image_area=56 * 56, num_inference_steps=1,
                       model_preset="tiny", use_vl_encoder=False)
    eng = InferenceEngine.create("tiny", config=cfg, warmup_runs=0, device="cpu")
    eng.input_size = SIZE
    return eng


def _handlers(rec):
    return {fn.__name__: fn for _, _, fn, _, _ in rec.callbacks}


def test_create_ui_without_gradio_points_to_builtin(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.webui import create_ui

    with pytest.raises(ImportError, match="/ui"):
        create_ui()


def test_blocks_match_the_jax_ui(monkeypatch):
    """Every component with its arguments, in order, and every callback's
    event, function name and wiring equal the JAX ``create_ui``'s; only the
    accelerator in the title differs."""
    from qwen_image_edit_streamdiffusion_tpu.serving.webui import create_ui as jax_ui
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.webui import create_ui

    ours, theirs = _build(monkeypatch, create_ui), _build(monkeypatch, jax_ui)

    def value(v):
        if isinstance(v, str):
            return v.replace("(GPU)", "(ACC)").replace("(TPU)", "(ACC)")
        if isinstance(v, list):
            return [value(x) for x in v]
        return getattr(v, "_index", v)  # a component: its place in the order

    def norm(components):
        return [(kind, tuple(value(v) for v in a), {key: value(v) for key, v in k.items()})
                for kind, a, k in components]

    assert norm(ours.components) == norm(theirs.components)
    wiring = lambda rec: [(c, e, fn.__name__, i, o)  # noqa: E731
                          for c, e, fn, i, o in rec.callbacks]
    assert wiring(ours) == wiring(theirs)
    kinds = [c[0] for c in ours.components]
    assert kinds.count("Tab") == 3 and kinds.count("Slider") == 4
    steps = [k for kind, _, k in ours.components if kind == "Slider" and k.get("label") == "Steps"]
    assert [s["value"] for s in steps] == [4, 4, 4]


def test_callbacks_edit_on_a_cpu_engine(monkeypatch):
    """load_model, process (webcam change and upload click) and
    process_composite return edited images: each equals the engine's
    pipeline on the resized (or blended, then resized) input with the
    Gradio path's true CFG (negative " ", scale 4, seed 42)."""
    from qwen_image_edit_streamdiffusion_tpu_torch.core import imaging
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.webui import create_ui

    eng = _tiny_engine()
    rec = _build(monkeypatch, create_ui, eng)
    handlers = _handlers(rec)
    assert {"load_model", "process", "process_composite"} <= set(handlers)
    assert "loaded" in handlers["load_model"]()

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (80, 48, 3), dtype=np.uint8)
    other = rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8)

    def direct(arr):
        res = eng.pipeline(imaging.resize(arr, SIZE, SIZE), "stylize",
                           negative_prompt=" ", true_cfg_scale=4.0,
                           num_inference_steps=1, seed=42)
        return res.images[0]

    out, elapsed = handlers["process"](img, "stylize", 1)
    assert out.shape == (SIZE, SIZE, 3) and out.dtype == np.uint8
    assert elapsed.endswith("s")
    np.testing.assert_array_equal(out, direct(img))

    out2, _ = handlers["process_composite"](other, img, 0.25, "stylize", 1)
    np.testing.assert_array_equal(out2, direct(imaging.blend(other, img, 0.25)))


def test_process_before_load_asks_for_the_model(monkeypatch):
    from qwen_image_edit_streamdiffusion_tpu_torch.serving.webui import create_ui

    rec = _build(monkeypatch, create_ui)
    out, status = _handlers(rec)["process"](np.zeros((8, 8, 3), np.uint8), "x", 1)
    assert out is None and status == "Load the model first"


def test_composite_blends_as_pillow(monkeypatch):
    """The composite is Pillow's ``Image.blend`` of the two inputs (the JAX
    path's), the second resized to the first's size, on arrays."""
    from PIL import Image

    from qwen_image_edit_streamdiffusion_tpu_torch.serving import webui

    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    seen = {}

    class Pipe:
        def __call__(self, arr, *args, **kw):
            seen["arr"] = arr
            return types.SimpleNamespace(images=[arr], elapsed=0.0)

    eng = types.SimpleNamespace(pipeline=Pipe(), input_size=40)
    rec = _build(monkeypatch, webui.create_ui, eng)
    _handlers(rec)["process_composite"](a, b, 0.7, "p", 2)
    want = Image.blend(Image.fromarray(a), Image.fromarray(b).resize((56, 40), Image.LANCZOS),
                       0.7).resize((40, 40), Image.LANCZOS)
    np.testing.assert_array_equal(seen["arr"], np.asarray(want))
