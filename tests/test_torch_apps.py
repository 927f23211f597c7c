"""The port's demo apps (``minsdtf_tpu_torch/apps``): the cases of
``tests/test_apps.py`` over the port's apps.

streamlit and gradio are not installed, so the apps are driven against minimal
fakes put into sys.modules. The pipeline is faked too (no model is built); every
captured call is bound against the port's ``StableDiffusion`` method signature,
so these tests catch signature drift between the apps and the pipeline without
running any compute."""

from __future__ import annotations

import inspect
import sys
import types

import numpy as np
import pytest

from minsdtf_tpu_torch.pipeline import StableDiffusion


class FakePipe:
    """Records calls; validates kwargs against the real pipeline signatures."""

    def __init__(self):
        self.calls = []

    def _handle(self, method, args, kwargs):
        real = getattr(StableDiffusion, method)
        # raises TypeError if the app passes kwargs the real method doesn't accept
        inspect.signature(real).bind(self, *args, **kwargs)
        self.calls.append((method, kwargs))
        batch = int(kwargs.get("batch_size", 1))
        if kwargs.get("callback") is not None:
            for i in range(int(kwargs.get("num_steps", 1))):
                kwargs["callback"](i + 1)
        return np.zeros((batch, 64, 64, 3), np.uint8)

    def text_to_image(self, *a, **kw):
        return self._handle("text_to_image", a, kw)

    def image_to_image(self, *a, **kw):
        return self._handle("image_to_image", a, kw)

    def inpaint(self, *a, **kw):
        return self._handle("inpaint", a, kw)


@pytest.fixture
def fake_pipe(monkeypatch, tmp_path):
    from minsdtf_tpu_torch.apps import common

    pipe = FakePipe()
    monkeypatch.setattr(common, "build_pipeline", lambda *a, **kw: pipe)
    monkeypatch.setattr(common, "OUTPUT_DIR", str(tmp_path / "outputs"))
    return pipe


# ---- gradio fakes ------------------------------------------------------------------


class _GrComponent:
    def __init__(self, *a, **kw):
        self.kw = kw


class _GrInterface:
    last = None

    def __init__(self, fn=None, inputs=None, outputs=None, **kw):
        self.fn = fn
        self.inputs = inputs
        self.launched = False
        _GrInterface.last = self

    def launch(self, *a, **kw):
        self.launched = True


def _fake_gradio():
    gr = types.ModuleType("gradio")
    for name in ("Textbox", "Slider", "Number", "Image", "Gallery"):
        setattr(gr, name, _GrComponent)
    gr.Interface = _GrInterface
    return gr


@pytest.fixture
def gradio_stub(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio())
    yield
    _GrInterface.last = None


def test_gradio_text_to_image(fake_pipe, gradio_stub):
    from minsdtf_tpu_torch.apps import text_to_image

    text_to_image.main()
    demo = _GrInterface.last
    assert demo is not None and demo.launched
    # drive the wired fn with slider-typed values (floats/strings, like gradio sends)
    images = demo.fn("a cat", "", 4.0, 7.5, 0.7, 42.0, 2.0)
    assert len(images) == 2
    method, kw = fake_pipe.calls[-1]
    assert method == "text_to_image"
    assert kw["num_steps"] == 4 and kw["batch_size"] == 2 and kw["seed"] == 42
    assert kw["negative_prompt"] is None  # empty string -> None


def test_gradio_image_to_image(fake_pipe, gradio_stub):
    from minsdtf_tpu_torch.apps import image_to_image

    image_to_image.main()
    demo = _GrInterface.last
    ref = np.zeros((64, 64, 3), np.uint8)
    images = demo.fn(ref, "a dog", "bad", 8.0, 5.0, 0.0, 0.6, 7.0, 1.0)
    assert len(images) == 1
    method, kw = fake_pipe.calls[-1]
    assert method == "image_to_image"
    assert kw["reference_image_strength"] == 0.6
    assert kw["negative_prompt"] == "bad"


def test_gradio_inpaint(fake_pipe, gradio_stub):
    from minsdtf_tpu_torch.apps import inpaint

    inpaint.main()
    demo = _GrInterface.last
    ref = np.zeros((64, 64, 3), np.uint8)
    mask = np.zeros((64, 64), np.uint8)
    images = demo.fn(ref, mask, "sky", "", 6.0, 7.5, 0.7, 0.8, 5.0, 3.0)
    assert len(images) == 1
    method, kw = fake_pipe.calls[-1]
    assert method == "inpaint"
    assert kw["mask_blur_strength"] == 5 and kw["seed"] == 3


def test_save_outputs_png_and_sidecar(tmp_path):
    from minsdtf_tpu_torch.apps import common

    imgs = np.zeros((2, 8, 8, 3), np.uint8)
    paths = common.save_outputs(imgs, "my prompt", out_dir=str(tmp_path))
    assert len(paths) == 2
    for p in paths:
        assert p.endswith(".png")
        import os

        assert os.path.exists(p)
        assert open(p.replace(".png", ".txt")).read() == "my prompt"


def test_save_outputs_npy_without_pil(tmp_path, monkeypatch):
    from minsdtf_tpu_torch.apps import common

    monkeypatch.setitem(sys.modules, "PIL", None)
    imgs = np.arange(2 * 8 * 8 * 3, dtype=np.uint8).reshape(2, 8, 8, 3)
    paths = common.save_outputs(imgs, "my prompt", out_dir=str(tmp_path))
    assert [p.endswith(".npy") for p in paths] == [True, True]
    for p, img in zip(paths, imgs):
        assert np.array_equal(np.load(p), img)
        assert open(p.replace(".npy", ".txt")).read() == "my prompt"


def test_build_pipeline_reads_the_environment(monkeypatch):
    from minsdtf_tpu_torch.apps import common

    monkeypatch.setenv("MINSDTF_BPE", "merges.txt.gz")
    monkeypatch.setenv("MINSDTF_UNET", "unet.safetensors")
    pipe = common.build_pipeline(128, 64, device="cpu", scheduler_type="dpm")
    assert (pipe.img_height, pipe.img_width, pipe.device.type) == (128, 64, "cpu")
    assert pipe.bpe_path == "merges.txt.gz" and pipe.unet_ckpt == "unet.safetensors"
    assert pipe.scheduler_type == "dpm" and pipe.vae_ckpt is None


# ---- streamlit fakes ----------------------------------------------------------------


class _StContainer:
    """Stands in for st itself, tabs, and columns; returns the widget defaults so
    controls() yields the same config a fresh page would."""

    def __init__(self, state):
        self.state = state

    # widgets -> their default values
    def text_area(self, label, value=""):
        return value

    def select_slider(self, label, options=None, value=None):
        return value

    def selectbox(self, label, options=None, index=0):
        return options[index]

    def slider(self, label, lo, hi, value=None, step=None):
        return value if value is not None else lo

    def number_input(self, label, value=0):
        return value

    def file_uploader(self, label):
        return self.state.get("uploads", {}).get(label)

    def caption(self, text):
        pass

    def columns(self, n):
        return [_StContainer(self.state) for _ in range(n)]

    # page-level api
    def title(self, text):
        self.state.setdefault("titles", []).append(text)

    def tabs(self, names):
        return [_StContainer(self.state) for _ in names]

    def button(self, label, key=None):
        return key in self.state.get("pressed", set())

    def progress(self, v):
        bar = types.SimpleNamespace(values=[])
        bar.progress = bar.values.append
        self.state.setdefault("progress", []).append(bar)
        return bar

    def image(self, img):
        self.state.setdefault("images", []).append(np.asarray(img))

    def cache_resource(self, fn):
        return fn

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture
def streamlit_app(monkeypatch):
    state = {}
    st = _StContainer(state)
    mod = types.ModuleType("streamlit")
    for name in dir(_StContainer):
        if not name.startswith("_"):
            setattr(mod, name, getattr(st, name))
    monkeypatch.setitem(sys.modules, "streamlit", mod)
    sys.modules.pop("minsdtf_tpu_torch.apps.app", None)
    yield state
    sys.modules.pop("minsdtf_tpu_torch.apps.app", None)


def _import_app():
    # fresh import so the module binds THIS test's streamlit fake (a plain
    # from-import would reuse the package attribute from a previous test)
    import importlib

    return importlib.import_module("minsdtf_tpu_torch.apps.app")


def test_streamlit_txt2img_tab(fake_pipe, streamlit_app):
    streamlit_app["pressed"] = {"t2i"}
    app = _import_app()

    app.main()
    assert streamlit_app["titles"]
    method, kw = fake_pipe.calls[-1]
    assert method == "text_to_image"
    assert kw["num_steps"] == 25 and kw["batch_size"] == 1
    assert kw["unconditional_guidance_scale"] == 7.5 and kw["guidance_rescale"] == 0.7
    # progress callback drove the bar to completion
    assert streamlit_app["progress"][0].values[-1] == 1.0
    # images rendered
    assert len(streamlit_app["images"]) == 1


def test_streamlit_no_button_no_run(fake_pipe, streamlit_app):
    app = _import_app()

    app.main()
    assert fake_pipe.calls == []


def test_streamlit_app_imports_without_streamlit(monkeypatch):
    """The module imports where streamlit is not installed; only its page raises."""
    monkeypatch.setitem(sys.modules, "streamlit", None)
    sys.modules.pop("minsdtf_tpu_torch.apps.app", None)
    try:
        app = _import_app()
        assert app.st is None
        with pytest.raises(SystemExit, match="streamlit is not installed"):
            app.main()
    finally:
        sys.modules.pop("minsdtf_tpu_torch.apps.app", None)
