"""The port's command-line tools on the CPU: ``tools.generate`` over a small-width
pipeline (PNG, or ``.npy`` without PIL), ``tools.golden`` (fixtures created, then
matched or not, and the offline skip), ``tools.selfcheck`` (refuses the CPU,
skips the shapes the kernels do not take) and ``tools.serve.main`` (the int8 flags
taken, the card by default)."""

import sys
import urllib.request

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import pipeline as tpipe
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.tools import generate, golden, selfcheck, serve
from torch_port_utils import UNET, VAE_DEC, VAE_ENC, one_torch_thread, write_merges  # noqa: F401


@pytest.fixture(scope="module")
def small_factory():
    """A ``StableDiffusion`` stand-in that takes the tools' arguments, ignores the
    checkpoint paths and holds small random modules, on the CPU."""
    modules = dict(
        _unet=tunet.fuse_attention_projections(tunet.init("cpu", seed=0, **UNET)).eval(),
        _decoder=tvae.init_decoder("cpu", seed=2, dec_widths=VAE_DEC).eval(),
        _encoder=tvae.init_encoder("cpu", seed=4, enc_widths=VAE_ENC).eval(),
        _text_model=tclip.init("cpu", seed=1).eval(),
    )

    real = tpipe.StableDiffusion

    def make(**kw):
        for key in ("unet_ckpt", "text_encoder_ckpt", "vae_ckpt"):
            kw.pop(key, None)
        pipe = real(**kw)
        for name, module in modules.items():
            setattr(pipe, name, module)
        return pipe

    return make


@pytest.fixture(scope="module")
def bpe_path(tmp_path_factory):
    return write_merges(tmp_path_factory.mktemp("bpe") / "merges.txt.gz")


@pytest.mark.parametrize("pil", [True, False])
def test_generate_cli_writes_images(small_factory, bpe_path, tmp_path, monkeypatch, pil):
    monkeypatch.setattr(tpipe, "StableDiffusion", small_factory)
    if not pil:
        monkeypatch.setitem(sys.modules, "PIL", None)
    generate.main(["--prompt", "hello world", "--steps", "2", "--size", "64", "--batch", "2",
                   "--seed", "3", "--bpe", bpe_path, "--device", "cpu",
                   "--out", str(tmp_path / "out.png")])
    names = sorted(p.name for p in tmp_path.iterdir())
    if pil:
        from PIL import Image

        assert names == ["out-0.png", "out-1.png"]
        images = [np.asarray(Image.open(tmp_path / n)) for n in names]
    else:
        assert names == ["out-0.npy", "out-1.npy"]
        images = [np.load(tmp_path / n) for n in names]
    assert all(i.shape == (64, 64, 3) and i.dtype == np.uint8 for i in images)
    assert not np.array_equal(images[0], images[1])


def test_cli_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--prompt", "hello world"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--port", "0"])


def test_golden_creates_then_gates_fixtures(small_factory, bpe_path, tmp_path, monkeypatch,
                                            capsys):
    monkeypatch.setattr(tpipe, "StableDiffusion", small_factory)
    monkeypatch.setattr(golden, "SIZE", 64)
    monkeypatch.setattr(golden, "STEPS", 2)
    ckpt = tmp_path / "weights.safetensors"
    ckpt.write_bytes(b"")  # resolved as a path; the factory ignores it
    fixtures = str(tmp_path / "fixtures")
    args = (str(ckpt), str(ckpt), str(ckpt), bpe_path, fixtures)
    assert golden.run(*args, device="cpu") == 0
    assert "fixtures created" in capsys.readouterr().out
    latent_path = tmp_path / "fixtures" / f"golden_{golden.SEED}_latent.npy"
    image = np.load(tmp_path / "fixtures" / f"golden_{golden.SEED}_image.npy")
    assert image.shape == (64, 64, 3) and image.dtype == np.uint8
    assert golden.run(*args, device="cpu") == 0
    assert "OK" in capsys.readouterr().out
    np.save(latent_path, np.load(latent_path) + 1.0)  # MSE 1 > the 1e-2 gate
    assert golden.run(*args, device="cpu") == 1
    assert "MISMATCH" in capsys.readouterr().out


def test_golden_harness_offline_skip(tmp_path, monkeypatch, capsys):
    """Weights that cannot be fetched without a network: skipped, rc 2."""
    def no_network(*args, **kwargs):
        raise OSError("no network")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setenv("MINSDTF_CACHE", str(tmp_path / "cache"))
    rc = golden.run("default", "default", "default", "default", str(tmp_path))
    assert rc == 2
    assert "SKIP" in capsys.readouterr().out
    assert golden.run(str(tmp_path / "missing.safetensors"), "x", "x", "x", str(tmp_path)) == 2


def test_selfcheck_refuses_the_cpu_and_skips_untaken_shapes():
    with pytest.raises(ValueError, match="CUDA device"):
        selfcheck.check_flash_attention(device="cpu")
    cases = selfcheck.kernel_cases()
    assert cases == [("onepass", (2, 4096, 8, 40)), ("online", (2, 4096, 8, 40)),
                     ("onepass", (2, 1024, 8, 80)), ("online", (2, 1024, 8, 80))]
    assert selfcheck.kernel_cases([(2, 256, 8, 160)]) == []  # kv < 512: the plain path
    assert selfcheck.kernel_cases([(1, 4096, 1, 512)]) == [("online", (1, 4096, 1, 512))]


@pytest.mark.parametrize("flags", [["--int8"], ["--int8-hybrid", "scales.npz"]])
def test_serve_refuses_int8(flags, monkeypatch):
    """The int8 flags are ported: ``main`` no longer refuses them and builds its
    pipeline with them (``tests/test_torch_serve.py`` checks the settings the
    pipeline gets)."""
    built = []

    class Stop(Exception):
        pass

    def factory(**kw):
        built.append(kw)
        raise Stop

    monkeypatch.setattr(tpipe, "StableDiffusion", factory)
    with pytest.raises(Stop):
        serve.main(flags + ["--device", "cpu"])
    assert built and built[0]["weight_dtype"] in ("int8", "int8_hybrid")
