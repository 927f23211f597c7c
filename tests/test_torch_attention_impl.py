"""The port's attention routing (``minsdtf_tpu_torch/ops/attention.py``): the
default route to K1, K2 or the plain path, ``plain_scope`` that sends every call
of its thread to the plain path, and the train step's use of it: at a 32x32
latent, which the default route sends to K1, the step runs with both kernel
wrappers patched to raise."""

import threading

import numpy as np
import pytest
import torch

from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.ops import flash_attention as tfa
from minsdtf_tpu_torch.training import train_step as tts
from torch_port_utils import one_torch_thread  # noqa: F401

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)


def _refuse(*args):
    raise AssertionError("a kernel wrapper was called")


@pytest.fixture
def routes(monkeypatch):
    """Replaces the two wrappers and the plain path by stubs that record their
    name and return zeros, so that a call's route is read without computing it."""
    taken = []

    def stub(name):
        def run(q, *args):
            taken.append(name)
            return torch.zeros_like(q)
        return run

    monkeypatch.setattr(tfa, "onepass_attention", stub("onepass"))
    monkeypatch.setattr(tfa, "online_attention", stub("online"))
    monkeypatch.setattr(tattn, "plain_attention", stub("plain"))
    return taken


def _attend(sq, sk, d, causal=False):
    q = torch.zeros(1, sq, d)
    kv = torch.zeros(1, sk, d)
    return tattn.multi_head_attention(q, kv, kv, num_heads=1, causal=causal)


def test_the_step_takes_the_plain_path_by_name(monkeypatch):
    """At a 32x32 latent the level-0 self-attention has 1024 tokens, which the
    default route sends to K1: the step must not reach either wrapper."""
    monkeypatch.setattr(tfa, "onepass_attention", _refuse)
    monkeypatch.setattr(tfa, "online_attention", _refuse)
    unet = tunet.fuse_attention_projections(tunet.init("cpu", seed=0, **SMALL))
    batch = tts.sample_batch(1, latent_hw=32, device="cpu")
    t_emb = tsched.timestep_embedding_traced(batch.timesteps, dim=SMALL["widths"][0])
    with pytest.raises(AssertionError, match="kernel wrapper"):
        unet(batch.latents, t_emb, batch.context)  # the default route reaches K1
    init_fn, step_fn = tts.make_train_step()
    opt = init_fn(unet)
    losses = [float(step_fn(unet, opt, batch)) for _ in range(2)]
    assert np.isfinite(losses).all()
    assert not tattn._PLAIN.get()
    qkv = unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.to_qkv.weight
    assert qkv.grad is not None and bool(qkv.grad.abs().sum() > 0)


@pytest.mark.parametrize("plain", [False, True], ids=["default", "plain_scope"])
@pytest.mark.parametrize("sq,sk,d,causal,route", [
    (4096, 4096, 40, False, "onepass"),
    (4096, 77, 40, False, "plain"),     # cross-attention
    (16384, 16384, 40, False, "online"),
    (4096, 4096, 512, False, "online"),  # the VAE's single head
    (77, 77, 64, True, "plain"),        # CLIP
])
def test_routes(routes, plain, sq, sk, d, causal, route):
    if plain:
        with tattn.plain_scope():
            _attend(sq, sk, d, causal)
        assert routes == ["plain"]
    else:
        _attend(sq, sk, d, causal)
        assert routes == [route]


def test_plain_scope_nests_and_restores(routes):
    with tattn.plain_scope():
        with tattn.plain_scope():
            _attend(4096, 4096, 40)
        _attend(4096, 4096, 40)
        with pytest.raises(KeyError):
            with tattn.plain_scope():
                raise KeyError("the body raises")
        _attend(4096, 4096, 40)
    _attend(4096, 4096, 40)
    with pytest.raises(KeyError):
        with tattn.plain_scope():
            raise KeyError("the body raises")
    _attend(4096, 4096, 40)
    assert routes == ["plain"] * 3 + ["onepass"] * 2


def test_plain_scope_holds_for_its_own_thread_only(routes):
    """A train step in one thread leaves another thread's attention (a serving
    worker's) on the kernels, and the other way round."""
    inside, leave = threading.Event(), threading.Event()

    def trainer():
        with tattn.plain_scope():
            inside.set()
            leave.wait(timeout=60)
            _attend(4096, 4096, 40)

    thread = threading.Thread(target=trainer)
    thread.start()
    assert inside.wait(timeout=60)
    _attend(4096, 4096, 40)  # this thread, while the trainer is in its scope
    leave.set()
    thread.join(timeout=60)
    assert routes == ["onepass", "plain"]
    with tattn.plain_scope():
        worker = threading.Thread(target=_attend, args=(4096, 4096, 40))
        worker.start()
        worker.join(timeout=60)
        _attend(4096, 4096, 40)
    assert routes == ["onepass", "plain", "onepass", "plain"]
