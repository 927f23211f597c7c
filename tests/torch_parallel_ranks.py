"""What each rank runs in the port's multi-rank tests (``tests/test_torch_parallel_*.py``).

The ranks are spawned processes (``parallel.mesh.run_ranks``): this module imports
torch, numpy and the port only, never JAX, so a rank starts without it. The
tests hand the ranks numpy inputs and ``state_dict`` files made from the JAX
package's params, and compare what the ranks return with the JAX package's
results under the same mesh."""

import numpy as np
import torch

from minsdtf_tpu_torch import StableDiffusion
from minsdtf_tpu_torch import sampler
from minsdtf_tpu_torch import scheduler as tsched
from minsdtf_tpu_torch.models import clip as tclip
from minsdtf_tpu_torch.models import controlnet as tcontrolnet
from minsdtf_tpu_torch.models import unet as tunet
from minsdtf_tpu_torch.models import vae as tvae
from minsdtf_tpu_torch.ops import attention as tattn
from minsdtf_tpu_torch.ops import ring_attention as tring
from minsdtf_tpu_torch.parallel import sharding
from minsdtf_tpu_torch.parallel.mesh import make_mesh
from minsdtf_tpu_torch.training import train_step as tts

SMALL = dict(widths=(32, 64, 128, 128), temb_dim=128)  # the JAX tests' widths
PIPE_UNET = dict(widths=(320, 64, 128, 128), temb_dim=128)  # torch_port_utils.UNET
VAE_DEC = (64, 64, 32, 32)
VAE_ENC = (32, 32, 64, 64)


def loaded(module, path):
    """``module`` holding the ``state_dict`` saved at ``path``, in eval mode."""
    module.load_state_dict(torch.load(path, weights_only=True))
    return module.eval()


def schedule_inputs(num_steps: int = 2):
    """The JAX tests' DDIM schedule rows and their 32-wide timestep embeddings."""
    schedule = tsched.build_denoise_schedule(tsched.Scheduler(active_tcd=False), num_steps)
    t_embs = torch.from_numpy(tsched.timestep_embedding(schedule.timesteps, dim=32))
    return schedule.rows, t_embs


def ring(shapes, seed: int = 0):
    """Ring attention over the whole world on the data axis, at each ``(s, heads,
    d)`` of ``shapes`` (batch 2, fp32, the inputs of ``tests/test_ring_attention.py``);
    then the routing of ``multi_head_attention`` under ``sequence_parallel_scope``.
    Returns ``{shape: output}`` and the routing's observations."""
    n = torch.distributed.get_world_size()
    mesh = make_mesh(data=n, model=1)
    outs = {}
    for s, heads, d in shapes:
        rng = np.random.RandomState(seed)
        q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, s, heads * d)).astype(np.float32))
                   for _ in range(3))
        outs[(s, heads, d)] = tring.ring_multi_head_attention(q, k, v, heads, mesh).numpy()
    q = torch.randn(1, 1024, 64, generator=torch.Generator().manual_seed(1))
    routes = {}
    with tattn.sequence_parallel_scope(mesh, "data", min_seq=512):
        routes["key"] = tattn.sequence_parallel_key()
        for label, args, kw in (("self 1024", (q, q, q), {}), ("self 256", (q[:, :256],) * 3, {}),
                                ("causal 1024", (q, q, q), {"causal": True}),
                                ("cross 1024x77", (q, q[:, :77], q[:, :77]), {})):
            before = tring.ring_multi_head_attention.calls
            tattn.multi_head_attention(*args, num_heads=2, **kw)
            routes[label] = tring.ring_multi_head_attention.calls - before
        with tattn.plain_scope():
            before = tring.ring_multi_head_attention.calls
            tattn.multi_head_attention(q, q, q, num_heads=2)
            routes["self 1024 in plain_scope"] = tring.ring_multi_head_attention.calls - before
        grad_q = q.clone().requires_grad_()
        try:
            tattn.multi_head_attention(grad_q, grad_q, grad_q, num_heads=2)
            routes["grad"] = None
        except RuntimeError as e:
            routes["grad"] = str(e)
    routes["key after"] = tattn.sequence_parallel_key()
    return outs, routes


def unet_forward(state_path: str, inputs, meshes):
    """The small UNet's forward on this rank's rows under each ``(data, model)`` of
    ``meshes``, gathered: ``{mesh: output}``."""
    outs = {}
    for data, model in meshes:
        mesh = make_mesh(data, model)
        unet = sharding.shard_module(loaded(tunet.UNet(**SMALL), state_path), mesh)
        local = [sharding.shard_batch(torch.from_numpy(a), mesh) for a in inputs]
        with torch.inference_mode():
            out = unet(*local)
        outs[(data, model)] = sharding.gather_batch(out, mesh).numpy()
    return outs


def sampler_runs(unet_path: str, decoder_path: str, dp_inputs, sp_inputs):
    """The production sampler under DP x TP on mesh (4, 2), CFG 7.5, rescale 0.7,
    with the decode (``dp_inputs``: latent0, context, uncond, batch 4), and
    sequence-parallel on mesh (2, 4) with ``min_seq=1024``, no CFG, no decode
    (``sp_inputs``: a 32x32 latent0 and a context). Returns the DP image and latent
    and the SP latent, each whole."""
    rows, t_embs = schedule_inputs()
    mesh = make_mesh(4, 2)
    unet = sharding.shard_module(loaded(tunet.UNet(**SMALL), unet_path), mesh)
    decoder = sharding.shard_module(loaded(tvae.VAEDecoder(VAE_DEC), decoder_path), mesh)
    local = [sharding.shard_batch(torch.from_numpy(a), mesh) for a in dp_inputs]
    image, latent = sampler.generate(unet, decoder, *local, t_embs, rows, 7.5, 0.7)
    image, latent = (sharding.gather_batch(t, mesh).numpy() for t in (image, latent))

    sp_mesh = make_mesh(2, 4)
    unet = sharding.replicate_module(loaded(tunet.UNet(**SMALL), unet_path), sp_mesh)
    latent0, context = (torch.from_numpy(a) for a in sp_inputs)
    before = tring.ring_multi_head_attention.calls
    with tattn.sequence_parallel_scope(sp_mesh, "model", min_seq=1024):
        _, sp_latent = sampler.generate(unet, None, latent0, context, None, t_embs, rows,
                                        0.0, 0.0)
    return dict(image=image, latent=latent, sp_latent=sp_latent.numpy(),
                ring_calls=tring.ring_multi_head_attention.calls - before)


def _pipeline(paths: dict, bpe: str, size: int, mesh, controlnet: bool = False, **kw):
    pipe = StableDiffusion(size, size, bpe_path=bpe, compute_dtype=torch.float32,
                           device="cpu", mesh=mesh, **kw)
    pipe._unet = loaded(tunet.UNet(**PIPE_UNET), paths["unet"])
    pipe._encoder = loaded(tvae.VAEEncoder(VAE_ENC), paths["encoder"])
    pipe._decoder = loaded(tvae.VAEDecoder(VAE_DEC), paths["decoder"])
    pipe._text_model = loaded(tclip.CLIPTextModel(), paths["text"])
    if controlnet:
        pipe._controlnet = loaded(tcontrolnet.ControlNet(**PIPE_UNET), paths["controlnet"])
    return pipe


def pipeline_runs(paths: dict, bpe: str, size: int, edges: np.ndarray):
    """``StableDiffusion(mesh=...)`` on two ranks: txt2img at batch 2 on mesh
    (2, 1), ControlNet txt2img on mesh (1, 2) (TP), and the ``ValueError`` of a
    batch the data axis does not divide and of ``weight_dtype`` with a mesh."""
    common = dict(num_steps=3, seed=7, return_latent=True)
    dp = _pipeline(paths, bpe, size, make_mesh(2, 1))
    out = {"dp": dp.text_to_image("hello world", batch_size=2, **common)}
    errors = {}
    try:
        dp.text_to_image("hello world", batch_size=3, **common)
    except ValueError as e:
        errors["batch 3 on data=2"] = str(e)
    try:
        StableDiffusion(size, size, device="cpu", mesh=dp.mesh, weight_dtype="int8")
    except ValueError as e:
        errors["weight_dtype with a mesh"] = str(e)
    tp = _pipeline(paths, bpe, size, make_mesh(1, 2), controlnet=True)
    out["tp_controlnet"] = tp.text_to_image("hello world", control_net_image=edges, **common)
    out["tp_heads"] = tp.unet.down_blocks[0].attentions[0].transformer_blocks[0].attn1.num_heads
    out["errors"] = errors
    return out


def train_steps(state_path: str, batch: dict, lr: float, steps: int = 2):
    """``steps`` AdamW steps (``lr``) of the small UNet on mesh (2, 2), each rank on
    its rows of ``batch``. Returns the losses and this rank's weights after the
    steps (TP shards as they are), and its model rank."""
    mesh = make_mesh(2, 2)
    unet = tunet.UNet(**SMALL)
    unet.load_state_dict(torch.load(state_path, weights_only=True))
    unet = sharding.shard_module(unet, mesh)
    local = tts.TrainBatch(**{
        k: sharding.shard_batch(torch.from_numpy(v.astype(np.int64) if k == "timesteps" else v),
                                mesh) for k, v in batch.items()})
    init_fn, step_fn = tts.make_train_step(lambda params: tts.adamw(params, lr=lr), mesh=mesh)
    opt = init_fn(unet)
    losses = [float(step_fn(unet, opt, local)) for _ in range(steps)]
    params = {n: p.detach().numpy().copy() for n, p in unet.named_parameters()}
    return dict(losses=losses, params=params, model_rank=mesh.get_local_rank("model"))
