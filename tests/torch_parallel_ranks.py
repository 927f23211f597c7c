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
from minsdtf_tpu_torch.ops import basic as tbasic
from minsdtf_tpu_torch.ops import ring_attention as tring
from minsdtf_tpu_torch.parallel import sharding, spatial
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
    whole, sharded = tring.ring_multi_head_attention.calls, tring.ring_attention_sharded.calls
    spatial.reset_calls()
    with tattn.sequence_parallel_scope(sp_mesh, "model", min_seq=1024):
        _, sp_latent = sampler.generate(unet, None, latent0, context, None, t_embs, rows,
                                        0.0, 0.0)
    return dict(image=image, latent=latent, sp_latent=sp_latent.numpy(),
                ring_whole=tring.ring_multi_head_attention.calls - whole,
                ring_calls=tring.ring_attention_sharded.calls - sharded,
                spatial=dict(spatial.calls))


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
    (2, 1), ControlNet txt2img on mesh (1, 2) (TP), and the ``ValueError`` of
    ``weight_dtype`` with a mesh."""
    common = dict(num_steps=3, seed=7, return_latent=True)
    dp = _pipeline(paths, bpe, size, make_mesh(2, 1))
    out = {"dp": dp.text_to_image("hello world", batch_size=2, **common)}
    errors = {}
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


def _conv(weight: np.ndarray, bias: np.ndarray, dtype) -> torch.nn.Conv2d:
    conv = torch.nn.Conv2d(weight.shape[1], weight.shape[0], weight.shape[2], dtype=dtype)
    conv.weight.data = torch.from_numpy(weight).to(dtype)
    conv.bias.data = torch.from_numpy(bias).to(dtype)
    return conv


def spatial_ops(inputs: dict):
    """``parallel.spatial`` on the model axis of mesh (1, world), in fp64 and fp32:
    each conv case of ``inputs["convs"]`` (name: (stride, padding)) by
    ``halo_conv2d`` on this rank's rows of ``inputs["x"]`` (and once with
    ``whole_input``), the upsampler into a sharded level from a whole and from a
    sharded input, and ``group_norm`` (with and without SiLU), each gathered; then
    the same on channels-last inputs and weights, with whether each output and its
    gathered whole are channels-last.
    Returns ``{(dtype, case): whole output}``, the spatial calls and the
    collectives."""
    from minsdtf_tpu_torch.parallel import comm, spatial

    n = torch.distributed.get_world_size()
    mesh = make_mesh(1, n)
    out = {}
    spatial.reset_calls()
    comm.reset_stats()
    with tattn.sequence_parallel_scope(mesh, "model", min_seq=1):
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).split(".")[-1]
            x = torch.from_numpy(inputs["x"]).to(dtype)
            small = torch.from_numpy(inputs["small"]).to(dtype)
            conv = _conv(inputs["weight"], inputs["bias"], dtype)
            up = _conv(inputs["up_weight"], inputs["up_bias"], dtype)
            for case, (stride, padding) in inputs["convs"].items():
                y = spatial.halo_conv2d(conv, spatial.local_rows(x), stride, padding)
                out[name, case] = spatial.gather_rows(y).numpy()
            out[name, "3x3 whole input"] = spatial.gather_rows(
                spatial.halo_conv2d(conv, x, whole_input=True)).numpy()
            out[name, "upsample whole input"] = spatial.gather_rows(
                spatial.upsample2x_conv3x3(up, small, whole_input=True)).numpy()
            out[name, "upsample sharded input"] = spatial.gather_rows(
                spatial.upsample2x_conv3x3(up, spatial.local_rows(x), whole_input=False)).numpy()
            gn = torch.from_numpy(inputs["gn_x"]).to(dtype)
            scale, shift = (torch.from_numpy(inputs[k]) for k in ("gn_scale", "gn_bias"))
            for silu in (False, True):
                got = spatial.group_norm(spatial.local_rows(gn), scale, shift, silu=silu)
                out[name, f"group_norm silu={silu}"] = spatial.gather_rows(got).numpy()
        counts = dict(spatial.calls), {k: v["calls"] for k, v in comm.stats.items()}
        for dtype in (torch.float64, torch.float32):  # not counted above
            name = str(dtype).split(".")[-1]
            x, gn = (tbasic.channels_last(torch.from_numpy(inputs[k]).to(dtype))
                     for k in ("x", "gn_x"))
            conv, up = (_conv(inputs[w], inputs[b], dtype)
                        for w, b in (("weight", "bias"), ("up_weight", "up_bias")))
            for m in (conv, up):
                m.weight.data = tbasic.channels_last(m.weight.data)
            rows = {case: spatial.halo_conv2d(conv, spatial.local_rows(x), stride, padding)
                    for case, (stride, padding) in inputs["convs"].items()}
            rows["upsample sharded input"] = spatial.upsample2x_conv3x3(
                up, spatial.local_rows(x), whole_input=False)
            rows["group_norm silu=True"] = spatial.group_norm(spatial.local_rows(gn), scale,
                                                              shift, silu=True)
            layout = {}
            for case, part in rows.items():
                whole = spatial.gather_rows(part)
                layout[case] = part.is_contiguous(memory_format=torch.channels_last)
                layout[f"{case} gathered"] = whole.is_contiguous(memory_format=torch.channels_last)
                out[name, f"{case} channels-last"] = whole.numpy()
            out[name, "channels-last"] = layout
    return (out, *counts)


class _Recording:
    """In the body of a ``with``: the input shape of every ``F.conv2d`` call and the
    (shape, dim) of every tensor that ``comm.all_gather`` gathers, in order."""

    def __enter__(self):
        from minsdtf_tpu_torch.parallel import comm

        self.convs, self.gathers = [], []
        self._conv, self._gather = torch.nn.functional.conv2d, comm.all_gather

        def conv(x, *a, **kw):
            self.convs.append(tuple(x.shape))
            return self._conv(x, *a, **kw)

        def gather(t, group, dim=0):
            self.gathers.append((tuple(t.shape), dim))
            return self._gather(t, group, dim)

        torch.nn.functional.conv2d, comm.all_gather = conv, gather
        return self

    def __exit__(self, *exc):
        from minsdtf_tpu_torch.parallel import comm

        torch.nn.functional.conv2d, comm.all_gather = self._conv, self._gather


def spatial_unet(state: dict, inputs, min_seq: int):
    """The small UNet (``state``: numpy arrays) whole on every rank of mesh
    (1, world), its forward on the whole ``inputs`` under
    ``sequence_parallel_scope(min_seq=min_seq)``. Returns the output, the conv
    input shapes and gathers of the forward, the collectives' calls, the spatial
    calls and the two rings' calls."""
    from minsdtf_tpu_torch.parallel import comm, spatial

    mesh = make_mesh(1, torch.distributed.get_world_size())
    unet = tunet.UNet(**SMALL)
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    unet = sharding.replicate_module(unet.eval(), mesh)
    comm.reset_stats()
    spatial.reset_calls()
    whole, sharded = tring.ring_multi_head_attention.calls, tring.ring_attention_sharded.calls
    with tattn.sequence_parallel_scope(mesh, "model", min_seq=min_seq), torch.inference_mode(), \
            _Recording() as rec:
        out = unet(*(torch.from_numpy(a) for a in inputs)).numpy()
    return dict(out=out, convs=rec.convs, gathers=rec.gathers,
                comm={k: v["calls"] for k, v in comm.stats.items()}, spatial=dict(spatial.calls),
                ring_whole=tring.ring_multi_head_attention.calls - whole,
                ring_sharded=tring.ring_attention_sharded.calls - sharded)


def seeded_modules() -> dict:
    """The small pipeline modules from seeds, unfused, on the CPU, in eval mode,
    under the pipeline's attribute names: the UNet (seed 0), CLIP (1), the VAE
    decoder (2), the ControlNet (3) and the VAE encoder (4). Every rank builds the
    same; the tests convert them for the JAX package
    (``torch_port_utils.to_jax_params``), so no weights file is written."""
    return {"_unet": tunet.init("cpu", seed=0, **PIPE_UNET).eval(),
            "_text_model": tclip.init("cpu", seed=1).eval(),
            "_decoder": tvae.init_decoder("cpu", seed=2, dec_widths=VAE_DEC).eval(),
            "_controlnet": tcontrolnet.init("cpu", seed=3, **PIPE_UNET).eval(),
            "_encoder": tvae.init_encoder("cpu", seed=4, enc_widths=VAE_ENC).eval()}


def mesh_pipeline(bpe: str, size: int, mesh_shape, calls, settings: dict):
    """``StableDiffusion(mesh=make_mesh(*mesh_shape), **settings)`` holding
    :func:`seeded_modules`: each ``(label, method, kwargs)`` of ``calls`` on "hello
    world" (3 steps, seed 7, latent returned). Returns ``{label: (image, latent)}``
    and, per label, the collectives' and the spatial operations' calls."""
    from minsdtf_tpu_torch.parallel import comm

    pipe = StableDiffusion(size, size, bpe_path=bpe, compute_dtype=torch.float32, device="cpu",
                           mesh=make_mesh(*mesh_shape), **settings)
    for name, module in seeded_modules().items():
        setattr(pipe, name, module)
        getattr(pipe, name[1:])  # placed on the mesh now: its weight check gathers
    out, counts = {}, {}
    for label, method, kw in calls:
        comm.reset_stats()
        spatial.reset_calls()
        out[label] = getattr(pipe, method)("hello world", num_steps=3, seed=7, return_latent=True,
                                           **kw)
        counts[label] = dict(comm={k: v["calls"] for k, v in comm.stats.items()},
                             spatial=dict(spatial.calls))
    return out, counts


def clip_tp(tokens: np.ndarray):
    """CLIP (seed 1) Megatron-sharded over the model axis of mesh (1, world):
    ``encode_tokens`` of ``tokens``, and each attention's and MLP's layout."""
    mesh = make_mesh(1, torch.distributed.get_world_size())
    model = sharding.shard_module(tclip.init("cpu", seed=1).eval(), mesh)
    layer = model.text_model.encoder.layers[0]
    with torch.inference_mode():
        out = tclip.encode_tokens(model, torch.from_numpy(tokens)).numpy()
    return dict(out=out, heads=layer.self_attn.num_heads,
                q_proj=type(layer.self_attn.q_proj).__name__, fc1=type(layer.mlp.fc1).__name__,
                fc1_rows=layer.mlp.fc1.weight.shape[0])
