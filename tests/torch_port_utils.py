"""Helpers shared by the port's tests (``tests/test_torch_*.py``): a synthetic CLIP
merges file, norm perturbation of JAX params, and JAX params loaded into a port
module through ``weights.from_jax``."""

import gzip

import numpy as np

from minsdtf_tpu_torch.weights.from_jax import from_jax

# enough merges for the test prompts to form multi-character tokens
MERGES = [
    "h e", "l l", "he ll", "o</w> w", "hell o</w>", "w o", "wo r", "wor l",
    "worl d</w>", "t h", "th e</w>", "c a", "ca t</w>", "d o", "do g</w>",
    "s t", "st a", "sta r</w>", "* *", "1 2", "Ã ©",
]


def write_merges(path) -> str:
    """A gzipped merges file at ``path``; returns the path as a string."""
    with gzip.open(path, "wt") as f:
        f.write("#version: synthetic\n" + "\n".join(MERGES) + "\n")
    return str(path)


def perturb_norms(params, seed: int):
    """Norm scales to N(1, 0.3) and biases to N(0.1, 0.3), in place. With scale 1
    and bias 0 the CLIP output's per-token mean is ~1e-10, and the LPW
    mean-preserving rescale divides two near-zeros."""
    rs = np.random.RandomState(seed)
    for leaves in params.values():
        if "scale" in leaves:
            leaves["scale"] = rs.normal(1.0, 0.3, leaves["scale"].shape).astype(np.float32)
            leaves["bias"] = rs.normal(0.1, 0.3, leaves["bias"].shape).astype(np.float32)
    return params


def load(module, params):
    """``module`` with the JAX ``params`` loaded, in eval mode."""
    module.load_state_dict(from_jax(params, module))
    return module.eval()
