"""Checkpoint fetching: URLs -> a local cache, with the JAX package's default weight
sources (a copy of its ``weights/fetch.py``; standard library only).

Pass a URL (``http(s)://`` or ``file://``) or ``"default"`` as any checkpoint
path of the pipeline and it resolves through ``$MINSDTF_CACHE`` (by default
``~/.cache/minsdtf/``). Without a network only ``file://`` URLs and files already
in the cache resolve.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional

# The default weight sources (the same files as the JAX package's).
DEFAULT_URLS = {
    "unet": "https://huggingface.co/dreamlike-art/dreamlike-photoreal-2.0/resolve/main/dreamlike-photoreal-2.0.safetensors",
    "text_encoder": "https://huggingface.co/runwayml/stable-diffusion-v1-5/resolve/main/text_encoder/model.safetensors",
    "vae": "https://huggingface.co/stabilityai/sd-vae-ft-mse/resolve/main/diffusion_pytorch_model.safetensors",
    "controlnet": "https://huggingface.co/lllyasviel/ControlNet/resolve/main/models/control_sd15_canny.pth",
    "bpe": "https://github.com/openai/CLIP/blob/main/clip/bpe_simple_vocab_16e6.txt.gz?raw=true",
}
BPE_SHA256 = "924691ac288e54409236115652ad4aa250f48203de50a9e4722a6ecd48d6804a"
_URL_SCHEMES = ("http://", "https://", "file://")


def cache_dir() -> str:
    return os.environ.get("MINSDTF_CACHE", os.path.expanduser("~/.cache/minsdtf"))


def default_sha256(kind: str) -> Optional[str]:
    """The integrity pin for ``DEFAULT_URLS[kind]``. Downloaded checkpoints may go
    through ``torch.load``, so an unverified download is a supply-chain risk. Only
    the BPE digest is known; a checkpoint's pin comes from
    ``MINSDTF_SHA256_<KIND>`` until one is recorded here. Unpinned downloads are
    checked trust-on-first-use (:func:`fetch`)."""
    if kind == "bpe":
        return BPE_SHA256
    return os.environ.get(f"MINSDTF_SHA256_{kind.upper()}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fetch(url: str, fname: Optional[str] = None, sha256: Optional[str] = None) -> str:
    """Download ``url`` into the cache (once) and return the local path.

    With ``sha256`` the download is verified against the pin. Without one, the
    digest is recorded on first fetch (``<file>.sha256``) and re-checked on later
    calls: trust-on-first-use rather than no verification at all."""
    import urllib.request

    directory = cache_dir()
    os.makedirs(directory, exist_ok=True)
    fname = fname or os.path.basename(url.split("?")[0])
    path = os.path.join(directory, fname)
    if not os.path.exists(path):
        print(f"downloading {url} -> {path}")
        tmp = path + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, path)
    digest = _sha256_file(path)
    if sha256 is not None:
        if digest != sha256:
            raise IOError(f"{path}: sha256 mismatch ({digest} != {sha256})")
    else:
        record = path + ".sha256"
        if os.path.exists(record):
            with open(record) as f:
                pinned = f.read().strip()
            if digest != pinned:
                raise IOError(f"{path}: sha256 changed since first fetch "
                              f"({digest} != {pinned}); delete both files to re-trust")
        else:
            print(f"WARNING: {fname} downloaded without a sha256 pin; "
                  f"recording {digest} (trust-on-first-use)")
            with open(record, "w") as f:
                f.write(digest + "\n")
    return path


def resolve(path_or_url: Optional[str], kind: str) -> Optional[str]:
    """Local path -> unchanged; URL -> fetched; "default" -> the default weight
    source for ``kind``; None -> None."""
    if path_or_url is None:
        return None
    s = str(path_or_url)
    pin = None
    if s == "default":
        s = DEFAULT_URLS[kind]
        pin = default_sha256(kind)
    elif kind == "bpe":
        pin = BPE_SHA256 if s == DEFAULT_URLS["bpe"] else None
    if s.startswith(_URL_SCHEMES):
        return fetch(s, sha256=pin)
    return s
