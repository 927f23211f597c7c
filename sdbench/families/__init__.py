"""The model families: everything of the benchmark that depends on the
architecture, found through the ``family`` key of a configuration's file.

A family is the module ``sdbench/families/<family>.py``. It provides

- ``kinds(cfg)``: the model kinds whose weights are made (``weights.make``) and
  which the reference loads;
- ``build(kind, cfg, ops=None, device="meta")``: the reference's module of a
  kind, whose parameters name and shape the weights;
- ``Reference(cfg, weights, merges_path, device, ops=None)``: the frozen fp32
  reference, whose ``request(req, mix)`` gives a request's uint8 (B, H, W, 3)
  images;
- ``ReferencePipe(ref, mix, device)``: the reference in the program's place,
  with the entry points the harness and the serving worker call (the control);
- ``request_flops(cfg, mix, req=None)`` and ``long_attentions(cfg, mix,
  req=None)``: a request's FLOPs and its long self-attentions;
- ``build_pipeline(cfg, weights, mix, device, merges_path, compute_dtype=None)``:
  the system under test, built from the port.

Every configuration also has ``dtype`` (the type it is served in) and
``tokenizer.merges`` (the BPE merges file, from the repository's root), which
the harness reads itself.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from types import ModuleType


def load(cfg: dict) -> ModuleType:
    """The family module that ``cfg`` names; raises ``ValueError`` where it
    names none, or one that does not exist. There is no default family."""
    name = cfg.get("family")
    where = cfg.get("name", "a configuration")
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"{where}: the configuration names no model family (its \"family\" key is {name!r})")
    module = f"{__name__}.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise ValueError(f"{where}: no model family {name!r} (no module {module})") from None


def read(path) -> dict:
    """The configuration in the file ``path``, its family checked: raises
    ``ValueError`` naming the file where it names no family that exists."""
    cfg = json.loads(Path(path).read_text())
    try:
        load(cfg)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return cfg
