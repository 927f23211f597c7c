"""The one traffic generator. A mix is a JSON file of parameters,
``sdbench/traffic/<mix>.json``:

- ``loop``: "closed" (one caller, each request sent when the last one's image is
  back) or "open" (requests due on a schedule, at ``rate_per_s``);
- ``height``, ``width``: the pipeline's image size;
- ``steps``, ``guidance``, ``rescale``: each request's settings, a number, or a
  list that each request draws one from;
- ``batch_size`` (closed loop, default 1): the images of one call, each request
  one call of one seed (the pipeline's own noise rows for that seed);
- ``scheduler`` (default "ddim"): the pipeline's sampler (``scheduler_type``);
  TCD's eta is the library's default, 0.3, as ``text_to_image`` takes no eta;
- ``burst`` (open loop, default 1): requests that arrive together at each due
  time;
- ``prompt_tokens`` ``[lo, hi]``: each prompt's length in tokens, uniform;
  ``words``: the vocabulary's whole-word tokens that prompts are drawn from;
  ``emphasis_share``: the share of prompts with one ``(span:w)`` group, w in
  ``emphasis_weights``;
- ``control``: null, or "edges" for a canny-like uint8 edge map per request.

Request ``i`` of stream ``s`` under ``--seed`` is drawn from its own generator,
``default_rng([seed, s, i])``, so a request never depends on how many came
before. Streams: 0 the measured window, 1 warm-up, 2 the traced segment. Open-loop
arrivals are the n quantiles of the exponential gaps for ``rate_per_s / burst``, in an
order drawn from the mix's ``arrival_seed``: a Poisson process's spread of gaps,
the same arrival times under every ``--seed`` (the order of the gaps moves a
window's tail by far more than two runs of one schedule differ), while the seed
draws each request's prompt and image seed.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterator, List, Optional, Union

import numpy as np

HERE = Path(__file__).resolve().parent
WINDOW, WARMUP, TRACED = 0, 1, 2
CHOICES = ("steps", "guidance", "rescale")  # a number, or a list to draw from per request


def load(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if mix["loop"] == "open" and mix.get("batch_size", 1) != 1:
        raise ValueError(f"{name}: a served request is one image; batch_size is for the closed loop")
    return mix


@dataclasses.dataclass
class Request:
    stream: int
    index: int
    prompt: str
    seed: int
    control: Optional[np.ndarray] = None
    due: Optional[float] = None  # seconds after the start of its schedule (open loop)
    steps: int = 25
    guidance: float = 7.5
    rescale: float = 0.7
    batch: int = 1
    tokens: int = 1  # the prompt's words, each one token of the vocabulary


def _setting(rng: np.random.Generator, value: Union[float, list]):
    return value[int(rng.integers(0, len(value)))] if isinstance(value, list) else value


def prompt(rng: np.random.Generator, mix: dict) -> str:
    return _prompt(rng, mix)[0]


def _prompt(rng: np.random.Generator, mix: dict):
    lo, hi = mix["prompt_tokens"]
    n = int(rng.integers(lo, hi + 1))
    words = [str(w) for w in rng.choice(mix["words"], n)]
    if rng.random() < mix.get("emphasis_share", 0.0):
        i = int(rng.integers(0, n))
        j = min(n, i + int(rng.integers(1, 4)))
        weight = float(rng.choice(mix["emphasis_weights"]))
        words[i:j] = ["(" + " ".join(words[i:j]) + f":{weight})"]
    return " ".join(words), n


def edge_map(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """A uint8 (H, W, 3) map of 0 and 255: the zero crossings of a sum of six
    random plane waves, curves one or two pixels wide, as a canny detector
    gives for a photo's outlines. Each wave cos(kx x + ky y + p) is split into
    products of row and column factors, so the field is one small matmul."""
    k = rng.uniform(-12.0, 12.0, (6, 2)) * 2 * np.pi / max(height, width)
    phase = rng.uniform(0.0, 2 * np.pi, 6)
    ys, xs = np.arange(height)[:, None], np.arange(width)[:, None]
    rows = np.concatenate([np.cos(k[:, 1] * ys + phase), -np.sin(k[:, 1] * ys + phase)], axis=1)
    cols = np.concatenate([np.cos(k[:, 0] * xs), np.sin(k[:, 0] * xs)], axis=1)
    sign = rows @ cols.T > 0
    edges = np.zeros_like(sign)
    edges[:, 1:] |= sign[:, 1:] != sign[:, :-1]
    edges[1:, :] |= sign[1:, :] != sign[:-1, :]
    return np.repeat((edges * np.uint8(255))[..., None], 3, axis=2)


def request(mix: dict, seed: int, stream: int, index: int) -> Request:
    rng = np.random.default_rng([int(seed) % 2**64, stream, index])
    text, n_tokens = _prompt(rng, mix)
    image_seed = int(rng.integers(0, 2**31 - 2))
    control = None
    if mix.get("control") == "edges":
        control = edge_map(rng, mix["height"], mix["width"])
    # drawn last, and only where the mix gives a list: a mix of fixed settings
    # draws what it drew before these keys existed
    steps, guidance, rescale = (_setting(rng, mix[k]) for k in CHOICES)
    return Request(stream, index, text, image_seed, control, steps=int(steps), guidance=float(guidance),
                   rescale=float(rescale), batch=int(mix.get("batch_size", 1)), tokens=n_tokens)


def closed(mix: dict, seed: int, stream: int) -> Iterator[Request]:
    """Requests 0, 1, 2, ... of ``stream``, drawn as they are taken."""
    index = 0
    while True:
        yield request(mix, seed, stream, index)
        index += 1


def arrivals(rate: float, seconds: float, order_seed: int, stream: int, burst: int = 1) -> np.ndarray:
    """Due times (s from the start) of round(rate * seconds) requests: the
    quantiles of the exponential gaps in the order ``order_seed`` draws, for
    bursts of ``burst`` requests at ``rate / burst``, each burst's requests due
    together."""
    if burst > 1:
        return np.repeat(arrivals(rate / burst, seconds, order_seed, stream), burst)
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([order_seed, stream]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def schedule(mix: dict, seed: int, stream: int, seconds: float, order_stream: Optional[int] = None
             ) -> List[Request]:
    """The open loop's requests of ``stream`` due within ``seconds``: the mix's
    arrival times (those of ``order_stream`` where given), the same under every
    seed, and the seed's requests."""
    out = []
    order = stream if order_stream is None else order_stream
    due_times = arrivals(mix["rate_per_s"], seconds, mix["arrival_seed"], order, int(mix.get("burst", 1)))
    for i, due in enumerate(due_times):
        req = request(mix, seed, stream, i)
        req.due = float(due)
        out.append(req)
    return out
