"""The text front end in plain Python: CLIP's byte-level BPE over a merges file,
the A1111 attention syntax (``(text)`` x1.1, ``[text]`` /1.1, ``(text:w)``), and
the one-chunk token and weight rows that the CLIP encoder takes.

The pre-tokenizer handles ASCII text, which is all the benchmark's traffic holds:
runs of letters, single digits, runs of other printable characters, and CLIP's
contractions.
"""

from __future__ import annotations

import gzip
import re
from typing import List, Tuple

SOT, EOT = "<|startoftext|>", "<|endoftext|>"
CHUNK = 77
PAD_ID = 49407  # the padding id between the prompt and its last token
UNCOND_IDS = [49406] + [49407] * (CHUNK - 1)  # the unconditional row

_PRE = re.compile(r"'s|'t|'re|'ve|'m|'ll|'d|[a-z]+|[0-9]|[^\sa-z0-9]+")


def _byte_map() -> dict:
    """Byte -> its printable stand-in (GPT-2's table), in vocabulary order: the
    printable bytes as themselves, then the others mapped from 256 up."""
    keep = list(range(33, 127)) + list(range(161, 173)) + list(range(174, 256))
    rest = [b for b in range(256) if b not in keep]
    return {**{b: chr(b) for b in keep}, **{b: chr(256 + i) for i, b in enumerate(rest)}}


class BPE:
    def __init__(self, merges_path: str):
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(line.split()) for line in lines]
        self.bytes = _byte_map()
        self.units = list(self.bytes.values())
        vocab = self.units + [u + "</w>" for u in self.units] + ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.ids = {t: i for i, t in enumerate(vocab)}
        self.rank = {m: i for i, m in enumerate(merges)}
        self.sot, self.eot = self.ids[SOT], self.ids[EOT]

    def _word(self, word: str) -> List[str]:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(self.rank.get((a, b), 1 << 30), i) for i, (a, b) in enumerate(zip(parts, parts[1:]))]
            best = min(pairs)[0]
            if best == 1 << 30:
                break
            a, b = next((parts[i], parts[i + 1]) for r, i in pairs if r == best)
            out, i = [], 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == a and parts[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        return parts

    def encode(self, text: str) -> List[int]:
        """The token ids of ``text``, without the start and end tokens."""
        out = []
        for word in _PRE.findall(" ".join(text.split()).lower()):
            mapped = "".join(self.bytes[b] for b in word.encode("utf-8"))
            out += [self.ids[p] for p in self._word(mapped)]
        return out


def parse_attention(text: str) -> List[Tuple[str, float]]:
    """A1111's emphasis syntax: ``[(fragment, weight), ...]`` with adjacent
    fragments of equal weight merged."""
    res: List[list] = []
    round_open: List[int] = []
    square_open: List[int] = []
    pattern = re.compile(r"\\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|\)|]|[^\\()\[\]:]+|:")

    def scale(start: int, factor: float):
        for item in res[start:]:
            item[1] *= factor

    for m in pattern.finditer(text):
        tok, weight = m.group(0), m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_open.append(len(res))
        elif tok == "[":
            square_open.append(len(res))
        elif weight is not None and round_open:
            scale(round_open.pop(), float(weight))
        elif tok == ")" and round_open:
            scale(round_open.pop(), 1.1)
        elif tok == "]" and square_open:
            scale(square_open.pop(), 1 / 1.1)
        else:
            res.append([tok, 1.0])
    for start in round_open:
        scale(start, 1.1)
    for start in square_open:
        scale(start, 1 / 1.1)
    merged: List[list] = []
    for frag, w in res or [["", 1.0]]:
        if merged and merged[-1][1] == w:
            merged[-1][0] += frag
        else:
            merged.append([frag, w])
    return [(f, w) for f, w in merged]


def prompt_rows(bpe: BPE, prompt: str) -> Tuple[List[int], List[float]]:
    """The 77 token ids and 77 weights of a prompt of at most 75 tokens:
    [SOT] + tokens + [PAD_ID] * ... + [EOT], weights 1 at the three kinds of
    filler."""
    tokens: List[int] = []
    weights: List[float] = []
    for frag, w in parse_attention(prompt):
        ids = bpe.encode(frag.strip())
        tokens += ids
        weights += [w] * len(ids)
    if len(tokens) > CHUNK - 2:
        raise ValueError(f"{len(tokens)} tokens: the reference takes one chunk of {CHUNK - 2}")
    pad = CHUNK - 2 - len(tokens)
    return ([bpe.sot] + tokens + [PAD_ID] * pad + [bpe.eot],
            [1.0] + weights + [1.0] * (pad + 1))
