"""CLIP byte-pair-encoding tokenizer (host-side, standard library only).

Byte<->unicode tables, ``</w>`` end-of-word BPE over a ranked merges file, the CLIP
pre-tokenizer (including dynamically added special tokens), BOS/EOT wrapping,
decode, and ``add_tokens`` for textual-inversion placeholders.

The CLIP pre-tokenizer is the regex
``specials|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` (case-
insensitive). The standard ``re`` module has no ``\\p{..}`` classes, so
:func:`pre_tokenize` scans the text with the same leftmost-alternative semantics:
letters are the Unicode categories ``L*``, numbers ``N*``.

The merges file is the standard OpenAI CLIP ``bpe_simple_vocab_16e6.txt.gz``; its
path must be supplied (``bpe_path``).
"""

from __future__ import annotations

import gzip
import html
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Sequence, Union

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
_NUM_MERGES = 49152 - 256 - 2  # vocabulary budget of the CLIP BPE
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """Reversible byte -> printable-unicode mapping (GPT-2/CLIP convention)."""
    printable = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {b: chr(b) for b in printable}
    offset = 0
    for b in range(256):
        if b not in mapping:
            mapping[b] = chr(256 + offset)
            offset += 1
    return mapping


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


def _is_letter(ch: str) -> bool:
    return unicodedata.category(ch).startswith("L")


def _is_number(ch: str) -> bool:
    return unicodedata.category(ch).startswith("N")


def _is_other(ch: str) -> bool:
    return not (ch.isspace() or _is_letter(ch) or _is_number(ch))


def pre_tokenize(text: str, specials: Sequence[str]) -> List[str]:
    """``re.findall`` of the CLIP pre-tokenizer pattern over ``text``: at each
    position the first alternative that matches wins, in pattern order."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        end = None
        for alt in (*specials, *_CONTRACTIONS):
            if alt and text[i:i + len(alt)].lower() == alt.lower():
                end = i + len(alt)
                break
        if end is None:
            ch = text[i]
            if _is_letter(ch):
                end = i + 1
                while end < n and _is_letter(text[end]):
                    end += 1
            elif _is_number(ch):
                end = i + 1
            elif _is_other(ch):
                end = i + 1
                while end < n and _is_other(text[end]):
                    end += 1
        if end is None:  # whitespace: no alternative matches here
            i += 1
            continue
        out.append(text[i:end])
        i = end
    return out


class ClipTokenizer:
    def __init__(self, bpe_path: str):
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path) as f:
                data = f.read().decode("utf-8")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                data = f.read()
        # Line 0 is a version header. Blank lines are kept, as the reference does:
        # they shift every later vocab id, and ids must match the checkpoint.
        lines = data.split("\n")[1 : _NUM_MERGES + 1]
        merges = [tuple(line.split()) for line in lines]

        units = list(byte_unicode_table().values())
        vocab: List[str] = units + [u + "</w>" for u in units]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT_TOKEN, EOT_TOKEN]
        self.vocab = vocab
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = byte_unicode_table()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.special_tokens = [SOT_TOKEN, EOT_TOKEN]
        self._bpe_cache: Dict[str, str] = {t: t for t in self.special_tokens}

    @property
    def start_of_text(self) -> int:
        return self.encoder[SOT_TOKEN]

    @property
    def end_of_text(self) -> int:
        return self.encoder[EOT_TOKEN]

    def add_tokens(self, tokens: Union[str, List[str]]) -> int:
        """Register new special tokens (textual-inversion placeholders). Returns the
        number actually added."""
        if isinstance(tokens, str):
            tokens = [tokens]
        added = 0
        for tok in tokens:
            if tok in self.encoder:
                continue
            self.vocab.append(tok)
            self.encoder[tok] = len(self.vocab) - 1
            self.decoder[self.encoder[tok]] = tok
            self.special_tokens.append(tok)
            self._bpe_cache[tok] = tok
            added += 1
        return added

    def _bpe(self, token: str) -> str:
        """Greedy lowest-rank merging of ``token`` (already byte-mapped), with the
        CLIP ``</w>`` end-of-word marker."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if not token:
            return token
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if best not in self.merge_rank:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        result = " ".join(word)
        self._bpe_cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> [SOT, ...bpe ids..., EOT]."""
        ids = [self.start_of_text]
        text = _clean(text).lower()
        for chunk in pre_tokenize(text, self.special_tokens):
            if chunk in self.special_tokens and chunk in self.encoder:
                ids.append(self.encoder[chunk])
                continue
            mapped = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            ids.extend(self.encoder[piece] for piece in self._bpe(mapped).split(" "))
        ids.append(self.end_of_text)
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return (
            bytearray(self.byte_decoder[ch] for ch in text if ch in self.byte_decoder)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )
