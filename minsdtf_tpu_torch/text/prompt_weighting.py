"""A1111-style long-prompt weighting (LPW), host side.

  - ``(abc)`` x1.1, ``[abc]`` /1.1, ``(abc:w)`` xw, escapes, nested stacking,
    run-merging;
  - tokenization of weighted fragments, with optional textual-inversion
    placeholder tokens prepended;
  - padding to ``(77-2)*m + 2`` and per-chunk BOS/EOT weight handling.

The device work (chunked encode, weighting, mean-preserving rescale) is one call
to ``fused_fn`` (:func:`minsdtf_tpu_torch.models.clip.fused_lpw_encode`).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

_ATTENTION_RE = re.compile(
    r"\\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|\)|]|[^\\()\[\]:]+|:",
    re.X,
)

ROUND_MULTIPLIER = 1.1
SQUARE_MULTIPLIER = 1 / 1.1


def parse_prompt_attention(text: str) -> List[List[Union[str, float]]]:
    r"""Parse A1111 attention syntax into [text, weight] pairs.

    >>> parse_prompt_attention('normal text')
    [['normal text', 1.0]]
    >>> parse_prompt_attention('an (important) word')
    [['an ', 1.0], ['important', 1.1], [' word', 1.0]]
    >>> parse_prompt_attention('(unbalanced')
    [['unbalanced', 1.1]]
    >>> parse_prompt_attention('(unnecessary)(parens)')
    [['unnecessaryparens', 1.1]]
    """
    res: List[List[Union[str, float]]] = []
    round_stack: List[int] = []
    square_stack: List[int] = []

    def scale_from(start: int, multiplier: float):
        for i in range(start, len(res)):
            res[i][1] *= multiplier

    for m in _ATTENTION_RE.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_stack.append(len(res))
        elif tok == "[":
            square_stack.append(len(res))
        elif weight is not None and round_stack:
            scale_from(round_stack.pop(), float(weight))
        elif tok == ")" and round_stack:
            scale_from(round_stack.pop(), ROUND_MULTIPLIER)
        elif tok == "]" and square_stack:
            scale_from(square_stack.pop(), SQUARE_MULTIPLIER)
        else:
            res.append([tok, 1.0])

    for pos in round_stack:
        scale_from(pos, ROUND_MULTIPLIER)
    for pos in square_stack:
        scale_from(pos, SQUARE_MULTIPLIER)
    if not res:
        return [["", 1.0]]
    # merge adjacent runs of equal weight
    merged: List[List[Union[str, float]]] = [res[0]]
    for text_i, w_i in res[1:]:
        if merged[-1][1] == w_i:
            merged[-1][0] += text_i
        else:
            merged.append([text_i, w_i])
    return merged


def tokenize_weighted(
    tokenizer,
    prompts: List[str],
    max_length: int,
    embedding_tokens_count: int = 0,
    embedding_tokens_weight: float = 1.0,
) -> Tuple[List[List[int]], List[List[float]]]:
    """Tokenize weighted fragments; no BOS/EOT/padding yet. Textual-inversion
    placeholder tokens (the BPE of ``*``) are prepended ``embedding_tokens_count``
    times."""
    all_tokens, all_weights = [], []
    truncated = False
    for text in prompts:
        tokens: List[int] = []
        weights: List[float] = []
        if embedding_tokens_count > 0:
            star = tokenizer.encode("*")[1:-1]
            tokens += star * embedding_tokens_count
            weights += [embedding_tokens_weight] * embedding_tokens_count
        for fragment, weight in parse_prompt_attention(text):
            ids = tokenizer.encode(fragment.strip())[1:-1]
            tokens += list(ids)
            weights += [weight] * len(ids)
            if len(tokens) > max_length:
                truncated = True
                break
        if len(tokens) > max_length:
            truncated = True
            tokens, weights = tokens[:max_length], weights[:max_length]
        all_tokens.append(tokens)
        all_weights.append(weights)
    if truncated:
        print("Prompt was truncated; shorten it or raise max_embeddings_multiples.")
    return all_tokens, all_weights


def pad_tokens_and_weights(
    tokens, weights, max_length, bos, eos, pad, no_boseos_middle=True, chunk_length=77
):
    """Wrap with BOS/.../pad/EOT; the weight layout depends on whether chunk
    boundaries keep their BOS/EOT."""
    max_multiples = (max_length - 2) // (chunk_length - 2)
    weights_length = max_length if no_boseos_middle else max_multiples * chunk_length
    for i in range(len(tokens)):
        tokens[i] = [bos] + tokens[i] + [pad] * (max_length - 2 - len(tokens[i])) + [eos]
        if no_boseos_middle:
            weights[i] = [1.0] + weights[i] + [1.0] * (max_length - 1 - len(weights[i]))
        else:
            w: List[float] = []
            if len(weights[i]) == 0:
                w = [1.0] * weights_length
            else:
                for j in range(max_multiples):
                    w.append(1.0)  # chunk BOS
                    w += weights[i][j * (chunk_length - 2): min(len(weights[i]), (j + 1) * (chunk_length - 2))]
                    w.append(1.0)  # chunk EOT
                w += [1.0] * (weights_length - len(w))
            weights[i] = w[:]
    return tokens, weights


def get_weighted_text_embeddings(
    tokenizer,
    fused_fn: Callable,
    prompt: Union[str, List[str]],
    max_embeddings_multiples: int = 4,
    no_boseos_middle: bool = False,
    skip_parsing: bool = False,
    skip_weighting: bool = False,
    model_max_length: int = 77,
    pad_token_id: int = 49407,
    embedding_tokens_count: int = 0,
    embedding_tokens_weight: float = 1.0,
    embedding: Optional[np.ndarray] = None,
):
    """Full LPW entry point: parse -> pad -> ``fused_fn``, which runs the chunked
    encode, the weight multiply and the mean-preserving rescale. Called as
    ``fused_fn(token_array, weight_array_or_None, embedding, embedding_tokens_count,
    no_boseos_middle)``; its result is returned as it is."""
    if embedding_tokens_count > 0 and embedding is None:
        embedding_tokens_count = 0
    max_length = (model_max_length - 2) * max_embeddings_multiples + 2
    if isinstance(prompt, str):
        prompt = [prompt]

    if not skip_parsing:
        tokens, weights = tokenize_weighted(
            tokenizer, prompt, max_length - 2, embedding_tokens_count, embedding_tokens_weight
        )
    else:
        tokens = [tokenizer.encode(p)[1:-1][: max_length - 2] for p in prompt]
        weights = [[1.0] * len(t) for t in tokens]

    longest = max(len(t) for t in tokens)
    max_embeddings_multiples = max(
        1, min(max_embeddings_multiples, (longest - 1) // (model_max_length - 2) + 1)
    )
    max_length = (model_max_length - 2) * max_embeddings_multiples + 2

    tokens, weights = pad_tokens_and_weights(
        tokens,
        weights,
        max_length,
        bos=tokenizer.start_of_text,
        eos=tokenizer.end_of_text,
        pad=pad_token_id,
        no_boseos_middle=no_boseos_middle,
        chunk_length=model_max_length,
    )
    token_array = np.asarray(tokens, dtype=np.int64)
    weighted = not skip_parsing and not skip_weighting
    return fused_fn(
        token_array,
        np.asarray(weights, dtype=np.float32) if weighted else None,
        embedding,
        embedding_tokens_count,
        no_boseos_middle,
    )
