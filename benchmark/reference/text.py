"""Token ids of the benchmark's prompts, as a CLIP tokenizer over the
synthetic byte vocabulary (no merges) gives them.

The program's random-weight editors tokenize with that vocabulary: every
byte-level character a token of its own, the last character of a word its
end-of-word form, then ``<|startoftext|>`` (id ``vocab - 2``) and
``<|endoftext|>`` (``vocab - 1``) around at most 75 tokens, padded to 77
with the tower's pad id.  The benchmark's prompts are lowercase words of
``a`` to ``z`` joined by single spaces, for which that reduces to the
arithmetic below: the byte-to-unicode table lists ``!`` to ``~`` first, so
character ``c`` is ``ord(c) - 33`` and its end-of-word form 256 more.
"""

from __future__ import annotations

import re

import torch

MAX_LENGTH = 77
_WORD = re.compile(r"[a-z]+")


def encode(text: str, vocab_size: int, pad_id: int | None) -> list:
    ids = []
    for word in text.split(" ") if text else []:
        if not _WORD.fullmatch(word):
            raise ValueError(f"prompt word {word!r} is not lowercase a-z")
        ids += [ord(c) - 33 for c in word[:-1]] + [256 + ord(word[-1]) - 33]
    bos, eos = vocab_size - 2, vocab_size - 1
    full = [bos] + ids[:MAX_LENGTH - 2] + [eos]
    return full + [eos if pad_id is None else pad_id] * (MAX_LENGTH - len(full))


def token_ids(prompts: list, vocab_size: int, pad_id: int | None, device) -> torch.Tensor:
    return torch.tensor([encode(p, vocab_size, pad_id) for p in prompts], dtype=torch.long,
                        device=device)
