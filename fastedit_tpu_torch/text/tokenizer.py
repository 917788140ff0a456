"""First-party CLIP BPE tokenizer (pure Python, no hub downloads).

Replaces the ``transformers`` CLIPTokenizer pair the reference loads
transitively with the diffusers pipeline (SURVEY.md §2.2 E6).  Loads
``vocab.json`` + ``merges.txt`` from a local checkpoint directory (the
offline converter copies them out of the HF snapshot).  Implements the CLIP
scheme: lowercase + whitespace normalization, byte->unicode mapping, BPE
over word pieces with a ``</w>`` end-of-word marker, and
``<|startoftext|> ... <|endoftext|>`` framing padded to 77 tokens.

SDXL detail: tower 1 (ViT-L) pads with the EOS token, tower 2 (OpenCLIP
bigG) pads with token 0 — ``pad_token_id`` is a constructor arg.
"""

from __future__ import annotations

import functools
import json
import os
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte <-> unicode-char mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(a, b) for a, b in zip(word, word[1:])}


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _is_cjk(cp: int) -> bool:
    """CJK Unified Ideographs blocks (BERT BasicTokenizer definition)."""
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _split_words(text: str) -> List[str]:
    r"""CLIP's token-splitting pattern over Unicode general categories.

    The upstream pattern (openai/CLIP simple_tokenizer, used verbatim by
    transformers' CLIPTokenizer) is, in ``regex``-module syntax::

        <\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d
        |[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+

    Python's ``re`` cannot express ``\p{L}``/``\p{N}`` (``\w`` wrongly
    includes ``_``; ``\d`` misses Nl/No number characters like ``½`` or
    ``Ⅻ``), so the alternation is evaluated by hand with
    ``unicodedata.category``: specials and contractions as literals at the
    match position, letter runs, number characters one at a time, and
    greedy everything-else runs that do NOT re-check for specials mid-run
    (matching the regex's greedy semantics).  Input is expected lowercased
    (``_normalize``), mirroring the upstream IGNORECASE + lower() combo.
    """
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch.isspace():
            i += 1
            continue
        if ch == "<":
            sp = next((s for s in _SPECIALS if text.startswith(s, i)), None)
            if sp is not None:
                out.append(sp)
                i += len(sp)
                continue
        elif ch == "'":
            c = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
            if c is not None:
                out.append(c)
                i += len(c)
                continue
        cat = unicodedata.category(ch)[0]
        if cat == "L":
            j = i + 1
            while j < n and unicodedata.category(text[j])[0] == "L":
                j += 1
        elif cat == "N":
            j = i + 1  # numbers split one character at a time
        else:
            j = i + 1
            while j < n and not text[j].isspace() and (
                unicodedata.category(text[j])[0] not in "LN"
            ):
                j += 1
        out.append(text[i:j])
        i = j
    return out


class CLIPTokenizer:
    """CLIP BPE tokenizer reading vocab.json/merges.txt from disk."""

    def __init__(
        self,
        encoder: Dict[str, int],
        merges: List[Tuple[str, str]],
        max_length: int = 77,
        pad_token_id: int | None = None,
    ):
        self.encoder = encoder
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges) if len(m) == 2}
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos_token_id = self.encoder["<|startoftext|>"]
        self.eos_token_id = self.encoder["<|endoftext|>"]
        self.pad_token_id = (
            pad_token_id if pad_token_id is not None else self.eos_token_id
        )
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_files(
        cls, vocab_file: str, merges_file: str, **kw
    ) -> "CLIPTokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # First line of the standard file is a version header.
        merges = [
            tuple(line.split())
            for line in lines
            if line and not line.startswith("#version")
        ]
        return cls(encoder, merges, **kw)

    @classmethod
    def from_dir(cls, path: str, **kw) -> "CLIPTokenizer":
        return cls.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"), **kw
        )

    @classmethod
    def synthetic(
        cls, vocab_size: int = 1000, max_length: int = 77, pad_token_id=None
    ) -> "CLIPTokenizer":
        """In-memory English-ish vocab for the tiny random-weight smoke model
        (bos = vocab_size-2, eos = vocab_size-1; no merges)."""
        chars = list(bytes_to_unicode().values())
        vocab: Dict[str, int] = {}
        for c in chars:
            vocab[c] = len(vocab)
        for c in chars:
            vocab[c + "</w>"] = len(vocab)
        assert len(vocab) <= vocab_size - 2, "vocab_size too small for byte vocab"
        i = 0
        while len(vocab) < vocab_size - 2:
            vocab[f"<unused{i}>"] = len(vocab)
            i += 1
        vocab["<|startoftext|>"] = vocab_size - 2
        vocab["<|endoftext|>"] = vocab_size - 1
        return cls(vocab, [], max_length=max_length, pad_token_id=pad_token_id)

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def _normalize(self, text: str) -> str:
        """Mirror transformers' CLIPTokenizer normalization in its no-ftfy
        configuration — ``BasicTokenizer(strip_accents=False,
        do_split_on_punc=False)`` — which is what the reference stack runs
        (ftfy is not among its requirements): drop NUL/U+FFFD and *every*
        category-C char (Cc/Cf/Co/Cs/Cn — BasicTokenizer's ``_is_control``
        tests ``category.startswith("C")``, so private-use and unassigned
        codepoints are removed too), collapse whitespace, isolate CJK-block
        characters, NFC-normalize, lowercase per whitespace token."""
        cleaned: List[str] = []
        for ch in text:
            cp = ord(ch)
            cat = unicodedata.category(ch)
            if cp in (0, 0xFFFD) or (
                cat.startswith("C") and ch not in "\t\n\r"
            ):
                continue
            if ch in " \t\n\r" or cat == "Zs":
                cleaned.append(" ")
            elif _is_cjk(cp):
                cleaned.append(f" {ch} ")
            else:
                cleaned.append(ch)
        text = unicodedata.normalize("NFC", "".join(cleaned))
        return " ".join(t.lower() for t in text.split())

    def tokenize(self, text: str) -> List[int]:
        """Raw BPE token ids (no surrounding specials, no padding)."""
        ids: List[int] = []
        for token in _split_words(self._normalize(text)):
            if (
                token.startswith("<|")
                and token.endswith("|>")
                and token in self.encoder
            ):
                # Special tokens present literally in the prompt emit their
                # single id (transformers splits added tokens out before
                # BPE) — byte-mapping them would BPE "<|endoftext|>" into
                # ~13 pieces and diverge from the HF oracle.
                ids.append(self.encoder[token])
                continue
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(
                self.encoder[t] for t in self._bpe(token).split(" ")
            )
        return ids

    def encode(self, text: str) -> np.ndarray:
        """[max_length] int32: BOS + tokens (truncated) + EOS + padding."""
        ids = self.tokenize(text)[: self.max_length - 2]
        full = [self.bos_token_id] + ids + [self.eos_token_id]
        full += [self.pad_token_id] * (self.max_length - len(full))
        return np.asarray(full, dtype=np.int32)

    def batch_encode(self, texts: Sequence[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])

    def decode(self, ids: Sequence[int]) -> str:
        # Cut at the first EOS rather than filtering pad ids: bigG's
        # pad_token_id is 0, which is also the legitimate vocab id for
        # '!' — filtering it would silently drop every '!' from decoded
        # text.  Padding only ever appears after EOS, so the cut removes
        # it without touching in-text ids.
        ids = list(ids)
        if self.eos_token_id in ids:
            ids = ids[: ids.index(self.eos_token_id)]
        text = "".join(
            self.decoder[i] for i in ids if i != self.bos_token_id
        )
        byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        raw = bytearray(byte_decoder[c] for c in text if c in byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ").strip()
