"""Prompt encoding as one padded call: ``FastEditor._encode_prompts``.

The novel prompts of a call, deduplicated, are padded to the next power of
two with the last of them, as the JAX package's ``_encode_prompts_batched``
pads them, on the eager arm (here, on the CPU) as on the card's prompt graph
(``pipeline/graphs.EditGraphs.encode_prompts``).  Held here: the padded
count, padded rows against unpadded ones, the port's padded encode against
the JAX package's on the tiny towers (fp32, rtol = atol = 2e-4, the repo's
golden tolerance), the cache holding copies and not views of the encoder's
outputs (a graph's outputs are overwritten by its next replay), and an fp32
editor encoding without TF32.  The graph itself is held against the eager
arm bit for bit in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""


import jax
import numpy as np
import pytest
import torch

from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.models import configs as TC
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.pipeline import graphs, stages
from fastedit_tpu_torch.tools import from_jax

TOL = 2e-4


@pytest.fixture(scope="module")
def editor():
    return FastEditor("tiny", device="cpu", use_full_precision=True)


@pytest.fixture
def counts(monkeypatch):
    """The batch of every call of ``stages.encode_prompt``."""
    seen = []
    orig = stages.encode_prompt

    def record(mod, ids_1, ids_2):
        seen.append((ids_1.shape[0], ids_2.shape[0]))
        return orig(mod, ids_1, ids_2)

    monkeypatch.setattr(stages, "encode_prompt", record)
    return seen


@pytest.mark.parametrize("novel,padded", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (6, 8),
                                          (7, 8), (8, 8), (9, 16)])
def test_novel_prompts_pad_to_the_next_power_of_two(editor, counts, novel, padded):
    editor._prompt_cache.clear()
    prompts = [f"prompt {i}" for i in range(novel)]
    editor._encode_prompts(prompts + prompts[:2])  # duplicates add nothing
    assert counts == [(padded, padded)]
    assert list(editor._prompt_cache) == prompts
    editor._encode_prompts(prompts)  # all cached: no call
    assert len(counts) == 1


def test_padded_rows_equal_unpadded_rows(editor):
    prompts = ["a red barn", "a lake at dawn", "an old harbor"]  # padded to 4
    editor._prompt_cache.clear()
    editor._encode_prompts(prompts)
    batched = {p: editor._prompt_cache[p] for p in prompts}
    for p in prompts:
        editor._prompt_cache.clear()
        editor._encode_prompts([p])  # alone: padded count 1
        for got, ref in zip(editor._prompt_cache[p], batched[p]):
            assert got.shape == ref.shape and got.shape[0] == 1
            torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


def test_padded_encode_matches_the_jax_package(tiny_editor_f32):
    """The same five prompts (padded to 8 on both sides) through the JAX tiny
    editor's jitted encoder and the port's, on the same weights."""
    jed = tiny_editor_f32
    ted = FastEditor("tiny", device="cpu", use_full_precision=True)
    for name, cfg in (("text_encoder", TC.TINY_TEXT_ENCODER),
                      ("text_encoder_2", TC.TINY_TEXT_ENCODER_2)):
        params = jax.device_get(getattr(jed.modules, f"{name}_params"))
        getattr(ted.modules, name).load_state_dict(from_jax.clip_text_state_dict(params, cfg))
    prompts = ["a red bicycle", "a snowy street", "a city at night", "", "a red bicycle",
               "an oil painting of a lighthouse"]
    saved = dict(jed._prompt_cache)
    try:
        jed._prompt_cache.clear()
        jed._encode_prompts_batched(prompts)
        want = {p: tuple(np.asarray(t) for t in jed._prompt_cache[p]) for p in prompts}
    finally:
        jed._prompt_cache.clear()
        jed._prompt_cache.update(saved)
    ted._encode_prompts(prompts)
    assert list(ted._prompt_cache) == list(dict.fromkeys(prompts))
    for p in prompts:
        for got, ref in zip(ted._prompt_cache[p], want[p]):
            np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


class _StubGraphs:
    """Stands in for ``EditGraphs`` on the CPU: encodes eagerly into static
    output buffers of its own, as a graph writes into its capture's."""

    def __init__(self, mod):
        self.mod = mod
        self.calls = []

    def encode_prompts(self, key, ids_1, ids_2, timed, edit=None):
        self.calls.append((key, torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
        with timed("encode_prompt"):
            self.context, self.pooled = stages.encode_prompt(self.mod, ids_1, ids_2)
        return self.context, self.pooled


def test_the_cache_holds_copies_not_views(editor):
    """A later replay overwrites the graph's output buffers: the rows cached
    from an earlier replay must not change."""
    stub = _StubGraphs(editor.modules)
    editor._graphs, editor._prompt_cache = stub, {}
    try:
        editor._encode_prompts(["prompt a", "prompt b", "prompt c"])
        kept = {p: tuple(t.clone() for t in editor._prompt_cache[p]) for p in editor._prompt_cache}
        stub.context.fill_(float("nan"))  # the next replay writes the buffers
        stub.pooled.fill_(float("nan"))
        for p, rows in kept.items():
            for got, ref in zip(editor._prompt_cache[p], rows):
                assert torch.equal(got, ref)
                assert got._base is None and got.untyped_storage().nbytes() == (
                    got.numel() * got.element_size())
        assert [c[0] for c in stub.calls] == [graphs.prompt_key(4)]
    finally:
        editor._graphs, editor._prompt_cache = None, {}


def test_an_fp32_editor_encodes_without_tf32(editor):
    """``bench.py`` calls ``_encode_prompts`` outside an edit: it enters
    ``true_fp32()`` itself, so a prompt graph is never captured with TF32 on,
    and the switches come back afterwards."""
    stub = _StubGraphs(editor.modules)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    editor._graphs, editor._prompt_cache = stub, {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        editor._encode_prompts(["a tf32 prompt"])
        assert stub.calls == [(graphs.prompt_key(1), False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        editor._graphs, editor._prompt_cache = None, {}


def test_eager_arm_under_flags_or_nan_checks(editor, counts):
    """No graph under ``cuda_graphs=False``, ``plain_versions=True`` or the
    NaN checks (a host sync): the eager arm at the same padded count."""
    from fastedit_tpu_torch.utils import profiling

    stub = _StubGraphs(editor.modules)
    editor._graphs = stub
    try:
        for ctx, nan in ((flags.override(cuda_graphs=False), False),
                         (flags.override(plain_versions=True), False),
                         (flags.override(), True)):
            editor._prompt_cache = {}
            profiling.enable_nan_checks(nan)
            with ctx:
                editor._encode_prompts(["x", "y", "z"])
        assert stub.calls == [] and counts == [(4, 4)] * 3
        profiling.enable_nan_checks(False)
        editor._prompt_cache = {}
        editor._encode_prompts(["x", "y", "z"])
        assert len(stub.calls) == 1
    finally:
        profiling.enable_nan_checks(False)
        editor._graphs, editor._prompt_cache = None, {}


def test_prompt_keys_are_their_own_and_carry_the_flags():
    """A prompt key is the padded count alone, apart from every edit key: the
    kernel plan is a constant of each stage and graphs run only with both
    kernel flags at their defaults, so no flag is in a key."""
    keys = {graphs.prompt_key(n) for n in (1, 2, 4, 8)}
    assert keys == {("prompt", n) for n in (1, 2, 4, 8)}
    assert not keys & {graphs.graph_key(n, True, 3, False, 64) for n in (1, 2, 4, 8)}
    with flags.override(cuda_graphs=False, plain_versions=True):
        assert graphs.prompt_key(1) == ("prompt", 1) and not flags.use_cuda_graphs()
