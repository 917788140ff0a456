"""Process-wide state that threads and captures share, held on the CPU.

* ``utils/precision.true_fp32`` across threads: data-parallel replicas edit
  on worker threads, and PyTorch's TF32 switches are the process's, so no
  thread's fp32 work may run in TF32 while any thread is inside, and the
  switches come back as they were once every thread has left.
* ``pipeline/graphs.EditGraphs``'s memory rule: before a new capture the
  oldest keys are evicted until the card's memory in use plus the largest
  capture so far fits ``MEMORY_BUDGET`` of the card; where no eviction is
  enough the capture is refused with an error.  Captures are stubs of given
  sizes on a simulated card.
"""

import threading
import types

import pytest
import torch
import torch.nn as nn

from fastedit_tpu_torch.pipeline import graphs
from fastedit_tpu_torch.utils.precision import true_fp32

BACKENDS = torch.backends


def _switches():
    return BACKENDS.cuda.matmul.allow_tf32, BACKENDS.cudnn.allow_tf32


@pytest.fixture
def tf32_on():
    saved = _switches()
    BACKENDS.cuda.matmul.allow_tf32 = BACKENDS.cudnn.allow_tf32 = True
    yield
    BACKENDS.cuda.matmul.allow_tf32, BACKENDS.cudnn.allow_tf32 = saved


def test_true_fp32_holds_tf32_off_while_any_thread_is_inside(tf32_on):
    """A enters, then B; A leaves while B is still inside, then B leaves.
    B must still see TF32 off after A left, and the process must see it on
    again after both left."""
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def thread_a():
        with true_fp32():
            a_in.set()
            assert b_in.wait(10)
            seen["a_inside"] = _switches()
        a_out.set()

    def thread_b():
        assert a_in.wait(10)
        with true_fp32():
            b_in.set()
            assert a_out.wait(10)
            seen["b_after_a_left"] = _switches()

    threads = [threading.Thread(target=f) for f in (thread_a, thread_b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"a_inside": (False, False), "b_after_a_left": (False, False)}
    assert _switches() == (True, True)


def test_true_fp32_nests_and_restores_after_an_error(tf32_on):
    with true_fp32():
        with true_fp32():
            assert _switches() == (False, False)
        assert _switches() == (False, False)
    assert _switches() == (True, True)
    with pytest.raises(RuntimeError):
        with true_fp32():
            raise RuntimeError("inside")
    assert _switches() == (True, True)


class _Inputs:
    def copy_(self, other):
        pass


GIB = 2**30


def _stub_cache(monkeypatch, sizes, total=80 * GIB, base=10 * GIB, budget=0.5):
    """An ``EditGraphs`` whose captures are stubs: key i holds ``sizes[i]``
    bytes, and the simulated card has ``base`` bytes in use besides the live
    captures'.  Returns the cache and the card's in-use bytes at each
    capture."""
    layer = nn.Linear(2, 2)
    mod = types.SimpleNamespace(unet=layer, controlnet=nn.Module(), vae=nn.Module())
    eg = graphs.EditGraphs(mod)
    at_capture = []

    def in_use():
        return base + sum(c.pool_bytes for c in eg.captured.values())

    def capture(inp):
        i = len(at_capture)
        at_capture.append(in_use())
        return graphs.Captured(_Inputs(), {}, latents=None, out=i, pool_bytes=sizes[i])

    monkeypatch.setattr(eg, "_capture", capture)
    monkeypatch.setattr(graphs, "_card_memory", lambda device: (in_use(), total))
    monkeypatch.setattr(graphs, "MEMORY_BUDGET", budget)
    return eg, at_capture


def test_graph_cache_evicts_the_oldest_keys_to_fit_the_memory_budget(monkeypatch):
    """Budget 40 GiB of an 80 GiB card with 10 GiB in use besides the
    graphs: keys of 7, 3, 7, 3, ... GiB.  Before each capture the oldest keys
    go until what is in use plus the largest key so far fits; the count cap
    alone (64) would keep all twelve."""
    sizes = [7 * GIB, 3 * GIB] * 6
    eg, at_capture = _stub_cache(monkeypatch, sizes)
    for i in range(len(sizes)):
        assert eg.run(("key", i), None)[1] == i
        held = sum(c.pool_bytes for c in eg.captured.values())
        assert 10 * GIB + held <= 40 * GIB
    largest = 7 * GIB
    for i, used in enumerate(at_capture):
        assert used + (largest if i else 0) <= 40 * GIB
    # before key 11: 7..10 held 20 GiB after evicting 5 and 6, no more
    assert list(eg.captured) == [("key", i) for i in range(7, 12)]
    assert eg.run(("key", 11), None)[1] == 11 and len(at_capture) == 12  # a replay


def test_graph_cache_refuses_a_capture_that_cannot_fit(monkeypatch):
    """With 35 GiB in use besides the graphs, no eviction makes room for a
    second 7 GiB key under a 40 GiB budget: a clear error, and no capture."""
    eg, at_capture = _stub_cache(monkeypatch, [7 * GIB, 7 * GIB], base=35 * GIB)
    eg.run(("key", 0), None)
    with pytest.raises(RuntimeError, match="CUDA graph cache"):
        eg.run(("key", 1), None)
    assert len(at_capture) == 1 and not eg.captured and eg.pool is None


def test_graph_cache_keeps_every_key_that_fits(monkeypatch):
    eg, _ = _stub_cache(monkeypatch, [GIB] * 20, budget=0.9)
    for i in range(20):
        eg.run(("key", i), None)
    assert list(eg.captured) == [("key", i) for i in range(20)]
