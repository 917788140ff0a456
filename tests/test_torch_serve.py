"""The port's serving layer (``fastedit_tpu_torch/serve.py``) on the CPU.

First the eleven tests of ``tests/test_serve.py`` on the port's tiny fp32
editor, at the same tolerance (2 LSB): coalescing is invisible (a batched
request returns the image it gets alone), groups with different sampler
settings never share a batch, padding slices the results, backpressure and
shutdown behave, and the HTTP routes.  Then what the port changes: the four
repairs of a hang or a leak it does not inherit from the JAX module
(``close()`` with a stuck dispatcher fails every future and returns;
``warmup`` runs on the dispatcher thread and never races a dispatch; a
timed-out request gets 504 and its queued work is cancelled; the completion
queue lets the dispatcher run one batch ahead of the completer, no more),
the dispatcher running under the constructing thread's kernel flags (they
are per thread in the port), ``/healthz`` as valid JSON with the backend a
string, 32 threads submitting at once with none of their requests lost, the
CLI parser against the JAX one, the CLI raising without a card and without
``--device cpu``, and the HTTP contract: the same
requests give the same status codes and JSON keys from the port's server
and the JAX package's, both on tiny CPU editors.  The repairs use a stub
editor whose dispatch or readback blocks on demand.
"""

import base64
import http.client
import io
import json
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from fastedit_tpu_torch import FastEditor
from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.serve import (
    EditParams,
    EditService,
    ServiceOverloaded,
    build_parser,
    make_http_server,
)


def _img(seed=0, size=48):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8))


def _close(a: Image.Image, b: Image.Image, tol=2):
    x = np.asarray(a).astype(np.int16)
    y = np.asarray(b).astype(np.int16)
    assert x.shape == y.shape
    np.testing.assert_allclose(x, y, atol=tol)


@pytest.fixture(scope="module")
def tiny():
    return FastEditor("tiny", device="cpu", use_full_precision=True)


@pytest.fixture(scope="module")
def service(tiny):
    svc = EditService(tiny, max_batch=4, batch_window_ms=300.0)
    yield svc
    svc.close()


def test_single_edit_roundtrip(service, tiny):
    out = service.edit(_img(1), "a red bicycle", timeout=300)
    r = tiny.resolution
    assert out.size == (r, r)
    s = service.stats()
    assert s["completed"] >= 1 and s["failed"] == 0


def test_concurrent_requests_coalesce_into_one_batch(service):
    before = service.stats()["batches"]
    params = EditParams(seed=7)
    futs = [service.submit(_img(i), f"prompt {i}", params) for i in range(4)]
    outs = [f.result(timeout=300) for f in futs]
    assert len(outs) == 4
    after = service.stats()
    assert after["batches"] == before + 1
    assert after["batch_size_hist"].get("4", 0) >= 1


def test_batched_result_matches_solo_result(service, tiny):
    """Coalescing must be invisible: same image whether batched or alone."""
    params = EditParams(seed=11)
    img_a, img_b = _img(21), _img(22)
    futs = [
        service.submit(img_a, "a red bicycle", params),
        service.submit(img_b, "a blue car", params),
    ]
    batched = [f.result(timeout=300) for f in futs]
    solo = [
        tiny.edit(img_a, "a red bicycle", seed=11),
        tiny.edit(img_b, "a blue car", seed=11),
    ]
    for b, s in zip(batched, solo):
        _close(b, s)


def test_different_params_never_share_a_batch(service):
    before = service.stats()["batches"]
    futs = [
        service.submit(_img(1), "p", EditParams(guidance_scale=1.5, seed=1)),
        service.submit(_img(2), "p", EditParams(guidance_scale=2.0, seed=1)),
    ]
    for f in futs:
        f.result(timeout=300)
    assert service.stats()["batches"] == before + 2


def test_padding_slices_results(service):
    """3 requests pad the batch to 4 but return exactly 3 images."""
    params = EditParams(seed=3)
    futs = [service.submit(_img(i), f"q {i}", params) for i in range(3)]
    outs = [f.result(timeout=300) for f in futs]
    assert len(outs) == 3
    assert service.stats()["batch_size_hist"].get("3", 0) >= 1


def test_backpressure_rejects_when_queue_full(tiny):
    svc = EditService(tiny, max_batch=1, max_queue=0)
    try:
        with pytest.raises(ServiceOverloaded):
            svc.submit(_img(), "p")
        assert svc.stats()["rejected"] == 1
    finally:
        svc.close()


def test_close_rejects_new_work(tiny):
    svc = EditService(tiny, max_batch=2)
    svc.close()
    with pytest.raises(RuntimeError):
        svc.submit(_img(), "p")
    svc.close()  # idempotent


# ----------------------------------------------------------------- HTTP


def _serve(svc, request_timeout_s=300.0):
    httpd = make_http_server(svc, "127.0.0.1", 0, request_timeout_s=request_timeout_s)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def http_port(service):
    httpd = _serve(service)
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()


def _request(port, method, path, body=None, raw=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(
            method,
            path,
            body=raw if raw is not None else None if body is None else json.dumps(body),
            headers={"Content-Type": "application/json"},
        )
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _png_b64(img) -> str:
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def test_http_healthz_and_stats(http_port):
    code, body = _request(http_port, "GET", "/healthz")
    assert code == 200 and body["status"] == "ok" and body["model"] == "tiny"
    code, body = _request(http_port, "GET", "/stats")
    assert code == 200 and "batches" in body and "queue_depth" in body


def test_http_edit_roundtrip(http_port, tiny):
    code, body = _request(
        http_port,
        "POST",
        "/v1/edit",
        {"image": _png_b64(_img(5)), "prompt": "a red bicycle", "seed": 4, "format": "png"},
    )
    assert code == 200, body
    out = Image.open(io.BytesIO(base64.b64decode(body["image"])))
    r = tiny.resolution
    assert out.size == (r, r) and body["format"] == "png"
    assert body["latency_ms"] > 0
    # PNG round-trip is lossless: must equal the direct editor result
    direct = tiny.edit(_img(5), "a red bicycle", seed=4)
    _close(out.convert("RGB"), direct)


def test_http_bad_requests(http_port):
    code, body = _request(http_port, "GET", "/nope")
    assert code == 404
    code, body = _request(http_port, "POST", "/v1/edit", {"prompt": "no image"})
    assert code == 400 and "error" in body
    code, body = _request(
        http_port, "POST", "/v1/edit", {"image": "!!notb64", "prompt": "x"}
    )
    assert code == 400


def test_cli_parser_defaults():
    args = build_parser().parse_args([])
    assert args.model == "ssd-1b" and args.max_batch == 4 and args.port == 8000


# ------------------------------------------------- what the port changes


class _Pending:
    def __init__(self, images, gate):
        self.images, self.gate = images, gate

    def result(self):
        self.gate.wait()
        return list(self.images)


class _StubEditor:
    """Returns its input images; a dispatch waits for ``dispatch_gate`` and
    a readback for ``result_gate``.  Records each call's thread, batch and
    kernel flags, and the most calls in the editor at once."""

    model_name, resolution, device = "stub", 8, torch.device("cpu")

    def __init__(self):
        self.dispatch_gate, self.result_gate = threading.Event(), threading.Event()
        self.dispatch_gate.set()
        self.result_gate.set()
        self.calls, self.active, self.most_active = [], 0, 0
        self.lock = threading.Lock()

    def edit_batch_async(self, images, prompts, **kw):
        with self.lock:
            self.active += 1
            self.most_active = max(self.most_active, self.active)
            self.calls.append((threading.current_thread().name, len(images), flags.current()))
        try:
            self.dispatch_gate.wait()
            time.sleep(0.01)
        finally:
            with self.lock:
                self.active -= 1
        return _Pending(images, self.result_gate)

    def edit_batch(self, images, prompts, **kw):
        return self.edit_batch_async(images, prompts, **kw).result()


def _wait_for(cond, timeout=10.0):
    t = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < t, "timed out"
        time.sleep(0.005)


def test_close_with_a_stuck_dispatcher_fails_every_future():
    """The dispatcher hangs in a dispatch: close() still returns within its
    timeout and fails the in-flight and the queued request, so a caller
    blocked on ``result()`` never hangs (the JAX module leaves them)."""
    stub = _StubEditor()
    stub.dispatch_gate.clear()
    svc = EditService(stub, max_batch=1, batch_window_ms=0)
    try:
        stuck = svc.submit(_img(), "a")
        _wait_for(lambda: stub.calls)
        queued = svc.submit(_img(), "b")
        t = time.monotonic()
        svc.close(timeout=0.3)
        assert time.monotonic() - t < 5.0
        for fut in (stuck, queued):
            with pytest.raises(RuntimeError, match="closed"):
                fut.result(timeout=1.0)
    finally:
        stub.dispatch_gate.set()
    time.sleep(0.05)  # the released dispatch's late result is dropped quietly
    assert stuck.exception(timeout=0) is not None


def test_warmup_runs_on_the_dispatcher_and_never_races_a_dispatch():
    stub = _StubEditor()
    stub.dispatch_gate.clear()
    with EditService(stub, max_batch=4, batch_window_ms=0) as svc:
        first = svc.submit(_img(), "held")
        _wait_for(lambda: stub.calls)
        warm = threading.Thread(target=svc.warmup, args=((1, 2, 4),))
        warm.start()
        time.sleep(0.1)
        assert len(stub.calls) == 1  # warmup waits its turn behind the held dispatch
        stub.dispatch_gate.set()
        warm.join(timeout=10)
        assert not warm.is_alive() and first.result(timeout=10)
        assert [c[1] for c in stub.calls] == [1, 1, 2, 4]
        assert {c[0] for c in stub.calls} == {"edit-dispatch"} and stub.most_active == 1
        assert svc.stats()["batches"] == 1 and svc.stats()["requests"] == 1


def test_timeout_gives_504_and_cancels_the_queued_future():
    """A request held behind a slow one: 504 (the JAX module answers 500) and
    its future cancelled, so the dispatcher never runs it."""
    stub = _StubEditor()
    stub.dispatch_gate.clear()
    svc = EditService(stub, max_batch=1, batch_window_ms=0)
    futures = []
    submit = svc.submit

    def recording_submit(*a, **kw):
        futures.append(submit(*a, **kw))
        return futures[-1]

    svc.submit = recording_submit
    httpd = _serve(svc, request_timeout_s=0.3)
    port = httpd.server_address[1]
    try:
        slow = threading.Thread(target=_request, args=(port, "POST", "/v1/edit",
                                                       {"image": _png_b64(_img()), "prompt": "a"}))
        slow.start()
        _wait_for(lambda: stub.calls)
        code, body = _request(port, "POST", "/v1/edit",
                              {"image": _png_b64(_img(1)), "prompt": "b"})
        assert code == 504 and "error" in body
        assert futures[1].cancelled()
        stub.dispatch_gate.set()
        slow.join(timeout=10)
        assert not slow.is_alive()
    finally:
        stub.dispatch_gate.set()
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    assert len(stub.calls) == 1 and svc.stats()["completed"] == 1


def test_the_dispatcher_runs_one_batch_ahead_of_the_completer():
    """The completion queue holds one batch and the dispatcher waits for
    room before it forms the next: while the completer waits for batch 1's
    images, batch 2 is dispatched and batch 3 is not; the requests left
    queued meanwhile coalesce once the completer moves on."""
    stub = _StubEditor()
    stub.result_gate.clear()
    with EditService(stub, max_batch=4, batch_window_ms=0) as svc:
        futs = [svc.submit(_img(), "a", EditParams(seed=i)) for i in range(2)]
        _wait_for(lambda: len(stub.calls) == 2)
        futs += [svc.submit(_img(), "b", EditParams(seed=9)) for _ in range(3)]
        time.sleep(0.2)
        assert len(stub.calls) == 2
        stub.result_gate.set()
        for f in futs:
            f.result(timeout=10)
        assert [c[1] for c in stub.calls] == [1, 1, 4]  # the three queued: one padded batch
        assert svc.stats()["batch_size_hist"] == {"1": 2, "3": 1}


def test_concurrent_submitters_lose_no_request():
    """32 client threads of 10 requests each, three groups of params, the
    interpreter switching threads every microsecond: every request gets its
    own image back, and the counts add up."""
    stub = _StubEditor()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with EditService(stub, max_batch=4, batch_window_ms=1, max_queue=320) as svc:
            def client(i):
                sent = []
                for j in range(10):
                    img = Image.new("RGB", (2, 2), (i, j, 0))
                    sent.append((img, svc.submit(img, f"p {i}", EditParams(seed=i % 3))))
                return [(img, fut.result(timeout=60)) for img, fut in sent]

            with ThreadPoolExecutor(32) as pool:
                results = list(pool.map(client, range(32)))
            s = svc.stats()
    finally:
        sys.setswitchinterval(old)
    assert all(out is img for rows in results for img, out in rows)
    hist = s["batch_size_hist"]
    assert s["requests"] == s["completed"] == 320 and s["failed"] == 0
    assert sum(int(n) * c for n, c in hist.items()) == 320 and sum(hist.values()) == s["batches"]
    assert set(hist) <= {"1", "2", "3", "4"}


def test_the_dispatcher_runs_under_the_constructing_threads_flags():
    stub = _StubEditor()
    with flags.override(use_cuda_attention=False, use_fused_down2=False):
        svc = EditService(stub, max_batch=1)
        expected = flags.current()
    try:
        assert flags.current() == flags.KernelFlags()  # this thread's are back
        svc.edit(_img(), "p", timeout=10)
        svc.warmup((1,))
    finally:
        svc.close()
    assert [c[2] for c in stub.calls] == [expected, expected]
    with EditService(stub, max_batch=1) as plain:
        plain.edit(_img(), "p", timeout=10)
    assert stub.calls[-1][2] == flags.KernelFlags()


def test_healthz_is_json_with_the_backend_as_a_string(http_port):
    conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=60)
    try:
        conn.request("GET", "/healthz")
        body = json.loads(conn.getresponse().read().decode("utf-8"))
    finally:
        conn.close()
    assert body == {"status": "ok", "model": "tiny", "backend": "cpu", "resolution": 64}


def test_cli_parser_has_the_jax_flags_and_defaults_plus_device():
    import serve as jax_cli

    ours = {a.dest: a for a in build_parser()._actions if a.dest != "help"}
    theirs = {a.dest: a for a in jax_cli.build_parser()._actions if a.dest != "help"}
    assert set(ours) == set(theirs) | {"device"}
    for dest, a in theirs.items():
        b = ours[dest]
        assert (b.option_strings, b.default, b.type, b.nargs, b.const) == (
            a.option_strings, a.default, a.type, a.nargs, a.const), dest
    assert ours["device"].default is None
    args = build_parser().parse_args(["--model", "tiny", "--device", "cpu", "--warmup"])
    assert (args.model, args.device, args.warmup) == ("tiny", "cpu", True)


def test_cli_without_device_runs_on_the_card_or_raises(monkeypatch):
    """No ``--device`` and no ``FASTEDIT_PLATFORM=cpu``: the card, and
    without one an error, never the CPU on its own."""
    from fastedit_tpu_torch import serve

    monkeypatch.delenv("FASTEDIT_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--model", "tiny", "--port", "0"])


def test_http_contract_matches_the_jax_server(tiny, tiny_editor_f32):
    """The same requests to the port's server and the JAX package's, each on
    its tiny CPU editor: the same status codes and the same JSON keys."""
    from fastedit_tpu import serve as jax_serve

    ok = {"image": _png_b64(_img(6)), "prompt": "a red bicycle", "seed": 4, "format": "png"}
    requests = [
        ("GET", "/healthz", None, None), ("GET", "/stats", None, None),
        ("GET", "/nope", None, None), ("POST", "/nope", {"prompt": "x"}, None),
        ("POST", "/v1/edit", ok, None),
        ("POST", "/v1/edit", {**ok, "format": "jpeg"}, None),
        ("POST", "/v1/edit", {"prompt": "no image"}, None),
        ("POST", "/v1/edit", {"image": "!!notb64", "prompt": "x"}, None),
        ("POST", "/v1/edit", {**ok, "format": "gif"}, None),
        ("POST", "/v1/edit", None, b"{not json"),
    ]
    answers = {}
    for name, module, editor in (("port", None, tiny), ("jax", jax_serve, tiny_editor_f32)):
        service_cls = EditService if module is None else module.EditService
        server = make_http_server if module is None else module.make_http_server
        svc = service_cls(editor, max_batch=1, batch_window_ms=0)
        full = service_cls(editor, max_batch=1, max_queue=0)
        servers = [server(s, "127.0.0.1", 0, request_timeout_s=300) for s in (svc, full)]
        for httpd in servers:
            threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            port, full_port = (h.server_address[1] for h in servers)
            got = [_request(port, m, path, body, raw) for m, path, body, raw in requests]
            got.append(_request(full_port, "POST", "/v1/edit", ok))
            answers[name] = [(code, sorted(body)) for code, body in got]
            codes = [code for code, _ in got]
            assert codes == [200, 200, 404, 404, 200, 200, 400, 400, 400, 400, 503], (name, got)
        finally:
            for httpd in servers:
                httpd.shutdown()
                httpd.server_close()
            svc.close()
            full.close()
    assert answers["port"] == answers["jax"]
