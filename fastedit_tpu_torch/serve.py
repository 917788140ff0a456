"""Serving: dynamic request batching and a stdlib HTTP front-end, on one card.

The port of the JAX package's ``serve.py`` and its root CLI (``python -m
fastedit_tpu_torch.serve``), with the same public surface:

  * :class:`EditService` wraps one :class:`~fastedit_tpu_torch.pipeline.
    editor.FastEditor` with a dispatcher thread that coalesces concurrent
    requests with equal :class:`EditParams` into one device batch (within
    ``batch_window_ms``, up to ``max_batch``), and a completer thread that
    waits for each batch's images while the dispatcher enqueues the next
    one: the lag-1 pipeline of the offline sweep (``parallel/batch.py``).
  * :func:`make_http_server` serves it over HTTP (stdlib
    ``ThreadingHTTPServer``): ``POST /v1/edit`` with a base64 image and a
    prompt, ``GET /healthz``, ``GET /stats``.

Batches are padded to a power of two with the last row and the results
sliced, so a bursty mix of requests uses at most ``log2(max_batch) + 1``
batch sizes: on the card each is a CUDA graph key of the editor
(``pipeline/graphs.py``), captured on its first call, with CFG, the number of
run steps and noise tiling (a seeded request at batch > 1) as further parts
of the key.  New prompts are encoded in one replay of the prompt graph of
their padded count.

Requests whose sampler settings differ never share a device batch, so
batching is invisible: a request returns the image it would get alone.
With ``seed=None`` each image of a batch draws its own noise; a seed is
part of the group key, and a seeded batch gives every row that seed's
noise.

On the card the editor's graphs replay from one thread at a time, so only
the dispatcher thread calls the editor (``edit_batch_async``, and
:meth:`EditService.warmup`'s edits, which it runs in its turn); the
completer only waits on the :class:`~fastedit_tpu_torch.pipeline.editor.
PendingEdit`, whose copy of the images into pinned host memory is enqueued
behind the edit, so the next batch's replay cannot overwrite a batch in
flight.  Kernel flags are per thread in the port: the dispatcher runs under
the flags of the thread that built the service, as the JAX package's
process-wide flags would give it.

Where this module departs from the JAX package's, each one a repair of a
hang or a leak:
  * :meth:`EditService.close` fails every queued and in-flight request with
    a shutdown error once its joins time out, so no caller blocked on a
    future waits forever;
  * :meth:`EditService.warmup` runs on the dispatcher thread, queued like a
    request, so it never races a dispatch;
  * a request that times out gets 504, not 500, and its future is
    cancelled, so work still queued for it is dropped;
  * the completion queue holds one batch, and the dispatcher waits for room
    before it forms the next: at most one batch is dispatched ahead of the
    one whose images the completer waits for.

And one departure in what ``GET /stats`` reports: the JAX module's
``latency_ms_mean`` and ``latency_ms_max`` are replaced by summaries of the
records below.

Where a request's time goes (``utils/profiling.py``; ids ``service``,
``request``, ``batch``): ``serve.queue_wait`` from ``submit`` to the
dispatcher taking the request into a batch; then the batch's
``serve.coalesce`` (from its first request taken to the batch closed),
``serve.dispatch`` (``edit_batch_async``; with ``edit``, ``rows`` and
``padded``), ``serve.readback`` (from the hand-off to the completer to the
images in hand, waiting behind the batch before it included) and
``serve.deliver`` (settling the futures).  The dispatcher waits in
``serve.room_wait`` (no room in the completion queue) or ``serve.idle`` (no
request queued).  :meth:`EditService.stats` summarises the recent ones.
"""

from __future__ import annotations

import argparse
import base64
import collections
import concurrent.futures
import dataclasses
import io
import itertools
import json
import sys
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from PIL import Image

from fastedit_tpu_torch.ops import flags
from fastedit_tpu_torch.utils import profiling
from fastedit_tpu_torch.utils.logging import get_logger

log = get_logger("serve")
_SERVICE_IDS, _REQUEST_IDS, _BATCH_IDS = itertools.count(1), itertools.count(1), itertools.count(1)


class ServiceOverloaded(RuntimeError):
    """Raised by :meth:`EditService.submit` when the queue is full.

    Backpressure: the HTTP front-end maps it to 503, so a load balancer
    retries elsewhere instead of stacking work on a busy card."""


@dataclasses.dataclass(frozen=True)
class EditParams:
    """Sampler settings that define a batchable group.

    Two requests may share a device batch iff their EditParams are equal
    (the editor broadcasts these over the whole batch)."""

    negative_prompt: str = ""
    strength: float = 0.80
    num_inference_steps: int = 4
    guidance_scale: float = 1.5
    controlnet_conditioning_scale: float = 0.5
    canny_low_threshold: int = 100
    canny_high_threshold: int = 200
    seed: Optional[int] = None


@dataclasses.dataclass(eq=False)  # hashed by identity: the in-flight set holds items
class _WorkItem:
    future: Future
    image: Optional[Image.Image]
    prompt: str
    params: Optional[EditParams]  # None: ``call`` runs on the dispatcher thread
    submitted_ns: int  # time.perf_counter_ns() at submit
    request: int = 0  # the request's id (0: a call)
    call: Optional[Callable] = None


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def _summary(values: list) -> dict:
    """Count, mean, median and 95th percentile (linear between ranks, as
    ``numpy.percentile``) of ``values``; None where there are none."""
    v, n = sorted(values), len(values)

    def q(p):
        x = p * (n - 1)
        i = int(x)
        return v[i] + (v[min(i + 1, n - 1)] - v[i]) * (x - i)

    if not n:
        return {"count": 0, "mean": None, "p50": None, "p95": None}
    return {"count": n, "mean": round(sum(v) / n, 3), "p50": round(q(0.5), 3),
            "p95": round(q(0.95), 3)}


def _settle(future: Future, result=None, exc: Optional[BaseException] = None) -> None:
    """Resolve ``future`` unless it is resolved already (close() may fail a
    request while the completer delivers it)."""
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
    except concurrent.futures.InvalidStateError:
        pass


class EditService:
    """Dynamic-batching wrapper around one FastEditor.

    Parameters
    ----------
    editor:
        A constructed :class:`FastEditor`.  The service owns its dispatch:
        no other thread may call the editor while the service runs.
    max_batch:
        Largest device batch to form.
    batch_window_ms:
        How long the dispatcher waits for more same-group requests after
        the first one arrives.  0 disables coalescing by waiting (only
        requests already queued batch together).
    max_queue:
        Backpressure bound: ``submit`` raises :class:`ServiceOverloaded`
        when this many requests are already waiting.
    pad_to_pow2:
        Pad batches to the next power of two by repeating the last row
        (results sliced off), so the set of batch sizes is bounded.
    """

    def __init__(
        self,
        editor,
        max_batch: int = 4,
        batch_window_ms: float = 10.0,
        max_queue: int = 256,
        pad_to_pow2: bool = True,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.editor = editor
        self.max_batch = int(max_batch)
        self.batch_window_s = float(batch_window_ms) / 1000.0
        self.max_queue = int(max_queue)
        self.pad_to_pow2 = bool(pad_to_pow2)
        # the constructing thread's kernel flags, which the dispatcher runs under
        self._flags = flags.current()
        self._id = next(_SERVICE_IDS)  # the ``service`` id of its records

        self._q: collections.deque[_WorkItem] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        # Completion queue of (PendingEdit, group, batch id, hand-off ns).  It
        # holds one batch, and the dispatcher waits for room before it forms the
        # next: at most one batch is dispatched ahead of the one the completer
        # waits for.
        self._cq: collections.deque = collections.deque()
        self._cq_cv = threading.Condition()
        self._cq_capacity = 1
        # requests taken off the queue and not yet resolved, failed by close()
        # if its joins time out
        self._inflight: set = set()

        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "completed": 0,
            "failed": 0,
            "rejected": 0,
            "batches": 0,
            "batch_size_hist": {},
        }

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="edit-dispatch", daemon=True
        )
        self._completer = threading.Thread(
            target=self._complete_loop, name="edit-complete", daemon=True
        )
        self._dispatcher.start()
        self._completer.start()

    # ------------------------------------------------------------- public

    def submit(
        self, image: Image.Image, prompt: str, params: Optional[EditParams] = None
    ) -> Future:
        """Enqueue one edit; returns a Future resolving to the PIL image."""
        params = params or EditParams()
        fut: Future = Future()
        item = _WorkItem(fut, image, str(prompt), params, time.perf_counter_ns(),
                         next(_REQUEST_IDS))
        with self._cv:
            if self._closed:
                raise RuntimeError("EditService is closed")
            if len(self._q) >= self.max_queue:
                with self._stats_lock:
                    self._stats["rejected"] += 1
                raise ServiceOverloaded(
                    f"queue full ({self.max_queue} requests waiting)"
                )
            self._q.append(item)
            with self._stats_lock:
                self._stats["requests"] += 1
            self._cv.notify_all()
        return fut

    def edit(
        self,
        image: Image.Image,
        prompt: str,
        params: Optional[EditParams] = None,
        timeout: Optional[float] = None,
    ) -> Image.Image:
        """Synchronous convenience wrapper over :meth:`submit`."""
        return self.submit(image, prompt, params).result(timeout=timeout)

    def stats(self) -> dict:
        """Counts, the batch-size histogram, the queue's depth; over the
        recent requests that the records hold, ``queue_wait_ms`` (a
        request's), ``dispatch_ms`` and ``readback_ms`` (a batch's) and
        ``latency_ms`` (a request's, submit to its batch delivered), each
        ``{count, mean, p50, p95}``; the process's graph captures and
        evictions."""
        with self._stats_lock:
            s = dict(self._stats)
            s["batch_size_hist"] = dict(s["batch_size_hist"])
        with self._cv:
            s["queue_depth"] = sum(it.call is None for it in self._q)
        mine = [r for r in profiling.records(("serve.queue_wait", "serve.dispatch",
                                              "serve.readback", "serve.deliver"))
                if r.ids.get("service") == self._id]
        ms = {name: [(r.t1_ns - r.t0_ns) / 1e6 for r in mine if r.name == name]
              for name in ("serve.queue_wait", "serve.dispatch", "serve.readback")}
        delivered = {r.ids["batch"]: r.t1_ns for r in mine if r.name == "serve.deliver"}
        s["queue_wait_ms"] = _summary(ms["serve.queue_wait"])
        s["dispatch_ms"] = _summary(ms["serve.dispatch"])
        s["readback_ms"] = _summary(ms["serve.readback"])
        s["latency_ms"] = _summary([(delivered[r.ids["batch"]] - r.t0_ns) / 1e6 for r in mine
                                    if r.name == "serve.queue_wait"
                                    and r.ids["batch"] in delivered])
        counts = profiling.counters()
        s["graph_captures"] = counts.get("graphs.captures", 0)
        s["graph_evictions"] = counts.get("graphs.evictions", 0)
        s["model"] = getattr(self.editor, "model_name", None)
        s["max_batch"] = self.max_batch
        return s

    def warmup(self, batch_sizes=(1,)) -> float:
        """Run one edit at each (padded) batch size, default settings, so the
        first request of each size finds its kernels built and, on the card,
        its CUDA graphs captured.  The edits run on the dispatcher thread,
        queued behind the requests already waiting (no request is taken
        meanwhile), so warmup never races a dispatch.  Returns seconds spent;
        an edit that fails raises here."""
        t0 = time.time()
        r = self.editor.resolution

        def run():
            for b in sorted(set(int(x) for x in batch_sizes)):
                imgs = [Image.new("RGB", (r, r), (128, 128, 128))] * b
                self.editor.edit_batch(imgs, [f"warmup {i}" for i in range(b)])

        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("EditService is closed")
            self._q.append(_WorkItem(fut, None, "", None, time.perf_counter_ns(), call=run))
            self._cv.notify_all()
        fut.result()
        return time.time() - t0

    def close(self, timeout: float = 60.0):
        """Stop accepting work, drain in-flight batches, join the threads.
        Whatever is still unresolved after the joins (a dispatch or a
        readback stuck past ``timeout``) is failed with a shutdown error."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        with self._cq_cv:
            # the dispatcher may wait for completion-queue room; its wait
            # predicate re-checks _closed
            self._cq_cv.notify_all()
        deadline = time.monotonic() + timeout
        self._dispatcher.join(timeout=timeout)
        with self._cq_cv:
            self._cq.append(None)
            self._cq_cv.notify_all()
        self._completer.join(timeout=max(0.0, deadline - time.monotonic()))
        with self._cv:
            leftovers = list(self._q) + list(self._inflight)
            self._q.clear()
            self._inflight.clear()
        if self._dispatcher.is_alive() or self._completer.is_alive():
            log.info("EditService.close: a thread is still busy after %.1f s; failing "
                     "%d unresolved requests", timeout, len(leftovers))
        for it in leftovers:
            _settle(it.future, exc=RuntimeError("EditService closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ internals

    def _taken(self, it: _WorkItem, batch: int) -> None:
        profiling.record("serve.queue_wait", it.submitted_ns, time.perf_counter_ns(),
                         request=it.request, batch=batch, service=self._id)

    def _take_matching_locked(self, key, group: list, batch: int) -> None:
        """Move same-key items from the queue into ``group`` (order kept)."""
        rest: collections.deque = collections.deque()
        while self._q and len(group) < self.max_batch:
            it = self._q.popleft()
            if it.call is None and it.params == key:
                self._taken(it, batch)
                group.append(it)
            else:
                rest.append(it)
        rest.extend(self._q)
        self._q.clear()
        self._q.extend(rest)

    def _dispatch_loop(self):
        with flags.override(**dataclasses.asdict(self._flags)):
            self._dispatch()
        # closed: wake the completer's capacity waiters
        with self._cq_cv:
            self._cq_cv.notify_all()

    def _dispatch(self):
        while True:
            with self._cq_cv:
                if len(self._cq) >= self._cq_capacity and not self._closed:
                    with profiling.span("serve.room_wait", service=self._id):
                        while len(self._cq) >= self._cq_capacity and not self._closed:
                            self._cq_cv.wait()
            with self._cv:
                if not self._q and not self._closed:
                    with profiling.span("serve.idle", service=self._id):
                        while not self._q and not self._closed:
                            self._cv.wait()
                if not self._q:
                    break  # closed and drained
                first = self._q.popleft()
            if first.call is None:
                batch = next(_BATCH_IDS)
                self._taken(first, batch)
            if not first.future.set_running_or_notify_cancel():
                continue  # caller cancelled while queued
            if first.call is not None:
                try:
                    _settle(first.future, first.call())
                except Exception as e:  # handed to the caller
                    _settle(first.future, exc=e)
                continue
            with profiling.span("serve.coalesce", batch=batch, service=self._id):
                group = [first]
                deadline = time.monotonic() + self.batch_window_s
                while len(group) < self.max_batch:
                    with self._cv:
                        self._take_matching_locked(first.params, group, batch)
                        if len(group) >= self.max_batch or self._closed:
                            break
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cv.wait(timeout=remaining)
                live = []
                for it in group:
                    if it is first or it.future.set_running_or_notify_cancel():
                        live.append(it)
                with self._cv:
                    self._inflight.update(live)
            self._run_batch(live, batch)

    def _run_batch(self, group: list, batch: int) -> None:
        p = group[0].params
        images = [it.image for it in group]
        prompts = [it.prompt for it in group]
        n = len(group)
        if self.pad_to_pow2 and n < self.max_batch:
            padded = min(_next_pow2(n), self.max_batch)
            images = images + [images[-1]] * (padded - n)
            prompts = prompts + [prompts[-1]] * (padded - n)
        try:
            with profiling.span("serve.dispatch", batch=batch, rows=n, padded=len(prompts),
                                service=self._id) as ids:
                pending = self.editor.edit_batch_async(
                    images,
                    prompts,
                    negative_prompt=p.negative_prompt,
                    strength=p.strength,
                    num_inference_steps=p.num_inference_steps,
                    guidance_scale=p.guidance_scale,
                    controlnet_conditioning_scale=p.controlnet_conditioning_scale,
                    canny_low_threshold=p.canny_low_threshold,
                    canny_high_threshold=p.canny_high_threshold,
                    seed=p.seed,
                )
                ids["edit"] = getattr(pending, "edit", None)
        except Exception as e:  # dispatch failed: fail the whole group
            log.info("batch dispatch failed: %r", e)
            self._finish(group, batch, exc=e)
            return
        with self._stats_lock:
            self._stats["batches"] += 1
            hist = self._stats["batch_size_hist"]
            hist[str(n)] = hist.get(str(n), 0) + 1
        with self._cq_cv:
            self._cq.append((pending, group, batch, time.perf_counter_ns()))
            self._cq_cv.notify_all()

    def _finish(self, group: list, batch: int, results=None,
                exc: Optional[BaseException] = None) -> None:
        """Resolve ``group``'s futures with ``results`` (one image each) or
        ``exc``, and count them."""
        with profiling.span("serve.deliver", batch=batch, service=self._id):
            with self._stats_lock:
                self._stats["failed" if exc is not None else "completed"] += len(group)
            with self._cv:
                self._inflight.difference_update(group)
            for i, it in enumerate(group):
                _settle(it.future, None if exc is not None else results[i], exc)

    def _complete_loop(self):
        while True:
            with self._cq_cv:
                while not self._cq:
                    self._cq_cv.wait()
                item = self._cq.popleft()
                self._cq_cv.notify_all()
            if item is None:
                return
            pending, group, batch, handed_ns = item
            try:
                results, exc = pending.result(), None
            except Exception as e:
                log.info("batch readback failed: %r", e)
                results, exc = None, e
            profiling.record("serve.readback", handed_ns, time.perf_counter_ns(), batch=batch,
                             service=self._id)
            self._finish(group, batch, results, exc)


# ------------------------------------------------------------------- HTTP


_MAX_BODY_BYTES = 64 * 1024 * 1024


class _EditHandler(BaseHTTPRequestHandler):
    server_version = "fastedit-tpu-torch"
    protocol_version = "HTTP/1.1"

    # ---- helpers

    def _send_json(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through structured logging
        log.debug("%s - %s", self.address_string(), fmt % args)

    # ---- routes

    def do_GET(self):
        svc: EditService = self.server.service  # type: ignore[attr-defined]
        if self.path == "/healthz":
            device = getattr(svc.editor, "device", None)
            self._send_json(
                200,
                {
                    "status": "ok",
                    "model": getattr(svc.editor, "model_name", None),
                    "backend": None if device is None else str(device),
                    "resolution": getattr(svc.editor, "resolution", None),
                },
            )
        elif self.path == "/stats":
            self._send_json(200, svc.stats())
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self):
        if self.path != "/v1/edit":
            self._send_json(404, {"error": f"no route {self.path}"})
            return
        svc: EditService = self.server.service  # type: ignore[attr-defined]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0 or length > _MAX_BODY_BYTES:
                self._send_json(400, {"error": "missing or oversized body"})
                return
            req = json.loads(self.rfile.read(length))
            prompt = req["prompt"]
            image = Image.open(
                io.BytesIO(base64.b64decode(req["image"]))
            ).convert("RGB")
            params = EditParams(
                negative_prompt=str(req.get("negative_prompt", "")),
                strength=float(req.get("strength", 0.80)),
                num_inference_steps=int(req.get("num_inference_steps", 4)),
                guidance_scale=float(req.get("guidance_scale", 1.5)),
                controlnet_conditioning_scale=float(
                    req.get("controlnet_conditioning_scale", 0.5)
                ),
                canny_low_threshold=int(req.get("canny_low_threshold", 100)),
                canny_high_threshold=int(req.get("canny_high_threshold", 200)),
                seed=None if req.get("seed") is None else int(req["seed"]),
            )
            fmt = str(req.get("format", "jpeg")).lower()
            if fmt not in ("jpeg", "png"):
                self._send_json(400, {"error": f"unsupported format {fmt!r}"})
                return
        except Exception as e:
            self._send_json(400, {"error": f"bad request: {e!r}"})
            return

        t0 = time.monotonic()
        try:
            fut = svc.submit(image, prompt, params)
        except ServiceOverloaded as e:
            self._send_json(503, {"error": str(e)})
            return
        timeout = self.server.request_timeout_s  # type: ignore[attr-defined]
        try:
            out = fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            fut.cancel()  # dropped by the dispatcher if it is still queued
            self._send_json(504, {"error": f"edit not done within {timeout} s"})
            return
        except Exception as e:
            self._send_json(500, {"error": f"edit failed: {e!r}"})
            return
        buf = io.BytesIO()
        out.save(buf, format=fmt.upper(), **({"quality": 95} if fmt == "jpeg" else {}))
        self._send_json(
            200,
            {
                "image": base64.b64encode(buf.getvalue()).decode("ascii"),
                "format": fmt,
                "width": out.width,
                "height": out.height,
                "latency_ms": round(1000.0 * (time.monotonic() - t0), 1),
            },
        )


def make_http_server(
    service: EditService,
    host: str = "127.0.0.1",
    port: int = 8000,
    request_timeout_s: float = 600.0,
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server.  ``port=0`` picks a free
    port (``server.server_address[1]`` reports it)."""
    httpd = ThreadingHTTPServer((host, port), _EditHandler)
    httpd.service = service  # type: ignore[attr-defined]
    httpd.request_timeout_s = request_timeout_s  # type: ignore[attr-defined]
    return httpd


# -------------------------------------------------------------------- CLI


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's ``serve.py`` flags, and ``--device`` (default: the
    card; ``cpu`` runs the plain versions on the CPU)."""
    p = argparse.ArgumentParser(
        description="Serve the editor over HTTP with dynamic request batching.",
        epilog="examples: python -m fastedit_tpu_torch.serve --model ssd-1b "
        "--random_weights --warmup (on the card); python -m "
        "fastedit_tpu_torch.serve --model tiny --device cpu (on the CPU); "
        "curl -s localhost:8000/v1/edit -d '{\"image\": \"<base64>\", \"prompt\": \"...\"}'",
    )
    p.add_argument("--model", default="ssd-1b", help="sdxl | ssd-1b | tiny")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument(
        "--random_weights",
        action="store_true",
        help="full architecture with zero weights (latency/shape work)",
    )
    p.add_argument("--full_precision", action="store_true")
    p.add_argument("--full_controlnet", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--batch_window_ms", type=float, default=10.0)
    p.add_argument("--max_queue", type=int, default=256)
    p.add_argument(
        "--warmup",
        action="store_true",
        help="run one edit at every padded batch size before accepting "
        "traffic (builds the kernels and captures the CUDA graphs)",
    )
    p.add_argument("--request_timeout_s", type=float, default=600.0)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; FASTEDIT_PLATFORM=cpu also asks for the CPU")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    from fastedit_tpu_torch import FastEditor, harness

    editor = FastEditor(
        args.model,
        device=harness.entry_device(args.device),
        use_full_precision=args.full_precision,
        use_full_controlnet=args.full_controlnet,
        checkpoint_dir=args.checkpoint_dir,
        random_weights=args.random_weights,
    )
    service = EditService(
        editor,
        max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms,
        max_queue=args.max_queue,
    )
    if args.warmup:
        sizes, b = [], 1
        while b < args.max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(args.max_batch)
        print(f"[serve] warming batch sizes {sizes} ...", flush=True)
        dt = service.warmup(sizes)
        print(f"[serve] warmup done in {dt:.1f}s", flush=True)

    httpd = make_http_server(
        service, args.host, args.port, request_timeout_s=args.request_timeout_s
    )
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} ({editor.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        print("[serve] shutting down", flush=True)
        httpd.server_close()
        service.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
