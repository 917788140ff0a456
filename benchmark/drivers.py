"""The two ways traffic drives the program, chosen by a traffic file's
``kind``: a closed-loop sweep (``sweep``) and open-loop serving (``serve``).

``sweep`` is the offline batch run (the program's ``run_batch`` pattern):
chunks of ``batch`` scenes staged by ``FastEditor.stage_inputs`` on a loader
thread, each chunk one ``edit_batch_async`` call with new prompts and a seed
of its own, chunk i's images read back while chunk i + 1 computes.  The
window opens at a readback, once the pipeline runs, and closes at the first
readback ``seconds`` or more later: its edits are those read back after it
opened, its length the time between the two readbacks.

``serve`` sends requests to ``EditService.submit`` on a fixed schedule: a
fixed number of arrivals, ``rate_per_s`` x ``seconds``, whose gaps are the
exponential distribution's quantiles in one order, drawn once from the
traffic file's ``arrival_order_seed`` (the order sets the bursts, and the
tail with them, so every run offers the same schedule), one new scene and
prompt each from the run's seed, and one seed for all, so requests batch as
unseeded ones do.  Each request is timed from when it was due to its image
in hand.  A traced run profiles the last seconds of the arrivals and the
drain of their backlog.

Both warm up exactly the shapes their window uses, before it opens: the
edit's graph keys and the prompt graphs of the padded prompt counts.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from benchmark.device_trace import span

WARM_BASE = 1_000_000  # scene indices of warm-up inputs
WARM_PROMPTS = 150_000  # prompt indices of warm-up prompts
PRE_CHUNKS = 2  # chunks read back before a sweep's window opens


def chunk_seed(seed: int, i: int) -> int:
    return int(np.random.default_rng([seed, 2, i]).integers(2 ** 31))


def edit_kwargs(cfg: dict, traffic: dict) -> dict:
    e = cfg["edit"]
    return dict(negative_prompt=e["negative_prompt"], strength=e["strength"],
                num_inference_steps=e["num_inference_steps"],
                guidance_scale=traffic["guidance_scale"],
                controlnet_conditioning_scale=e["controlnet_conditioning_scale"],
                canny_low_threshold=e["canny_low_threshold"],
                canny_high_threshold=e["canny_high_threshold"])


def _warm_prompts(scenes, n: int, cfg_on: bool, first: int) -> list:
    """``n`` prompts whose novel set, with the negative prompt under CFG,
    pads to the same prompt graph as ``n`` new prompts do later."""
    if cfg_on and n > 1:
        p = scenes.prompts(first, n - 1)
        return p + p[-1:]
    return scenes.prompts(first, n)


class Sweep:
    def __init__(self, run):
        self.run = run
        self.editor = run.editor
        self.batch = int(run.traffic["batch"])
        self.kw = edit_kwargs(run.cfg, run.traffic)
        self.cfg_on = self.kw["guidance_scale"] > 1.0
        self.outputs = {}  # chunk index -> PIL images, read back in the window

    def inputs(self, i: int):
        """Chunk ``i``: (scenes, prompts, seed)."""
        s, b = self.run.scenes, self.batch
        return s.images(i * b, b), s.prompts(i * b, b), chunk_seed(self.run.seed, i)

    def warm_up(self) -> None:
        s, b = self.run.scenes, self.batch
        imgs = s.images(WARM_BASE, b)
        self.editor.edit_batch(imgs, _warm_prompts(s, b, self.cfg_on, WARM_PROMPTS),
                               seed=chunk_seed(self.run.seed, WARM_BASE), **self.kw)
        if self.cfg_on and b == 1:  # the first call encoded the negative prompt beside it
            self.editor.edit_batch(imgs, s.prompts(WARM_PROMPTS + 1, 1), seed=1, **self.kw)

    def _stage(self, i: int):
        with span("bench.stage"):
            return self.editor.stage_inputs(self.inputs(i)[0])

    def window(self, seconds: float, trace=None) -> dict:
        """Run the loop; returns the window's readings.  A traced run
        profiles whole chunks a third of the way in: the profiler starts and
        stops on an idle card, with no launch from the loader in flight."""
        ed, sync = self.editor, self.run.synchronize
        dispatch_s, done = [], []
        t_open = t_close = t_prof = None
        profiled = None
        stager = ThreadPoolExecutor(max_workers=1, thread_name_prefix="bench-stage")

        def read(pending):
            nonlocal t_open, t_close
            j, h = pending
            with span("bench.readback"):
                imgs = h.result()
            now = time.perf_counter()
            if t_close is not None:
                return
            if t_open is not None:
                self.outputs[j] = imgs
                done.append(now)
                if now - t_open >= seconds:
                    t_close = now
            elif j + 1 >= PRE_CHUNKS:
                t_open = now
                self.run.mark_open(now)

        def quiesce(pending):
            if pending is not None:
                read(pending)
            staged.result()
            sync()

        try:
            staged = stager.submit(self._stage, 0)
            pending, i = None, 0
            while t_close is None:
                if trace is not None and profiled is None and t_prof is None \
                        and t_open is not None and time.perf_counter() - t_open >= seconds / 3:
                    quiesce(pending)
                    pending, first, t_prof = None, i, time.perf_counter()
                    trace.start()
                inputs = staged.result()
                staged = stager.submit(self._stage, i + 1)
                _, prompts, seed = self.inputs(i)
                with span("bench.dispatch"):
                    t = time.perf_counter()
                    handle = ed.edit_batch_async(inputs, prompts, seed=seed, **self.kw)
                    if t_prof is None:
                        dispatch_s.append(time.perf_counter() - t)
                if pending is not None:
                    read(pending)
                pending, i = (i, handle), i + 1
                if t_prof is not None and (t_close is not None or time.perf_counter() - t_prof
                                           >= self.run.profile_seconds):
                    quiesce(pending)
                    trace.stop()
                    pending, t_prof = None, None
                    profiled = dict(chunks=i - first, edits=self.batch * (i - first))
            if pending is not None:
                pending[1].result()
            staged.result()
            sync()
        finally:
            stager.shutdown(wait=True)
        return dict(window_s=t_close - t_open, edits=self.batch * len(done),
                    attempted=self.batch * len(done), failed=0, dispatch_s=dispatch_s,
                    chunks=len(done), profiled=profiled)

    def close(self) -> None:
        pass

    def sample(self, rng) -> list:
        """The traffic's ``checked`` edits, as whole chunks read back in the
        window drawn by ``rng``: [(scenes uint8 [B, r, r, 3], prompts, seed,
        the program's uint8)]."""
        keys = sorted(self.outputs)
        count = max(1, int(self.run.traffic["checked"]) // self.batch)
        pick = sorted(rng.choice(len(keys), size=min(count, len(keys)), replace=False))
        out = []
        for k in (keys[p] for p in pick):
            imgs, prompts, seed = self.inputs(k)
            got = np.stack([np.asarray(im) for im in self.outputs[k]])
            out.append((imgs, prompts, seed, got))
        return out


def arrival_offsets(order_seed: int, rate: float, seconds: float) -> np.ndarray:
    """Due times in s from the window's start: ``round(rate * seconds)``
    arrivals whose gaps are the exponential's quantiles at the midpoints
    ``(k + 0.5) / n``, in an order drawn from ``order_seed``, scaled to sum
    to ``seconds`` (the last gap runs to the window's end)."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = np.random.default_rng([order_seed, 3]).permutation(gaps) * (seconds / gaps.sum())
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


class Serve:
    def __init__(self, run):
        from fastedit_tpu_torch.serve import EditParams, EditService

        self.run = run
        t = run.traffic
        kw = edit_kwargs(run.cfg, t)
        self.params = EditParams(seed=chunk_seed(run.seed, 0), **kw)
        self.service = EditService(run.editor, max_batch=t["max_batch"],
                                   batch_window_ms=t["batch_window_ms"],
                                   max_queue=t["max_queue"], pad_to_pow2=t["pad_to_pow2"])
        self.cfg_on = kw["guidance_scale"] > 1.0
        self.outputs = {}  # request index -> PIL image, in time
        self._trace = self._start_at = self._rows = None
        self._hist_at = self._hist_span = None
        self._stop_now = False
        self._index, self._batches = {}, []  # prompt -> request; each batch's requests
        self._wrap_dispatch()

    def _wrap_dispatch(self) -> None:
        """The facade's entry as the service's dispatcher calls it, seen
        from the benchmark: a span per call, the requests of each batch
        (by their prompts, distinct for every request), and in a traced run
        the profiler started there, before a call, on a synchronised card
        (starting or stopping it while another thread launches can stall
        that launch), with the service's batch histogram read.  It is
        stopped on the same thread (the profiler's state is the thread's),
        at a sentinel request sent once every request is answered: the stop
        holds the interpreter for seconds (6.3-8.3 s on ~140-165k events of
        an H100 run), which would hold the arrivals back."""
        ed = self.run.editor
        call = ed.edit_batch_async
        self._own = ed.__dict__.get("edit_batch_async")  # a wrapper already there

        def edit_batch_async(images, prompts, **kw):
            if self._stop_now:
                self.run.synchronize()
                self._trace.stop()
                self._hist_span = {k: v - self._hist_at.get(k, 0)
                                   for k, v in self._hist().items()}
                self._trace, self._stop_now = None, False
            real = list(dict.fromkeys(prompts))  # padding repeats the last row
            self._batches.append([self._index.get(p) for p in real])
            if self._trace is not None and self._rows is None \
                    and time.perf_counter() >= self._start_at:
                self.run.synchronize()
                self._hist_at = self._hist()
                self._trace.start()
                self._rows = []
            if self._trace is not None and self._rows is not None:
                self._rows.append((len(real), len(prompts)))
            with span("bench.dispatch"):
                return call(images, prompts, **kw)

        ed.edit_batch_async = edit_batch_async

    def _hist(self) -> dict:
        return dict(self.service.stats()["batch_size_hist"])

    def _shared(self) -> set:
        """The requests that shared their batch with another."""
        return {k for b in self._batches if len(b) > 1 for k in b if k is not None}

    def warm_up(self) -> None:
        """Every padded batch size up to ``max_batch``, in the order that
        captures the prompt graphs the window uses and no other: first one
        request (its prompt and the negative one), then each size."""
        s = self.run.scenes
        sizes = [1]
        while sizes[-1] < self.service.max_batch:
            sizes.append(min(2 * sizes[-1], self.service.max_batch))
        first = WARM_PROMPTS
        for n in ([1] if self.cfg_on else []) + sizes:
            # made before any is sent, so the n arrive within one coalescing window
            payloads = [(Image.fromarray(s.image(WARM_BASE + first + j)), s.prompt(first + j))
                        for j in range(n)]
            futs = [self.service.submit(img, prompt, self.params) for img, prompt in payloads]
            for f in futs:
                f.result()
            first += n

    def window(self, seconds: float, trace=None) -> dict:
        from fastedit_tpu_torch.serve import ServiceOverloaded

        run, svc = self.run, self.service
        offsets = arrival_offsets(int(run.traffic["arrival_order_seed"]),
                                  float(run.traffic["rate_per_s"]), seconds)
        n = len(offsets)
        due = np.zeros(n)
        sent = np.full(n, np.nan)
        finished = np.full(n, np.nan)
        ok = np.zeros(n, dtype=bool)
        hist0 = dict(svc.stats()["batch_size_hist"])
        self._index = {run.scenes.prompt(k): k for k in range(n)}
        self._batches = []
        lock = threading.Lock()

        def record(k):
            def cb(fut):
                t = time.perf_counter()
                with lock:
                    finished[k] = t
                    if fut.exception() is None:
                        ok[k] = True
                        self.outputs[k] = fut.result()
            return cb

        def generate(t0):
            payload = (Image.fromarray(run.scenes.image(0)), run.scenes.prompt(0))
            for k in range(n):
                due[k] = t0 + offsets[k]
                wait = due[k] - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent[k] = time.perf_counter()
                try:
                    svc.submit(payload[0], payload[1], self.params).add_done_callback(record(k))
                except ServiceOverloaded:
                    with lock:
                        finished[k] = np.inf
                if k + 1 < n:
                    payload = (Image.fromarray(run.scenes.image(k + 1)),
                               run.scenes.prompt(k + 1))

        t0 = time.perf_counter()
        run.mark_open(t0)
        gen = threading.Thread(target=generate, args=(t0,), name="bench-arrivals")
        gen.start()
        if trace is not None:
            self._trace, self._start_at = trace, t0 + offsets[-1] - run.profile_seconds
        gen.join()
        deadline = t0 + seconds + 60.0
        while time.perf_counter() < deadline:
            with lock:
                if not np.isnan(finished).any():
                    break
            time.sleep(0.01)
        if self._trace is not None and self._rows is not None:
            self._stop_now = True  # the sentinel's dispatch stops the profiler first
            s = run.scenes
            svc.submit(Image.fromarray(s.image(WARM_BASE)), s.prompt(WARM_PROMPTS),
                       self.params).result()
        self._trace = None
        with lock:
            fin = finished.copy()
            good = ok.copy()
        stats = svc.stats()
        hist = {k: v - hist0.get(k, 0) for k, v in stats["batch_size_hist"].items()}
        late = sent - due
        lat = np.where(good, fin - due, deadline - due)
        return dict(window_s=seconds, attempted=n, failed=int(n - good.sum()),
                    latencies_s=lat.tolist(), lateness_s=late.tolist(), batch_hist=hist,
                    profiled=None if self._rows is None else dict(batches=self._rows,
                                                                  batch_hist=self._hist_span))

    def close(self) -> None:
        """The service stopped and the editor's entry as it was."""
        self.service.close()
        ed = self.run.editor
        if self._own is None:
            del ed.edit_batch_async
        else:
            ed.edit_batch_async = self._own

    def sample(self, rng) -> list:
        """The traffic's ``checked`` answered requests drawn by ``rng``, as
        chunks of up to four: [(scenes, prompts, seed, the program's uint8)].
        Half of them, as far as there are, shared a batch, so that the check
        covers coalescing and the padded keys."""
        keys = sample_keys(rng, sorted(self.outputs), self._shared(),
                           int(self.run.traffic["checked"]))
        s = self.run.scenes
        out = []
        for at in range(0, len(keys), 4):
            ks = keys[at:at + 4]
            out.append((np.stack([s.image(k) for k in ks]), [s.prompt(k) for k in ks],
                        self.params.seed, np.stack([np.asarray(self.outputs[k]) for k in ks])))
        return out


def sample_keys(rng, answered: list, shared: set, count: int) -> list:
    """``count`` of ``answered`` drawn by ``rng``: half from ``shared`` as
    far as it reaches, more where the others run short; sorted."""
    both = sorted(set(answered) & shared)
    alone = sorted(set(answered) - shared)
    count = min(count, len(answered))
    n = min(len(both), max(count // 2, count - len(alone)))
    pick = [both[i] for i in rng.choice(len(both), size=n, replace=False)]
    pick += [alone[i] for i in rng.choice(len(alone), size=count - n, replace=False)]
    return sorted(pick)


KINDS = {"sweep": Sweep, "serve": Serve}
