"""OpenAI-compatible HTTP serving front-end.

Port of ``llm_inference_engine_tpu/server.py`` (framework-free apart from
``main``): the same routes, JSON shapes, streaming, ``n``, logprobs, stop
strings, 429 backpressure and ``/metrics``, over the port's scheduler and
engine. The engine runs on an explicit ``--device`` (default ``cuda``;
there is no CPU fallback: without a card ``main`` raises).
``--kv-cache-dtype int8`` serves from an int8 cache or pool.
``--checkpoint`` takes an HF safetensors or reference ``.bin`` directory
or a ``save_params`` ``.npz``; ``--tokenizer`` (default: a checkpoint
directory's own) loads through ``tokenizer.load_tokenizer``, and dummy
weights or a ``.npz`` without ``--tokenizer`` serve ids as text.
``--draft-model`` (with ``--draft-checkpoint`` and ``--num-draft``)
serves through ``SpeculativeScheduler``: the draft is built by
``create_engine`` with the target's ``EngineConfig`` (quantized the same
way), needs the slot layout (``--kv-layout paged`` exits 2), and
``/metrics`` then reports ``llm_spec_acceptance_rate``. The JAX package's
``--platform`` picks a JAX backend and has no counterpart. The server
runs unchanged over a mesh engine (``InferenceEngine(..., mesh=...)``);
:func:`aggregate_metrics` merges the ``/metrics`` of replicas behind a
``RequestRouter``.

The reference's only user surface was a single-user blocking CLI REPL
(user_entry.cpp:9-43). This is the deployable counterpart: an HTTP server
speaking the OpenAI REST dialect over the continuous-batching scheduler —
many concurrent clients multiplex onto the engine's batch slots.

Endpoints:
- ``POST /v1/completions``        prompt in, text out; ``stream: true``
                                  emits SSE chunks per token
- ``POST /v1/chat/completions``   OpenAI message list rendered through the
                                  model's chat template (stateless — the
                                  full conversation arrives per request)
- ``GET /v1/models`` / ``GET /health``

Threading model (engines are single-threaded by design): ONE engine
thread owns the scheduler and loops submit-drain -> step(); HTTP handler
threads only enqueue work and block on per-request token queues fed by the
scheduler's stream callbacks. No framework dependencies — stdlib
http.server with a threading mixin.

    python -m llm_inference_engine_tpu_torch.server --model llama2-7b \
        --dummy-weights --quant int4 --kv-layout paged --auto-prefix-cache \
        --port 8000
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llm_inference_engine_tpu_torch.config import SamplingParams

__all__ = ["LLMServer", "aggregate_metrics", "make_server", "main"]

_STEP_IDLE_SLEEP = 0.002


@dataclasses.dataclass
class _Pending:
    """One HTTP request's bridge into the engine thread."""
    prompt_ids: list
    sampling: SamplingParams
    events: "queue.Queue"           # (token_id | None, request) stream
    request: object = None          # filled by the engine thread


class LLMServer:
    """Engine thread + request bridge. HTTP handlers call ``enqueue`` and
    iterate ``stream_events``; everything engine-side happens on the one
    engine thread."""

    def __init__(self, scheduler, tokenizer, template, model_name: str,
                 max_queue: int = 0):
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.template = template
        self.model_name = model_name
        self.max_queue = max_queue or (
            4 * scheduler.engine.engine_config.max_batch_size)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # serving counters (engine thread writes, /metrics reads)
        self.requests_completed = 0
        self.tokens_generated = 0
        self.ttft_sum = 0.0
        self.e2e_sum = 0.0
        self._submit_q: "queue.Queue[_Pending]" = queue.Queue()
        self._cancel_q: "queue.Queue[_Pending]" = queue.Queue()
        self._ids = itertools.count()
        self._stop = threading.Event()
        self.failure = None             # why the engine thread died, if it did
        self._thread = threading.Thread(target=self._engine_loop,
                                        name="engine", daemon=True)
        from llm_inference_engine_tpu_torch.runtime.chat_template import (
            resolve_stop_ids)
        self._template_stops = tuple(resolve_stop_ids(
            tokenizer, template.stop_strings))

    # -- engine thread -----------------------------------------------------

    def start(self):
        self._thread.start()

    def shutdown(self):
        self._stop.set()
        self._thread.join(timeout=30)

    def _engine_loop(self):
        sched = self.scheduler
        while not self._stop.is_set():
            moved = False
            while True:
                try:
                    p = self._submit_q.get_nowait()
                except queue.Empty:
                    break
                moved = True
                ev = p.events

                def cb(tok, _ev=ev):
                    _ev.put(("token", int(tok)))

                try:
                    p.request = sched.submit(p.prompt_ids, p.sampling,
                                             stream_callback=cb)
                except Exception as e:  # noqa: BLE001 — the engine thread
                    # must survive a bad request (e.g. a non-greedy submit
                    # to a speculative scheduler); surface it as an event
                    ev.put(("error", str(e)))
                    continue
                if p.request.finished:      # rejected at submit
                    ev.put(("done", p.request))
                else:
                    p.request._server_events = ev
            while True:                     # handler-initiated cancels
                try:
                    p = self._cancel_q.get_nowait()
                except queue.Empty:
                    break
                moved = True
                if p.request is not None and sched.cancel(p.request):
                    p.events.put(("done", p.request))
            if sched.has_work:
                try:
                    done = sched.step()
                except BaseException as e:
                    # every waiting handler answers 500 at its next poll
                    # (stream_events) instead of hanging to its timeout
                    self.failure = f"{type(e).__name__}: {e}"
                    raise
                for r in done:
                    self.requests_completed += 1
                    self.tokens_generated += len(r.output_ids)
                    if r.ttft is not None:
                        self.ttft_sum += r.ttft
                    if r.e2e_latency is not None:
                        self.e2e_sum += r.e2e_latency
                    ev = getattr(r, "_server_events", None)
                    if ev is not None:
                        ev.put(("done", r))
                moved = True
            if not moved:
                time.sleep(_STEP_IDLE_SLEEP)

    # -- handler-side API ----------------------------------------------------

    def enqueue(self, prompt_ids, sampling: SamplingParams,
                n: int = 1) -> list[_Pending]:
        """Atomically reserve + enqueue ``n`` requests: either all fit
        under max_queue or none enter (a partial enqueue would leak the
        in-flight reservation of the ones already queued)."""
        with self._inflight_lock:
            if self._inflight + n > self.max_queue:
                raise OverflowError(
                    f"server at capacity ({self.max_queue} in flight)")
            self._inflight += n
        if self._template_stops:
            sampling = dataclasses.replace(
                sampling, stop_token_ids=tuple(
                    set(sampling.stop_token_ids) | set(self._template_stops)))
        out = []
        for _ in range(n):
            p = _Pending(prompt_ids=list(prompt_ids), sampling=sampling,
                         events=queue.Queue())
            self._submit_q.put(p)
            out.append(p)
        return out

    def request_cancel(self, p: _Pending) -> None:
        """Thread-safe cancel (e.g. a stop string matched): routed through
        the engine thread, which owns the scheduler."""
        self._cancel_q.put(p)

    def stream_events(self, p: _Pending, timeout: float = 600.0):
        """Yield ('token', id) then one final terminal event —
        ('done', request) or ('error', message); ('error', ...) too once the
        engine thread has died."""
        deadline = time.monotonic() + timeout
        try:
            while True:
                try:
                    ev = p.events.get(timeout=min(1.0, max(
                        0.0, deadline - time.monotonic())))
                except queue.Empty:
                    if self.failure is not None:
                        ev = ("error", f"engine failed: {self.failure}")
                    elif time.monotonic() < deadline:
                        continue
                    else:
                        raise
                yield ev
                if ev[0] in ("done", "error"):
                    return
        finally:
            with self._inflight_lock:
                self._inflight -= 1

    # -- request plumbing ------------------------------------------------------

    def sampling_from(self, body: dict) -> SamplingParams:
        temperature = float(body.get("temperature", 1.0))
        return SamplingParams(
            temperature=temperature,
            greedy=temperature == 0.0,
            top_p=float(body.get("top_p", 1.0)),
            top_k=int(body.get("top_k", 50)),
            min_p=float(body.get("min_p", 0.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            max_new_tokens=int(body.get("max_tokens",
                                        body.get("max_completion_tokens",
                                                 128))),
            stop_token_ids=tuple(body.get("stop_token_ids", ())))

    def encode_prompt(self, body: dict):
        if "messages" in body:
            text = self.template.render_conversation(body["messages"])
            return self.tokenizer.encode(text,
                                         add_bos=self.template.add_bos)
        prompt = body.get("prompt", "")
        if isinstance(prompt, list):
            if prompt and isinstance(prompt[0], int):
                return list(prompt)           # pre-tokenized
            prompt = "".join(prompt)
        return self.tokenizer.encode(prompt, add_bos=True)

    def decode_delta(self, prev_ids: list, tok: int) -> str:
        try:
            return self.tokenizer.decode_incremental(prev_ids, tok)
        except Exception:
            return ""

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving counters/gauges."""
        sched = self.scheduler
        eng = sched.engine
        lines = [
            "# TYPE llm_requests_completed_total counter",
            f"llm_requests_completed_total {self.requests_completed}",
            "# TYPE llm_tokens_generated_total counter",
            f"llm_tokens_generated_total {self.tokens_generated}",
            "# TYPE llm_ttft_seconds_sum counter",
            f"llm_ttft_seconds_sum {self.ttft_sum:.6f}",
            "# TYPE llm_e2e_latency_seconds_sum counter",
            f"llm_e2e_latency_seconds_sum {self.e2e_sum:.6f}",
            "# TYPE llm_requests_inflight gauge",
            f"llm_requests_inflight {self._inflight}",
            "# TYPE llm_queue_depth gauge",
            f"llm_queue_depth {len(sched.waiting)}",
            "# TYPE llm_active_slots gauge",
            f"llm_active_slots {sched.num_active}",
            "# TYPE llm_batch_slots gauge",
            f"llm_batch_slots {eng.engine_config.max_batch_size}",
        ]
        if getattr(eng, "paged", False):
            total = eng._allocator.num_pages - 1
            lines += [
                "# TYPE llm_kv_pages_free gauge",
                f"llm_kv_pages_free {eng.free_pages}",
                "# TYPE llm_kv_pages_total gauge",
                f"llm_kv_pages_total {total}",
            ]
        if hasattr(sched, "acceptance_rate"):
            lines += [
                "# TYPE llm_spec_acceptance_rate gauge",
                f"llm_spec_acceptance_rate {sched.acceptance_rate:.4f}",
            ]
        if getattr(sched, "auto_prefix", None) is not None:
            ap = sched.auto_prefix
            lines += [
                "# TYPE llm_prefix_cache_hits_total counter",
                f"llm_prefix_cache_hits_total {ap.hits}",
                "# TYPE llm_prefix_cache_misses_total counter",
                f"llm_prefix_cache_misses_total {ap.misses}",
                "# TYPE llm_prefix_tokens_reused_total counter",
                f"llm_prefix_tokens_reused_total {ap.tokens_reused}",
                "# TYPE llm_prefix_cache_pages gauge",
                f"llm_prefix_cache_pages {ap.cached_pages}",
            ]
        return "\n".join(lines) + "\n"

    def prompt_limit(self) -> int:
        """Largest admissible prompt: the scheduler rejects anything at or
        past max_seq_len (and, paged, past the whole pool)."""
        eng = self.scheduler.engine
        limit = eng.engine_config.max_seq_len - 1
        if getattr(eng, "paged", False):
            page = eng.engine_config.page_size
            limit = min(limit, (eng._allocator.num_pages - 1) * page - 1)
        return limit


class _RequestError(Exception):
    """A request the scheduler refused at submit (surfaced as HTTP 400)."""


def _finish_reason(req) -> str:
    return {"eos": "stop", "length": "length", "capacity": "length",
            "cancelled": "cancelled", "rejected": "length"}.get(
        req.finish_reason, req.finish_reason or "stop")


def _parse_stops(body: dict) -> list:
    stops = body.get("stop") or []
    if isinstance(stops, str):
        stops = [stops]
    return [s for s in stops if s]


def _find_stop(text: str, stops: list) -> int | None:
    """Index of the earliest stop-string match in ``text`` (None if no
    match)."""
    best = None
    for s in stops:
        i = text.find(s)
        if i >= 0 and (best is None or i < best):
            best = i
    return best


class _Handler(BaseHTTPRequestHandler):
    server_version = "llm-inference-engine-tpu-torch/1.0"
    protocol_version = "HTTP/1.1"
    llm: LLMServer = None            # set by serve()

    # -- helpers -----------------------------------------------------------

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _json(self, code: int, obj: dict):
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _read_body(self) -> dict:
        n = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw or b"{}")

    # -- endpoints ------------------------------------------------------------

    def do_GET(self):
        if self.path == "/health":
            if self.llm.failure is None:
                self._json(200, {"status": "ok"})
            else:
                self._json(503, {"status": "failed",
                                 "error": self.llm.failure})
        elif self.path == "/metrics":
            data = self.llm.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
        elif self.path == "/v1/models":
            self._json(200, {"object": "list", "data": [
                {"id": self.llm.model_name, "object": "model",
                 "owned_by": "llm-inference-engine-tpu-torch"}]})
        else:
            self._json(404, {"error": {"message": f"no route {self.path}"}})

    def do_POST(self):
        chat = self.path == "/v1/chat/completions"
        if not chat and self.path != "/v1/completions":
            self._json(404, {"error": {"message": f"no route {self.path}"}})
            return
        try:
            body = self._read_body()
            prompt_ids = self.llm.encode_prompt(body)
            sampling = self.llm.sampling_from(body)
            stops = _parse_stops(body)
            n = int(body.get("n") or 1)
        except Exception as e:  # noqa: BLE001 — client error surface
            self._json(400, {"error": {"message": str(e)}})
            return
        limit = self.llm.prompt_limit()
        if len(prompt_ids) > limit:
            # OpenAI-style context-length error instead of a 200 with
            # empty text (scheduler.submit would mark it 'rejected')
            self._json(400, {"error": {
                "message": (f"prompt of {len(prompt_ids)} tokens exceeds "
                            f"the context limit of {limit}"),
                "type": "context_length_exceeded"}})
            return
        if n < 1 or n > 16 or (n > 1 and body.get("stream")):
            self._json(400, {"error": {"message":
                             "n must be 1..16 (and 1 when streaming)"}})
            return

        try:
            pendings = self.llm.enqueue(prompt_ids, sampling, n)
        except OverflowError as e:          # backpressure
            self._json(429, {"error": {"message": str(e),
                                       "type": "overloaded"}})
            return
        rid = f"cmpl-{next(self.llm._ids)}"
        created = int(time.time())

        if body.get("stream"):
            self._stream_response(pendings[0], prompt_ids, rid, created,
                                  chat, stops)
        else:
            self._full_response(pendings, prompt_ids, rid, created, chat,
                                stops,
                                want_logprobs=bool(body.get("logprobs")))

    # -- response shapes ------------------------------------------------------

    def _collect_one(self, pending, prompt_ids, stops):
        """Drain one request: (text, finish_reason, completion_tokens,
        token_texts, token_logprobs) — decoded incrementally with prompt
        context (identical text to streaming mode); stop strings cancel
        generation early and trim. Raises _RequestError on a rejected
        submit."""
        req = None
        text = ""
        pieces: list = []
        seen = list(prompt_ids)
        finish = None
        for kind, val in self.llm.stream_events(pending):
            if kind == "error":
                raise _RequestError(val)
            if kind == "done":
                req = val
                continue
            if finish is not None:      # already stopped; drain the tail
                continue
            delta = self.llm.decode_delta(seen, val)
            text += delta
            pieces.append(delta)
            seen.append(val)
            if stops:
                cut = _find_stop(text, stops)
                if cut is not None:
                    text = text[:cut]
                    finish = "stop"
                    self.llm.request_cancel(pending)
        if finish == "stop":
            # trim the token pieces to exactly the trimmed text so
            # ''.join(logprob tokens) == text even when the stop string
            # landed mid-piece
            kept, total = [], 0
            for pc in pieces:
                if total + len(pc) <= len(text):
                    kept.append(pc)
                    total += len(pc)
                else:
                    if len(text) > total:
                        kept.append(pc[:len(text) - total])
                    break
            pieces = kept
        lps = list(req.token_logprobs[:len(pieces)])
        return (text, finish or _finish_reason(req), len(req.output_ids),
                pieces, lps)

    def _full_response(self, pendings, prompt_ids, rid, created, chat,
                       stops, want_logprobs=False):
        choices = []
        completion_tokens = 0
        results = []
        try:
            for pending in pendings:     # all run concurrently in the
                # engine; collection order does not serialize them
                results.append(self._collect_one(pending, prompt_ids,
                                                 stops))
        except _RequestError as e:
            for p in pendings[len(results) + 1:]:
                for _ in self.llm.stream_events(p):   # drain siblings
                    pass
            self._json(500 if self.llm.failure else 400,
                       {"error": {"message": str(e)}})
            return
        for i, (text, finish, ntok, pieces, lps) in enumerate(results):
            completion_tokens += ntok
            message = ({"message": {"role": "assistant", "content": text}}
                       if chat else {"text": text})
            choice = {**message, "index": i, "finish_reason": finish}
            if want_logprobs:
                if chat:
                    choice["logprobs"] = {"content": [
                        {"token": t, "logprob": l}
                        for t, l in zip(pieces, lps)]}
                else:
                    choice["logprobs"] = {"tokens": pieces,
                                          "token_logprobs": lps}
            choices.append(choice)
        self._json(200, {
            "id": rid, "created": created,
            "object": "chat.completion" if chat else "text_completion",
            "model": self.llm.model_name,
            "choices": choices,
            "usage": {
                "prompt_tokens": len(prompt_ids),
                "completion_tokens": completion_tokens,
                "total_tokens": len(prompt_ids) + completion_tokens}})

    def _stream_response(self, pending, prompt_ids, rid, created, chat,
                         stops=()):
        # peek the first event BEFORE sending stream headers: a rejected
        # submit becomes a clean 400 instead of a broken SSE stream
        events = self.llm.stream_events(pending)
        try:
            first = next(events)
        except StopIteration:
            first = None
        if first is not None and first[0] == "error":
            self._json(500 if self.llm.failure else 400,
                       {"error": {"message": str(first[1])}})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def chunk(payload: dict):
            data = b"data: " + json.dumps(payload).encode() + b"\n\n"
            self.wfile.write(hex(len(data))[2:].encode() + b"\r\n"
                             + data + b"\r\n")
            self.wfile.flush()

        obj = "chat.completion.chunk" if chat else "text_completion"
        seen: list = list(prompt_ids)
        if chat:
            chunk({"id": rid, "object": obj, "created": created,
                   "model": self.llm.model_name,
                   "choices": [{"index": 0, "delta": {"role": "assistant"},
                                "finish_reason": None}]})

        def emit(delta):
            if not delta:
                return
            piece = ({"delta": {"content": delta}} if chat
                     else {"text": delta})
            chunk({"id": rid, "object": obj, "created": created,
                   "model": self.llm.model_name,
                   "choices": [{**piece, "index": 0,
                                "finish_reason": None}]})

        # hold back enough text that a stop string arriving across token
        # boundaries is never partially emitted
        hold = max((len(s) for s in stops), default=1) - 1 if stops else 0
        acc = ""
        finish = "stop"
        stopped = False
        stream = (itertools.chain([first], events) if first is not None
                  else events)
        try:
            for kind, val in stream:
                if kind == "token":
                    if stopped:
                        continue        # drain until the cancel lands
                    acc += self.llm.decode_delta(seen, val)
                    seen.append(val)
                    if stops:
                        cut = _find_stop(acc, stops)
                        if cut is not None:
                            emit(acc[:cut])
                            acc = ""
                            stopped = True
                            self.llm.request_cancel(pending)
                            continue
                    if len(acc) > hold:
                        emit(acc[:len(acc) - hold])
                        acc = acc[len(acc) - hold:]
                else:
                    if not stopped:
                        emit(acc)
                        finish = (_finish_reason(val) if kind == "done"
                                  else "error")
            chunk({"id": rid, "object": obj, "created": created,
                   "model": self.llm.model_name,
                   "choices": [{"index": 0,
                                **({"delta": {}} if chat else {"text": ""}),
                                "finish_reason": finish}]})
            tail = b"data: [DONE]\n\n"
            self.wfile.write(hex(len(tail))[2:].encode() + b"\r\n" + tail
                             + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError,
                ConnectionAbortedError):
            # client went away mid-stream: stop generating for a dead
            # socket (frees the batch slot / pool pages), then drain the
            # SAME event generator until the cancel's 'done' lands
            self.llm.request_cancel(pending)
            for _ in events:
                pass


def aggregate_metrics(texts) -> str:
    """Fleet view of per-replica ``/metrics`` expositions (the DP-router
    deployment: independent replicas behind a request router,
    ``runtime/multihost_scheduler.RequestRouter``; the JAX package's
    function, character for character in its output).

    Counters and resource gauges (inflight, queue depth, free pages)
    ADD across replicas; ratio gauges (``*_rate``) average. TYPE lines
    keep the first-seen declaration; metric order is first-seen."""
    order: list[str] = []
    types: dict[str, str] = {}
    sums: dict[str, float] = {}
    counts: dict[str, int] = {}
    for text in texts:
        for line in text.splitlines():
            if line.startswith("# TYPE "):
                _, _, name, mtype = line.split()
                types.setdefault(name, mtype)
                continue
            if not line.strip() or line.startswith("#"):
                continue
            # exposition sample: name[{labels}] value [timestamp] —
            # labels may contain quoted spaces, so split from the RIGHT;
            # a trailing integer preceded by another number is a
            # timestamp (Prometheus text format)
            parts = line.rsplit(None, 1)
            if len(parts) != 2:
                continue
            name, value = parts
            try:
                fval = float(value)
            except ValueError:
                continue                     # not a sample line: skip
            h2 = name.rsplit(None, 1)
            if len(h2) == 2 and value.lstrip("-+").isdigit():
                try:
                    fval = float(h2[1])      # "name value timestamp"
                    name = h2[0]
                except ValueError:
                    pass                     # name legitimately has space
            if name not in sums:
                order.append(name)
                sums[name] = 0.0
                counts[name] = 0
            sums[name] += fval
            counts[name] += 1
    out = []
    for name in order:
        val = sums[name]
        if name.endswith("_rate") and counts[name]:
            val /= counts[name]
        if name in types:
            out.append(f"# TYPE {name} {types[name]}")
        txt = f"{val:.6f}".rstrip("0").rstrip(".")
        out.append(f"{name} {txt}")
    return "\n".join(out) + "\n"


def make_server(scheduler, tokenizer, template, model_name: str,
                host: str = "127.0.0.1", port: int = 8000,
                max_queue: int = 0):
    """Build (ThreadingHTTPServer, LLMServer); caller starts both."""
    llm = LLMServer(scheduler, tokenizer, template, model_name,
                    max_queue=max_queue)
    handler = type("BoundHandler", (_Handler,), {"llm": llm})
    httpd = ThreadingHTTPServer((host, port), handler)
    return httpd, llm


def main(argv=None) -> int:
    import torch

    from llm_inference_engine_tpu_torch.cli import load_tokenizer_for
    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.runtime.chat_template import (
        get_chat_template, template_for_model)
    from llm_inference_engine_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="llama2-7b")
    ap.add_argument("--checkpoint", default="",
                    help="HF safetensors dir, reference .bin dir or "
                         "save_params .npz")
    ap.add_argument("--tokenizer", default="",
                    help="tokenizer file/dir (json/model/bin); default: "
                         "the checkpoint directory's, else token ids as "
                         "text")
    ap.add_argument("--dummy-weights", action="store_true")
    ap.add_argument("--draft-model", default="",
                    help="enable speculative serving with this draft "
                         "model preset (slot layout only)")
    ap.add_argument("--draft-checkpoint", default="")
    ap.add_argument("--num-draft", type=int, default=4)
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4"])
    ap.add_argument("--kv-cache-dtype", choices=["", "int8"], default="")
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=2048)
    ap.add_argument("--kv-layout", default="slot", choices=["slot", "paged"])
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=0)
    ap.add_argument("--auto-prefix-cache", action="store_true",
                    help="paged only: finished requests donate their page "
                         "chains; matching prompts (e.g. multi-turn chat "
                         "resends) skip their prefill, zero-copy")
    ap.add_argument("--chat-template", default="auto")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to serve on the CPU)")
    if not args.dummy_weights and not args.checkpoint:
        print("either --checkpoint or --dummy-weights is required",
              file=sys.stderr)
        return 2

    if args.draft_model and args.kv_layout == "paged":
        print("--draft-model requires --kv-layout slot", file=sys.stderr)
        return 2

    eng = EngineConfig(max_batch_size=args.max_batch_size,
                       max_seq_len=args.max_seq_len, quant_mode=args.quant,
                       kv_cache_dtype_name=args.kv_cache_dtype,
                       kv_layout=args.kv_layout, page_size=args.page_size,
                       num_pages=args.num_pages)
    engine = create_engine(args.model, args.checkpoint or None, eng,
                           device=device)
    tokenizer = load_tokenizer_for(args.tokenizer, args.checkpoint,
                                   engine.config.vocab_size)
    template = (template_for_model(args.model)
                if args.chat_template == "auto"
                else get_chat_template(args.chat_template))
    eos = getattr(tokenizer, "eos_id", 2)
    if args.draft_model:
        from llm_inference_engine_tpu_torch.runtime.speculative_scheduler \
            import SpeculativeScheduler
        draft = create_engine(args.draft_model,
                              args.draft_checkpoint or None, eng,
                              device=device)
        sched = SpeculativeScheduler(engine, draft, eos_token_id=eos,
                                     num_draft=args.num_draft)
    else:
        sched = ContinuousBatchingScheduler(
            engine, eos_token_id=eos,
            auto_prefix_cache=args.auto_prefix_cache
            and args.kv_layout == "paged")

    httpd, llm = make_server(sched, tokenizer, template, args.model,
                             args.host, args.port)
    llm.start()
    print(f"serving {args.model} on http://{args.host}:{args.port} "
          f"({device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        llm.shutdown()
    return 0

if __name__ == "__main__":
    sys.exit(main())
