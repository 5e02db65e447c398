"""Serving: micro-batching inference services + a JSON/HTTP server.

Counterpart of `clip_dplm_tpu/serving.py` with the same routes and JSON:

  GET  /healthz                 -> {"ok": true}
  GET  /v1/stats                -> per-service batcher occupancy stats
  POST /v1/embed    {"sequences": [...]}            -> {"embeddings", "dim"}
  POST /v1/generate {"lengths": [...]} or {"num": N, "length": L}
                                 -> {"sequences": [...], "confidence": [...]}

Services pad every batch to a fixed row count and the token dimension to a
small set of length buckets, so a batch's shape, and with it the attention
kernel it takes, follows from the longest sequence in it. One worker thread
per service coalesces concurrent requests (`MicroBatcher`) and runs one
forward or one sampler call for the group. CLIP-guided generation is not
ported yet: a request with a condition gets the reference's 400 for a
service built without a scorer.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from clip_dplm_tpu_torch.data.protein import detokenize, tokenize_batch
from clip_dplm_tpu_torch.models.dplm import sample


# ---------------------------------------------------------------------------
# request coalescing
# ---------------------------------------------------------------------------


class MicroBatcher:
    """Coalesce single-item requests into device-sized batches.

    `batch_fn(payloads) -> results` is called on ONE worker thread with
    1..max_batch payloads; it must return exactly one result per payload.
    `submit` returns a Future; `__call__` submits and blocks.
    """

    def __init__(
        self,
        batch_fn: Callable[[List[Any]], Sequence[Any]],
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        name: str = "batcher",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self.name = name
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.requests_total = 0
        self.batches_total = 0
        self.errors_total = 0
        self._worker = threading.Thread(
            target=self._run, name=f"{name}-worker", daemon=True)
        self._worker.start()

    def submit(self, payload: Any) -> Future:
        if self._stop.is_set():
            raise RuntimeError(f"{self.name} is closed")
        fut: Future = Future()
        self._queue.put((payload, fut))
        return fut

    def __call__(self, payload: Any, timeout: Optional[float] = None) -> Any:
        return self.submit(payload).result(timeout=timeout)

    def map(self, payloads: Sequence[Any],
            timeout: Optional[float] = None) -> List[Any]:
        futs = [self.submit(p) for p in payloads]
        return [f.result(timeout=timeout) for f in futs]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            b = max(self.batches_total, 1)
            return {
                "name": self.name,
                "requests": self.requests_total,
                "batches": self.batches_total,
                "errors": self.errors_total,
                "mean_batch_size": round(self.requests_total / b, 3),
                "max_batch": self._max_batch,
            }

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._worker.join(timeout=timeout)
        while True:  # fail anything still queued
            try:
                _, fut = self._queue.get_nowait()
            except queue.Empty:
                break
            fut.set_exception(RuntimeError(f"{self.name} closed"))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self._max_wait
            while len(batch) < self._max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            payloads = [p for p, _ in batch]
            try:
                results = self._batch_fn(payloads)
                if len(results) != len(payloads):
                    raise RuntimeError(
                        f"batch_fn returned {len(results)} results for "
                        f"{len(payloads)} payloads")
            except Exception as exc:  # propagate to every caller in the batch
                with self._lock:
                    self.errors_total += 1
                    self.batches_total += 1
                    self.requests_total += len(batch)
                for _, fut in batch:
                    fut.set_exception(exc)
                continue
            with self._lock:
                self.batches_total += 1
                self.requests_total += len(batch)
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)


def _length_buckets(max_len: int, smallest: int = 32) -> List[int]:
    """Power-of-two padded lengths up to max_len."""
    buckets, b = [], smallest
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return buckets


# ---------------------------------------------------------------------------
# embedding service
# ---------------------------------------------------------------------------


class EmbedService:
    """Sequences -> pooled embeddings from an `ESMTower` on its device.

    Batches are padded to `max_batch` rows and the token dimension to the
    smallest length bucket that fits the longest sequence in the group.
    Padding rows/tokens are masked, so results equal a direct forward."""

    def __init__(
        self,
        tower,
        pooling: str = "mean_residues",
        max_len: int = 1024,
        max_batch: int = 32,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
    ):
        self._tower = tower
        self._pooling = pooling
        self._device = tower.device
        self.max_len = max_len
        self.max_batch = max_batch
        self.buckets = sorted(buckets) if buckets else _length_buckets(max_len)
        if self.buckets[-1] < max_len:
            self.buckets.append(max_len)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="embed")

    def embed(self, sequences: Sequence[str],
              timeout: Optional[float] = None) -> np.ndarray:
        """Blocking public API; safe from many threads concurrently."""
        if not sequences:
            raise ValueError("no sequences given")
        return np.stack(self.batcher.map(list(sequences), timeout=timeout))

    def _run_batch(self, seqs: List[str]) -> List[np.ndarray]:
        toks, mask = tokenize_batch(
            list(seqs) + ["L"] * (self.max_batch - len(seqs)),
            max_len=self.max_len, pad_multiple=1)
        S = next(b for b in self.buckets if b >= toks.shape[1])
        if toks.shape[1] < S:
            pad = S - toks.shape[1]
            toks = np.pad(toks, ((0, 0), (0, pad)), constant_values=1)
            mask = np.pad(mask, ((0, 0), (0, pad)))
        with torch.inference_mode():
            emb = self._tower(
                torch.from_numpy(toks).to(self._device),
                torch.from_numpy(mask).to(self._device),
                pooling=self._pooling)
            emb = emb.float().cpu().numpy()
        return list(emb[: len(seqs)])

    def close(self) -> None:
        self.batcher.close()


# ---------------------------------------------------------------------------
# generation service
# ---------------------------------------------------------------------------


class GenerateService:
    """DPLM sampling service: mixed request lengths in one padded batch.

    Every batch runs `sample(batch_size=max_batch, length=max_len,
    lengths=per-row)` with a `torch.Generator` seeded once on the model's
    device. Returns (sequence, mean residue logprob) per request."""

    def __init__(
        self,
        model,
        max_len: int = 126,
        num_steps: Optional[int] = None,
        temperature: float = 1.0,
        max_batch: int = 32,
        max_wait_ms: float = 10.0,
        seed: int = 0,
    ):
        self._model = model
        self.max_len = max_len
        self.max_batch = max_batch
        self._num_steps = num_steps
        self._temperature = temperature
        self._generator = torch.Generator(device=model.device).manual_seed(seed)
        self.batcher = MicroBatcher(
            self._run_batch, max_batch=max_batch,
            max_wait_ms=max_wait_ms, name="generate")

    def generate(self, lengths: Sequence[int],
                 timeout: Optional[float] = None,
                 condition=None, condition_id: Optional[str] = None):
        """Blocking: one generated sequence per requested length; returns
        (sequences, per-sequence mean residue logprob)."""
        for L in lengths:
            if not 1 <= int(L) <= self.max_len:
                raise ValueError(
                    f"length {L} outside [1, {self.max_len}] "
                    f"(service max_len)")
        if condition is not None or condition_id is not None:
            raise ValueError(
                "guided generation not configured: construct "
                "GenerateService with scorer=...")
        out = self.batcher.map([int(L) for L in lengths], timeout=timeout)
        return [s for s, _ in out], [c for _, c in out]

    def _run_batch(self, lengths: List[int]):
        row_lengths = torch.ones((self.max_batch,), dtype=torch.int64)
        row_lengths[: len(lengths)] = torch.as_tensor(lengths)
        toks, conf = sample(
            self._model, self._generator, batch_size=self.max_batch,
            length=self.max_len, num_steps=self._num_steps,
            temperature=self._temperature, lengths=row_lengths)
        toks = toks.cpu().numpy()
        conf = conf.float().cpu().numpy()
        return [(detokenize(toks[i]), float(conf[i, 1: L + 1].mean()))
                for i, L in enumerate(lengths)]

    def close(self) -> None:
        self.batcher.close()


# ---------------------------------------------------------------------------
# HTTP front end
# ---------------------------------------------------------------------------


def make_server(
    embed: Optional[EmbedService] = None,
    generate: Optional[GenerateService] = None,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout: float = 300.0,
) -> ThreadingHTTPServer:
    """Build (not start) a threading HTTP server over the given services.

    Call `.serve_forever()` (blocking) or run it in a thread; `.server_port`
    holds the bound port (useful with port=0)."""

    services = {"embed": embed, "generate": generate}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default; stats endpoint instead
            pass

        def _send(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> Dict[str, Any]:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                return {}
            return json.loads(self.rfile.read(n).decode())

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True})
            elif self.path == "/v1/stats":
                self._send(200, {
                    name: svc.batcher.stats()
                    for name, svc in services.items() if svc is not None
                })
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                req = self._read_json()
            except (ValueError, json.JSONDecodeError) as exc:
                self._send(400, {"error": f"bad JSON: {exc}"})
                return
            try:
                if self.path == "/v1/embed":
                    self._embed(req)
                elif self.path == "/v1/generate":
                    self._generate(req)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except (ValueError, KeyError, TypeError) as exc:
                self._send(400, {"error": str(exc)})
            except Exception as exc:  # device/batch failures
                self._send(500, {"error": str(exc)})

        def _embed(self, req):
            svc = services["embed"]
            if svc is None:
                self._send(503, {"error": "embed service not configured"})
                return
            seqs = req.get("sequences")
            if not isinstance(seqs, list) or not seqs or not all(
                    isinstance(s, str) and s for s in seqs):
                raise ValueError(
                    '"sequences" must be a non-empty list of strings')
            emb = svc.embed(seqs, timeout=request_timeout)
            self._send(200, {"embeddings": emb.tolist(),
                             "dim": int(emb.shape[1])})

        def _generate(self, req):
            svc = services["generate"]
            if svc is None:
                self._send(503, {"error": "generate service not configured"})
                return
            if "lengths" in req:
                lengths = req["lengths"]
                if not isinstance(lengths, list) or not lengths:
                    raise ValueError('"lengths" must be a non-empty list')
            else:
                num = int(req.get("num", 1))
                if not 1 <= num <= 1024:
                    raise ValueError('"num" must be in [1, 1024]')
                lengths = [int(req.get("length", svc.max_len))] * num
            seqs, conf = svc.generate(
                lengths, timeout=request_timeout,
                condition=req.get("condition"),
                condition_id=req.get("condition_id"))
            self._send(200, {"sequences": seqs, "confidence": conf})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server
