"""Serving: micro-batching inference services + a JSON/HTTP server.

Counterpart of `clip_dplm_tpu/serving.py` with the same routes and JSON:

  GET  /healthz                 -> {"ok": true}
  GET  /v1/stats                -> per-service batcher occupancy stats
  POST /v1/embed    {"sequences": [...]}            -> {"embeddings", "dim"}
  POST /v1/generate {"lengths": [...]} or {"num": N, "length": L}
                                 -> {"sequences": [...], "confidence": [...]}
                    with "condition": [...] or "condition_id": "name"
                                 -> {"sequences", "clip_scores", "guided": true}

Services pad every batch to a fixed row count and the token dimension to a
small set of length buckets, so a batch's shape, and with it the attention
kernel it takes, follows from the longest sequence in it. One worker thread
per service coalesces concurrent requests (`MicroBatcher`) and runs one
forward or one sampler call for the group; CLIP-guided requests coalesce in
a second batcher of the generate service (`generate_guided`).
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
from clip_dplm_tpu_torch.models.dplm import (
    CLS_IDX, EOS_IDX, PAD_IDX, RESIDUE_LO, clip_guided_sample, sample)
from clip_dplm_tpu_torch.models.guided_generation import make_clip_scorer


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
        self.tower = tower
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
            emb = self.tower(
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
    device. Returns (sequence, mean residue logprob) per request.

    Guided mode: with `scorer` (a `(tokens, mask) -> (rows, d)` protein
    embedding function, e.g. the CLIP protein tower) a request may carry a
    conditioning embedding, or the name of one registered in `conditions`
    (name -> (d,) vector); such requests run `clip_guided_sample`,
    best-of-`num_candidates` reranking against each row's condition, in a
    second batcher (`generate_guided`) with a generator of its own, so
    guided and unguided traffic never share a device batch. They return
    (sequence, CLIP score)."""

    def __init__(
        self,
        model,
        max_len: int = 126,
        num_steps: Optional[int] = None,
        temperature: float = 1.0,
        max_batch: int = 32,
        max_wait_ms: float = 10.0,
        seed: int = 0,
        scorer: Optional[Callable] = None,
        num_candidates: int = 4,
        conditions: Optional[Dict[str, Any]] = None,
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
        self.conditions = {k: np.asarray(v, np.float32).reshape(-1)
                           for k, v in (conditions or {}).items()}
        self.scorer = scorer
        self.num_candidates = num_candidates
        self.guided_batcher: Optional[MicroBatcher] = None
        self.condition_dim: Optional[int] = None
        if scorer is not None:
            self.condition_dim = self._scorer_width()
            for name, c in self.conditions.items():
                if c.shape[0] != self.condition_dim:
                    raise ValueError(
                        f"condition {name!r} has width {c.shape[0]}; the scorer "
                        f"embeds to {self.condition_dim}")
            self._guided_generator = torch.Generator(
                device=model.device).manual_seed(seed + 1)
            self.guided_batcher = MicroBatcher(
                self._run_batch_guided, max_batch=max_batch,
                max_wait_ms=max_wait_ms, name="generate_guided")

    def _scorer_width(self) -> int:
        """The scorer's embedding width, from one call at the shape of a
        guided batch (K x max_batch rows of max_len residues)."""
        rows, S = self.num_candidates * self.max_batch, self.max_len + 2
        toks = torch.full((rows, S), RESIDUE_LO, dtype=torch.int64,
                          device=self._model.device)
        toks[:, 0], toks[:, -1] = CLS_IDX, EOS_IDX
        with torch.no_grad():
            return int(self.scorer(toks, toks != PAD_IDX).shape[-1])

    def _resolve_condition(self, condition, condition_id) -> np.ndarray:
        if condition is not None and condition_id is not None:
            raise ValueError("pass either condition or condition_id, not both")
        if condition_id is not None:
            if condition_id not in self.conditions:
                raise ValueError(
                    f"unknown condition_id {condition_id!r}; registered: "
                    f"{sorted(self.conditions)}")
            return self.conditions[condition_id]
        cond = np.asarray(condition, np.float32).reshape(-1)
        if cond.size != self.condition_dim or not np.all(np.isfinite(cond)):
            raise ValueError(
                f"condition must be a finite vector of the scorer's width "
                f"{self.condition_dim}; got {cond.size} values")
        return cond

    def generate(self, lengths: Sequence[int],
                 timeout: Optional[float] = None,
                 condition=None, condition_id: Optional[str] = None):
        """Blocking: one generated sequence per requested length. Unguided:
        (sequences, per-sequence mean residue logprob). With `condition` (a
        (d,) embedding) or `condition_id`: best-of-K CLIP-guided sampling
        toward it, (sequences, per-sequence CLIP scores)."""
        for L in lengths:
            if not 1 <= int(L) <= self.max_len:
                raise ValueError(
                    f"length {L} outside [1, {self.max_len}] "
                    f"(service max_len)")
        lengths = [int(L) for L in lengths]
        if condition is None and condition_id is None:
            out = self.batcher.map(lengths, timeout=timeout)
        else:
            if self.guided_batcher is None:
                raise ValueError(
                    "guided generation not configured: construct "
                    "GenerateService with scorer=...")
            cond = self._resolve_condition(condition, condition_id)
            out = self.guided_batcher.map([(L, cond) for L in lengths], timeout=timeout)
        return [s for s, _ in out], [c for _, c in out]

    def _row_lengths(self, lengths: List[int]) -> torch.Tensor:
        row_lengths = torch.ones((self.max_batch,), dtype=torch.int64)
        row_lengths[: len(lengths)] = torch.as_tensor(lengths)
        return row_lengths

    def _run_batch(self, lengths: List[int]):
        toks, conf = sample(
            self._model, self._generator, batch_size=self.max_batch,
            length=self.max_len, num_steps=self._num_steps,
            temperature=self._temperature, lengths=self._row_lengths(lengths))
        toks = toks.cpu().numpy()
        conf = conf.float().cpu().numpy()
        return [(detokenize(toks[i]), float(conf[i, 1: L + 1].mean()))
                for i, L in enumerate(lengths)]

    def _run_batch_guided(self, payloads: List[Any]):
        # every condition has the scorer's width (_resolve_condition); zero
        # rows (padding) normalize to zero and score 0 everywhere
        cond = np.zeros((self.max_batch, self.condition_dim), np.float32)
        for i, (_, c) in enumerate(payloads):
            cond[i] = c
        toks, scores = clip_guided_sample(
            self._model, self._guided_generator,
            make_clip_scorer(self.scorer, torch.from_numpy(cond)),
            batch_size=self.max_batch, length=self.max_len,
            num_candidates=self.num_candidates, num_steps=self._num_steps,
            temperature=self._temperature,
            lengths=self._row_lengths([L for L, _ in payloads]))
        toks = toks.cpu().numpy()
        scores = scores.float().cpu().numpy()
        return [(detokenize(toks[i]), float(scores[i])) for i in range(len(payloads))]

    def close(self) -> None:
        self.batcher.close()
        if self.guided_batcher is not None:
            self.guided_batcher.close()


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
                stats = {name: svc.batcher.stats()
                         for name, svc in services.items() if svc is not None}
                gen = services["generate"]
                if gen is not None and gen.guided_batcher is not None:
                    stats["generate_guided"] = gen.guided_batcher.stats()
                self._send(200, stats)
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
            condition, condition_id = req.get("condition"), req.get("condition_id")
            seqs, values = svc.generate(lengths, timeout=request_timeout,
                                        condition=condition, condition_id=condition_id)
            if condition is None and condition_id is None:
                self._send(200, {"sequences": seqs, "confidence": values})
            else:
                self._send(200, {"sequences": seqs, "clip_scores": values, "guided": True})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server
