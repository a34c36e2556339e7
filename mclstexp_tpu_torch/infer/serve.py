"""One-process model server: histology patches -> predicted expression, HTTP.

Port of ``mclstexp_tpu/infer/serve.py``:

* the retrieval database (spot embeddings and expression profiles, phase
  B's key set) is built once and stays on the device across requests;
* queries run the image tower in eval mode, padded with zero patches to a
  power-of-two bucket (eval-mode BatchNorm makes the padding exact, so a
  response does not depend on what else shares its batch);
* prediction is the top-K + inverse-distance aggregation of
  ``ops/retrieval.py`` (the streaming scan past ``STREAMING_SCORE_ELEMENTS``);
* the HTTP layer is the standard library's (``ThreadingHTTPServer``,
  JSON and base64), one thread per request. The service runs all of its
  device work on one worker thread of its own: two requests never
  interleave on the card, and the per-thread caches of the stack (cuDNN's
  execution plans among them) stay warm across requests, where a fresh
  thread per request would start cold every time.

The service counts its predictions on that worker thread (``stats()``,
also under ``"stats"`` in ``GET /info``): requests answered, their rows,
the zero rows of bucket padding, the seconds they waited in the queue and
the seconds the worker spent on them. In a ``torch.profiler`` trace each
prediction is a ``predict`` range around its ``embed`` and ``retrieve``.

Query patches are embedded exactly as sent: the Visium eval path's random
flips and rotations do not apply to a server, which must give the same
patch the same prediction; only the ``raw_scale`` (0-255 input) quirk
carries over.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from torch.profiler import record_function

from mclstexp_tpu_torch.models.mclstexp import MclSTExp
from mclstexp_tpu_torch.ops import augment
from mclstexp_tpu_torch.ops.retrieval import retrieve_and_aggregate


def _bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch: the cap wins even
    where the next power of two overshoots it (``_bucket_size(150, 200) ==
    200``), since ``max_batch`` bounds the memory of one tower call."""
    return min(max_batch, 1 << max(n - 1, 0).bit_length())


def _padded_rows(n: int, max_batch: int) -> int:
    """The zero rows that bucket padding adds to ``n`` patches: the tower
    runs them in chunks of ``max_batch``, and only the last, short chunk is
    padded."""
    rest = n % max_batch
    return _bucket_size(rest, max_batch) - rest if rest else 0


class PredictionService:
    """A model and a device-resident spot database that answer queries.

    ``predict(patches_u8)`` is the reference's inference per query batch:
    image tower -> projection -> cosine top-K -> 1/d^p expression average.
    """

    def __init__(
        self,
        model: MclSTExp,
        key_emb,
        key_expr,
        *,
        top_k: int = 200,
        weight_ord: int = 1,
        raw_scale: bool = False,
        max_batch: int = 256,
        gene_names: Optional[Sequence[str]] = None,
        patch_size: Optional[int] = None,
        key_mask=None,
        device="cuda",
    ):
        self.model = model
        self.device = torch.device(device)
        self.key_emb = torch.as_tensor(key_emb, dtype=torch.float32).to(self.device)
        self.key_expr = torch.as_tensor(key_expr, dtype=torch.float32).to(self.device)
        if self.key_emb.shape[0] != self.key_expr.shape[0]:
            raise ValueError(f"key embeddings ({self.key_emb.shape[0]}) and expressions "
                             f"({self.key_expr.shape[0]}) disagree on database size")
        self.key_mask = None
        n_active = self.num_keys
        if key_mask is not None:
            mask = np.asarray(key_mask, dtype=bool)
            if mask.shape != (self.num_keys,):
                raise ValueError(f"key_mask shape {mask.shape} must be ({self.num_keys},)")
            n_active = int(mask.sum())
            if n_active == 0:
                raise ValueError("key_mask deactivates every database row")
            self.key_mask = torch.from_numpy(mask).to(self.device)
        self.n_active = n_active  # counted once: info() reads no device memory
        self.top_k = min(top_k, n_active)  # K cannot exceed the retrievable rows
        self.weight_ord = weight_ord
        self.raw_scale = raw_scale
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch
        self.gene_names = list(gene_names) if gene_names is not None else None
        # Off-size patches are out of the training distribution: a pinned
        # patch size turns them away with a 400.
        self.patch_size = None if patch_size is None else int(patch_size)
        self._worker = ThreadPoolExecutor(max_workers=1, thread_name_prefix="prediction-service")
        # written on the worker thread, read by stats() from any thread
        self._stats = {"requests": 0, "rows": 0, "padded_rows": 0, "queue_wait_s": 0.0,
                       "worker_s": 0.0}
        self._stats_lock = threading.Lock()

    @classmethod
    def from_sections(cls, model: MclSTExp, sections, *, batch_size: int = 32,
                      exclude_section: Optional[int] = None, device="cuda",
                      **kwargs) -> "PredictionService":
        """Build the database from ``sections``' spot side under ``model``
        (the phase-A spot sweep: B=32 batches, each one attention sequence)
        with their eval-protocol expression profiles.

        ``exclude_section`` masks one section's rows out of retrieval after
        all sections are embedded together, as the LOO protocol does:
        dropping it before the sweep would move the B=32 batch boundaries
        and change every other key's embedding. No patches are needed.
        """
        from mclstexp_tpu_torch.infer import embed

        if exclude_section is not None and not 0 <= exclude_section < len(sections):
            raise ValueError(f"exclude_section {exclude_section} out of range for "
                             f"{len(sections)} sections")
        _, spot = embed.compute_embeddings(model, sections, batch_size, as_device=True,
                                           tower="spot", device=device)
        expr = np.concatenate([s.eval_expression for s in sections], axis=0)
        if exclude_section is not None:
            sizes = [s.num_spots for s in sections]
            mask = np.ones(sum(sizes), bool)
            start = sum(sizes[:exclude_section])
            mask[start:start + sizes[exclude_section]] = False
            kwargs["key_mask"] = mask
        return cls(model, spot, expr, device=device, **kwargs)

    @property
    def num_keys(self) -> int:
        return int(self.key_emb.shape[0])

    @property
    def num_genes(self) -> int:
        return int(self.key_expr.shape[1])

    def _check_patches(self, patches_u8: np.ndarray) -> np.ndarray:
        patches = np.ascontiguousarray(patches_u8)
        if not patches.flags.writeable:  # a decoded request body: torch wants its own copy
            patches = patches.copy()
        if patches.dtype != np.uint8:
            raise ValueError(f"patches must be uint8, got {patches.dtype}")
        if patches.ndim != 4 or patches.shape[-1] != 3:
            raise ValueError(f"patches must be (B, H, W, 3) NHWC uint8, got {patches.shape}")
        if patches.shape[0] == 0:
            raise ValueError("empty batch: need at least one patch")
        if self.patch_size is not None and patches.shape[1:3] != (self.patch_size,) * 2:
            raise ValueError(f"patches must be {self.patch_size}x{self.patch_size} (the "
                             f"model's training patch size), got "
                             f"{patches.shape[1]}x{patches.shape[2]}")
        return patches

    @torch.no_grad()
    def _embed(self, patches: np.ndarray) -> torch.Tensor:
        """(B, P) embeddings on the device (on the worker thread)."""
        was_training = self.model.training
        self.model.eval()
        try:
            out = []
            for start in range(0, patches.shape[0], self.max_batch):
                chunk = patches[start:start + self.max_batch]
                b = chunk.shape[0]
                bucket = _bucket_size(b, self.max_batch)
                x = torch.from_numpy(chunk).to(self.device)
                if b < bucket:
                    x = torch.cat([x, x.new_zeros((bucket - b, *x.shape[1:]))])
                # a contiguous NHWC float batch: channels_last for cuDNN
                x = x.float() if self.raw_scale else augment.to_float(x)
                out.append(self.model.encode_image(x)[:b])
        finally:
            self.model.train(was_training)
        return torch.cat(out)

    def _predict(self, patches: np.ndarray, submitted: float) -> np.ndarray:
        """(B, G) predictions on the worker thread; ``submitted`` is the
        ``time.perf_counter()`` of the ``predict`` call that queued it."""
        start = time.perf_counter()
        with record_function("predict"):
            with record_function("embed"):
                query = self._embed(patches)
            with record_function("retrieve"):
                _, pred = retrieve_and_aggregate(
                    self.key_emb, self.key_expr, query, top_k=self.top_k,
                    weight_ord=self.weight_ord, key_mask=self.key_mask, device=self.device)
        n = patches.shape[0]
        with self._stats_lock:
            stats = self._stats
            stats["requests"] += 1
            stats["rows"] += n
            stats["padded_rows"] += _padded_rows(n, self.max_batch)
            stats["queue_wait_s"] += start - submitted
            stats["worker_s"] += time.perf_counter() - start
        return pred

    def _run_on_worker(self, fn, *args):
        """``fn(*args)`` on the service's device thread, after the work
        queued before it; returns its result or raises its exception."""
        return self._worker.submit(fn, *args).result()

    def embed_patches(self, patches_u8: np.ndarray) -> np.ndarray:
        """(B, P) image-tower embeddings of uint8 NHWC patches (any B)."""
        patches = self._check_patches(patches_u8)
        return self._run_on_worker(lambda: self._embed(patches).cpu().numpy())

    def predict(self, patches_u8: np.ndarray) -> np.ndarray:
        """(B, G) predicted expression for a batch of uint8 NHWC patches."""
        patches = self._check_patches(patches_u8)
        return self._run_on_worker(self._predict, patches, time.perf_counter())

    def close(self) -> None:
        """Stop the worker thread once the requests in flight are answered."""
        self._worker.shutdown(wait=True)

    def stats(self) -> dict:
        """The counters of the predictions answered since the service
        started: ``requests``, their ``rows`` (patches), ``padded_rows``
        (the zero rows of bucket padding the tower ran besides),
        ``queue_wait_s`` (summed seconds from each ``predict`` call to the
        worker's start on it) and ``worker_s`` (summed seconds the worker
        spent on them)."""
        with self._stats_lock:
            return dict(self._stats)

    def info(self) -> dict:
        return {
            "status": "ok",
            "num_keys": self.num_keys,
            "num_active_keys": self.n_active,
            "num_genes": self.num_genes,
            "top_k": self.top_k,
            "weight_ord": self.weight_ord,
            "max_batch": self.max_batch,
            "raw_scale": self.raw_scale,
            "encoder": self.model.config.encoder_name,
            "projection_dim": int(self.key_emb.shape[1]),
            **({"gene_names": self.gene_names} if self.gene_names else {}),
            "stats": self.stats(),
        }


def _decode_patches(payload: dict) -> np.ndarray:
    """Patches from a request body: raw bytes in base64, or nested lists."""
    if "patches_b64" in payload:
        shape = payload.get("shape")
        if not isinstance(shape, list) or len(shape) != 4:
            raise ValueError("patches_b64 requires \"shape\": [B, H, W, 3]")
        raw = base64.b64decode(payload["patches_b64"])
        expected = int(np.prod(shape))
        if len(raw) != expected:
            raise ValueError(f"patches_b64 holds {len(raw)} bytes, shape implies {expected}")
        return np.frombuffer(raw, np.uint8).reshape(shape)
    if "patches" in payload:
        return np.asarray(payload["patches"], dtype=np.uint8)
    raise ValueError("request needs \"patches\" (nested lists) or \"patches_b64\" + \"shape\"")


def _encode_result(arr: np.ndarray, as_b64: bool) -> dict:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if as_b64:
        return {"result_b64": base64.b64encode(arr.tobytes()).decode("ascii"),
                "shape": list(arr.shape), "dtype": "float32"}
    return {"result": arr.tolist(), "shape": list(arr.shape)}


class _Handler(BaseHTTPRequestHandler):
    # the service rides on the server object (see make_server)
    def _reply(self, code: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):  # the default writes a stderr line per request
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):
        if self.path in ("/healthz", "/info"):
            self._reply(200, self.server.service.info())
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.path not in ("/predict", "/embed"):
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            patches = _decode_patches(payload)
            service = self.server.service
            if self.path == "/predict":
                result = service.predict(patches)
            else:
                result = service.embed_patches(patches)
        except (ValueError, KeyError, TypeError) as e:  # JSONDecodeError is a ValueError
            self._reply(400, {"error": str(e)})
            return
        except Exception as e:  # noqa: BLE001: an escape would drop the connection unanswered
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._reply(200, _encode_result(result, bool(payload.get("b64"))))


def make_server(service: PredictionService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """An HTTP server for ``service``; ``port=0`` binds a free port (read it
    from ``server.server_address``). The caller runs ``serve_forever()`` and
    ends it with ``shutdown()`` and ``server_close()``."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.service = service
    return server
