"""Inference engine for serving replicas: one CUDA graph per bucket
(counterpart of horovod_tpu/serve/engine.py, whose engine holds one AOT
XLA executable per bucket).

The batch assembler pads every batch to a bucket (serve/batching.py),
so one captured `torch.cuda.CUDAGraph` per (padded batch shape, dtype)
covers every request. `warmup()` runs each bucket once on a side stream
(which builds and loads the hand-written kernels and sets their
attributes) and then captures it; after that the serving hot path
copies the padded batch into the graph's static input, replays the
graph and reads its static output: no kernel is built, no allocation is
made and no Python runs per layer. A capture or a replay that fails
raises `ServeCaptureError` naming the bucket; nothing serves eagerly in
its place on the card.

On the CPU (``device="cpu"``, which the tests ask for) there is nothing
to capture and `infer()` runs the eager forward under
`torch.inference_mode()`.

Observability hooks:

* perfscope: inference runs under the replica's step scope with a
  capture attributed to ``compile`` and the replay and read-back to
  ``device_compute``, so the doctor's perf section attributes serving
  stragglers by phase as it does training ranks.
* flight: each capture is a `serve` event and one count of
  ``horovod_serve_compiles_total`` (a capture on the hot path after
  warmup is a bug worth seeing in a postmortem).
* hvdhlo: each bucket's warm-up call runs under the step recorder
  (analysis/graph.py; the warm-up, never the capture), and
  `hlo_lint()` merges the HVD2xx stamps of the buckets' programs, as
  the JAX engine lints each bucket it compiles (HOROVOD_HLO_LINT=0
  turns it off). A lint that fails never takes the replica down: the
  bucket's stamp holds ``error``.

Loading weights: `InferenceEngine.from_checkpoint` restores the params
subtree of a training checkpoint into the model without building an
optimizer (ckpt.load_params for an AsyncCheckpointer root,
checkpoint.restore_params for a single checkpoint).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from horovod_tpu_torch.common.exceptions import HorovodError


class ServeCaptureError(HorovodError):
    """A bucket's CUDA graph could not be captured or replayed."""


def serve_device(device=None) -> torch.device:
    """The replica's device: None is the card of this process's local
    rank (`cuda:<HOROVOD_LOCAL_RANK>`, as hvd.init() takes it), which
    must exist; "cpu" (or any torch.device) is taken as given."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise HorovodError(
            "serve: no CUDA device is visible; pass device='cpu' to "
            "serve on the host")
    local_rank = int(os.environ.get("HOROVOD_LOCAL_RANK", "0") or 0)
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise HorovodError(
            f"serve: local rank {local_rank} has no GPU of its own: {n} "
            f"visible; start at most {n} replica(s) on this host")
    return torch.device("cuda", local_rank)


class _Captured:
    """One bucket's graph with its static input and output."""

    __slots__ = ("graph", "static_in", "static_out", "seconds")

    def __init__(self, graph, static_in, static_out, seconds):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.seconds = seconds


def _torch_dtype(dtype: Any) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


class InferenceEngine:
    """Wraps ``infer_fn(model, batch) -> outputs`` with one CUDA graph
    per padded batch shape. `batch` is ``(bucket, *item_shape)``;
    outputs keep the batch dimension first so the pool can slice off
    padding rows. `model` (an nn.Module, or anything `infer_fn` reads)
    is moved to `device` (default: this local rank's card) and put in
    eval mode."""

    def __init__(self, infer_fn: Callable[[Any, torch.Tensor], Any],
                 model: Any, name: str = "serve", device=None) -> None:
        self.device = serve_device(device)
        if isinstance(model, torch.nn.Module):
            model = model.to(self.device).eval()
        self.infer_fn = infer_fn
        self.model = model
        self.name = name
        self._graphs: Dict[Tuple, _Captured] = {}  # guarded-by: _lock
        # One memory pool for every bucket's graph: one graph replays at
        # a time and its output is read before the lock is let go, so
        # the graphs may share their activations (warmup captures the
        # largest bucket first, so the smaller ones fit in its memory).
        self._pool = None  # guarded-by: _lock
        # One replay at a time: a bucket's static buffers are shared by
        # every request of that shape.
        self._lock = threading.Lock()
        self.compiles = 0  # graphs captured (none on the CPU)
        # bucket key -> (hvdhlo stamp, recorded warm-up program or None)
        self._lint: Dict[Tuple, Tuple] = {}  # guarded-by: _lock

    # ---------------------------------------------------------- weights
    @classmethod
    def from_checkpoint(cls, path: str,
                        infer_fn: Callable[[Any, torch.Tensor], Any],
                        model: torch.nn.Module, key: str = "params",
                        name: str = "serve",
                        device=None) -> "InferenceEngine":
        """Params-only restore of a training checkpoint into `model`
        (its ``state_dict`` keys; no optimizer state is read, none needs
        to be constructible).

        `path` is either an ``AsyncCheckpointer`` ROOT of
        generation-numbered manifests (ckpt/), whose newest committed
        generation's `key` subtree is read, so a replica can serve
        straight from a live training job's checkpoint root; or a single
        checkpoint directory (checkpoint.save), whose commit marker is
        verified first."""
        from horovod_tpu_torch import ckpt as _ckpt
        from horovod_tpu_torch import checkpoint
        if _ckpt.latest_committed(path) is not None:
            params = _ckpt.load_params(path, key=key)
        else:
            params = checkpoint.restore_params(path, key=key)
        state = {k: torch.as_tensor(v) for k, v in params.items()}
        model.load_state_dict(state)
        return cls(infer_fn, model, name=name, device=device)

    # ---------------------------------------------------------- capture
    @staticmethod
    def _key(shape: Tuple[int, ...], dtype: Any) -> Tuple:
        # np.int32 (the type), dtype('int32'), "int32" and torch.int32
        # all name the same graph
        return (tuple(int(s) for s in shape), _torch_dtype(dtype))

    def compile_for(self, batch_shape: Tuple[int, ...],
                    dtype: Any) -> Optional[_Captured]:
        """Capture (or fetch) the CUDA graph of one padded batch shape.
        None on the CPU, where there is nothing to capture."""
        if self.device.type != "cuda":
            return None
        key = self._key(batch_shape, dtype)
        with self._lock:
            got = self._graphs.get(key)
            if got is None:
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                got, self._lint[key] = self._capture(key, self._pool)
                self._graphs[key] = got
        return got

    def _capture(self, key: Tuple, pool
                 ) -> Tuple[_Captured, Tuple[Dict[str, Any], Any]]:
        """The bucket's graph, and the lint of its recorded warm-up."""
        from horovod_tpu_torch.observability import flight
        from horovod_tpu_torch.profiler import perfscope
        from horovod_tpu_torch.serve import telemetry
        shape, dtype = key
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                static_in = torch.zeros(shape, dtype=dtype,
                                        device=self.device)
                # The first call builds and loads the kernels and sets
                # their attributes, none of which a capture may do. The
                # side stream is the engine's card's: torch.cuda.graph's
                # own default capture stream is made once, on whichever
                # card was current then.
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side):
                    lint = self._warm(key, lambda: self.infer_fn(
                        self.model, static_in))
                torch.cuda.current_stream(self.device).wait_stream(side)
                torch.cuda.synchronize(self.device)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=pool, stream=side):
                    static_out = self.infer_fn(self.model, static_in)
            torch.cuda.synchronize(self.device)
        except Exception as e:
            raise ServeCaptureError(
                f"engine {self.name}: capturing bucket {shape[0]} "
                f"(shape {list(shape)}, {dtype}) failed: "
                f"{type(e).__name__}: {e}") from e
        dt = time.perf_counter() - t0
        perfscope.attribute("compile", dt)
        telemetry.handles()["compiles"].inc()
        self.compiles += 1
        flight.record(
            "serve", f"capture engine={self.name} shape={tuple(shape)} "
                     f"dtype={dtype} seconds={dt:.3f}")
        return _Captured(graph, static_in, static_out, dt), lint

    def warmup(self, item_shape: Tuple[int, ...], dtype: Any,
               buckets) -> None:
        """Capture every bucket so serving never captures in-band. On
        the CPU, run each bucket once (a shape error shows at start-up,
        not on the first request)."""
        for b in sorted(buckets, reverse=True):
            shape = (int(b),) + tuple(item_shape)
            if self.device.type == "cuda":
                self.compile_for(shape, dtype)
            else:
                key = self._key(shape, dtype)
                batch = np.zeros(shape, np.dtype(dtype))
                lint = self._warm(key, lambda: self.infer(batch))
                with self._lock:
                    self._lint[key] = lint

    def capture_seconds(self) -> Dict[int, float]:
        """Seconds each captured bucket took (warm-up call included)."""
        with self._lock:
            return {k[0][0]: g.seconds for k, g in self._graphs.items()}

    def _warm(self, key: Tuple, run: Callable[[], Any]
              ) -> Tuple[Dict[str, Any], Any]:
        """Run a bucket's warm-up call recorded for hvdhlo: (its stamp,
        its program or None)."""
        from horovod_tpu_torch.analysis import graph, hlo
        if not hlo.lint_enabled():
            run()
            return {"skipped": True}, None
        try:
            _, prog = graph.record(run,
                                   path=f"<serve:{self.name}:{key[0][0]}>")
        except Exception as e:
            run()  # the warm-up itself must still happen
            return {"error": f"{type(e).__name__}: {e}"}, None
        try:
            summary = hlo.lint_summary(prog)
            if not summary.get("clean", True):
                from horovod_tpu_torch.observability import flight
                flight.record(
                    "serve", f"hlo_lint engine={self.name} "
                             f"shape={key[0]} findings={summary['count']}")
        except Exception as e:
            summary = {"error": f"{type(e).__name__}: {e}"}
        return summary, prog

    def lint_programs(self) -> Dict[int, Any]:
        """Bucket -> its recorded warm-up program (analysis/hlo.py)."""
        with self._lock:
            return {k[0][0]: p for k, (_, p) in self._lint.items()
                    if p is not None}

    def hlo_lint(self) -> Dict[str, Any]:
        """Merged hvdhlo stamp over every warmed bucket (the JAX engine's
        keys: count, clean, programs, rules, findings, and truncated
        when findings were cut; error when a bucket's lint failed)."""
        from horovod_tpu_torch.analysis.hlo import _SUMMARY_MAX_FINDINGS
        total = 0
        rules: Dict[str, int] = {}
        findings = []
        errors = []
        with self._lock:
            stamps = [(k, st) for k, (st, _) in self._lint.items()]
        for key, st in stamps:
            total += int(st.get("count", 0) or 0)
            for r, n in (st.get("rules") or {}).items():
                rules[r] = rules.get(r, 0) + n
            findings.extend(st.get("findings") or [])
            if "error" in st:
                errors.append(f"bucket {key[0][0]}: {st['error']}")
        out: Dict[str, Any] = {"count": total, "clean": total == 0,
                               "programs": len(stamps)}
        if rules:
            out["rules"] = rules
            out["findings"] = findings[:_SUMMARY_MAX_FINDINGS]
            if total > len(out["findings"]):
                out["truncated"] = total - len(out["findings"])
        if errors:
            out["error"] = "; ".join(errors)
        return out

    # -------------------------------------------------------------- run
    def infer(self, batch) -> np.ndarray:
        """Run one padded batch (numpy or tensor, ``(bucket,
        *item_shape)``) through its graph and return the outputs on the
        host (perfscope: device_compute)."""
        from horovod_tpu_torch.observability import tracing
        from horovod_tpu_torch.profiler import perfscope
        x = torch.as_tensor(np.asarray(batch)) \
            if not isinstance(batch, torch.Tensor) else batch
        captured = self.compile_for(tuple(x.shape), x.dtype)
        scope = perfscope.get()
        # Ambient-gated trace span: records the device time with the
        # bucket/padded-shape attributes when a sampled trace rode the
        # batch RPC; an untraced call (warmup) records nothing.
        with tracing.span("engine.execute",
                          attrs={"bucket": int(x.shape[0]),
                                 "padded_shape": list(x.shape),
                                 "dtype": str(x.dtype).replace(
                                     "torch.", "")}):
            with scope.phase("device_compute"):
                if captured is None:
                    with torch.inference_mode():
                        out = self.infer_fn(self.model,
                                            x.to(self.device))
                    return out.detach().cpu().numpy()
                return self._replay(captured, x)

    def _replay(self, captured: _Captured, x: torch.Tensor) -> np.ndarray:
        with self._lock:
            try:
                with torch.inference_mode():
                    captured.static_in.copy_(x)
                    captured.graph.replay()
                    out = captured.static_out.to("cpu")
            except Exception as e:
                raise ServeCaptureError(
                    f"engine {self.name}: replaying bucket "
                    f"{captured.static_in.shape[0]} failed: "
                    f"{type(e).__name__}: {e}") from e
        return out.numpy()
