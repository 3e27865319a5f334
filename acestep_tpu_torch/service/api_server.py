"""REST async-job API server on the port's service layer.

Port of `acestep_tpu/service/api_server.py` (the reference's FastAPI surface,
`acestep/api_server.py`, on a stdlib ThreadingHTTPServer): POST a task, get a
task_id and queue position, poll /query_result for status 0 (queued or
running), 1 (succeeded) or 2 (failed). One worker thread takes jobs from a
bounded queue (429 when full), merges compatible queued text2music jobs into
one batch (dynamic batching) and finishes job N (its decode transfer and
save) on a finisher thread while job N+1's compute runs on the card
(pipelining). `/v1/generate_stream` streams one job's PCM as a WAV response
chunk by chunk; `/v1/chat/completions` is the OpenAI-style chat API
(`service/openrouter.py`).

`/v1/lora/{load,unload,toggle,scale,status}` (POST) drive the handler's
adapter registry. `/v1/train/{start,status,export,stop,list,build_dataset}`
(POST) run LoRA training on a thread of its own beside serving, and
`/v1/dataset/*` is the dataset explorer (`service/train_api.py`); the
dataset work that runs the handlers on the card holds `model_lock`, the
training run does not.

`python -m acestep_tpu_torch.service.api_server` starts a server with the
JAX package's arguments (the `acestep-tpu-api` entry point), plus `--device`.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import threading
import time
import traceback
import uuid
# Module-level import: a daemon worker thread that lazily imported this during
# interpreter shutdown hit "can't register atexit after shutdown".
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from acestep_tpu_torch.service.inference import (
    create_sample,
    format_sample,
    generate_music,
    generate_music_merged,
    merge_group_key,
    understand_music,
)
from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams
from acestep_tpu_torch.service.train_api import DatasetService, TrainingService
from acestep_tpu_torch.utils import audio as audio_utils
from acestep_tpu_torch.utils.local_cache import get_cache
from acestep_tpu_torch.utils.logbuffer import install as install_logbuffer
from acestep_tpu_torch.utils.memory_config import RuntimeMemoryConfig, detect_hbm_gb, get_runtime_memory_config
from acestep_tpu_torch.utils.progress import ProgressEstimator

JOB_TTL_SECONDS = 3600
MAX_QUEUE = 200

class JobStore:
    """In-memory job store with age-based GC (ref _JobStore :816-941)."""

    def __init__(self):
        self._jobs: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._durations: List[float] = []

    def create(self, payload: Dict[str, Any]) -> str:
        task_id = uuid.uuid4().hex
        with self._lock:
            self._jobs[task_id] = {
                "status": "queued",
                "created": time.time(),
                "payload": payload,
                "progress": 0.0,
                "result": None,
                "error": None,
            }
        return task_id

    def get(self, task_id: str) -> Optional[Dict[str, Any]]:
        """Return a SNAPSHOT of the job, copied under the lock — callers read
        it outside the lock while `mark()` mutates the live dict (ref _JobStore
        copies result payloads out under its lock, api_server.py:816-941).
        Nested values (payload/result/run_meta) are assigned whole and never
        mutated in place after publication, so a shallow copy suffices."""
        with self._lock:
            job = self._jobs.get(task_id)
            return dict(job) if job is not None else None

    def mark(self, task_id: str, **kw) -> None:
        with self._lock:
            if task_id in self._jobs:
                self._jobs[task_id].update(kw)

    def record_duration(self, seconds: float) -> None:
        with self._lock:
            self._durations.append(seconds)
            self._durations = self._durations[-50:]

    def _eta_locked(self) -> float:
        return sum(self._durations) / len(self._durations) if self._durations else 30.0

    def eta(self) -> float:
        with self._lock:
            return self._eta_locked()

    def gc(self) -> None:
        now = time.time()
        with self._lock:
            # Only TERMINAL jobs age out: a long-queued job under backlog is
            # still owned by the queue — deleting it here would make the
            # worker silently skip it and the client poll "unknown task"
            # (the ref mirrors results before expiry for the same reason).
            dead = [
                k for k, v in self._jobs.items()
                if now - v["created"] > JOB_TTL_SECONDS
                and v.get("status") not in ("queued", "running")
            ]
            for k in dead:
                del self._jobs[k]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            by_status: Dict[str, int] = {}
            for v in self._jobs.values():
                by_status[v["status"]] = by_status.get(v["status"], 0) + 1
            return {
                "jobs": len(self._jobs),
                "by_status": by_status,
                "avg_job_seconds": self._eta_locked(),
            }


class StreamChannel:
    """Side channel carrying one streamed job's PCM from the worker to the
    HTTP thread holding the client connection (`/v1/generate_stream`).

    The worker's chunk sink pushes ("start", total_frames, channels),
    ("pcm", bytes)… then ("done",) / ("error", msg); the HTTP thread drains
    and writes. `dead` flips when the client disconnects mid-stream so the
    sink stops buffering bytes nobody will read (the job itself still
    completes and its file result stays pollable).

    Undrained PCM is capped at MAX_BUFFER_BYTES per connection: a client
    that stops reading mid-song would otherwise hold an entire waveform's
    bytes in host RAM (HTTP thread blocked in wfile.write never flips
    `dead`). The sink blocks briefly for drain credit, then declares the
    client dead and stops buffering; control messages bypass the cap so the
    terminal sentinel always lands."""

    MAX_BUFFER_BYTES = 48 << 20
    STALL_TIMEOUT_S = 30.0

    def __init__(self):
        self.q: "queue.Queue[tuple]" = queue.Queue()
        self.dead = False
        self.chunks = 0
        self._buffered = 0
        self._drained = threading.Condition()

    def sink(self, pos: int, pcm, total: int) -> None:
        # Handler chunk-sink protocol: in-order int16 (B, C, take) + total.
        if self.dead:
            return
        if pos == 0:
            self.q.put(("start", total, int(pcm.shape[1])))
        # (C, take) → interleaved frames (take, C), the WAV data layout.
        data = np.ascontiguousarray(pcm[0].T).tobytes()
        with self._drained:
            deadline = time.monotonic() + self.STALL_TIMEOUT_S
            while (
                self._buffered + len(data) > self.MAX_BUFFER_BYTES
                and not self.dead
            ):
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._drained.wait(remaining):
                    self.dead = True  # client stopped draining
                    return
            if self.dead:
                return
            self._buffered += len(data)
        self.q.put(("pcm", data))
        # Count only chunks actually enqueued for delivery — dropped chunks
        # (dead/stalled client) must not inflate the published
        # `streamed_chunks` result field.
        self.chunks += 1

    def consumed(self, nbytes: int) -> None:
        """HTTP thread credits back drained PCM bytes."""
        with self._drained:
            self._buffered -= nbytes
            self._drained.notify_all()

    def abandon(self) -> None:
        """No reader anymore: unblock a sink waiting for drain credit."""
        with self._drained:
            self.dead = True
            self._drained.notify_all()

    def close(self, error: Optional[str] = None) -> None:
        self.q.put(("error", error) if error else ("done",))


def _memory_policy(dit_handler) -> Optional[RuntimeMemoryConfig]:
    """The memory policy of the handler's card (`utils/memory_config`), or of
    the size `ACESTEP_MAX_HBM_GB` sets; None for a handler on the CPU."""
    device = getattr(dit_handler, "device", None)
    if os.environ.get("ACESTEP_MAX_HBM_GB") or getattr(device, "type", None) == "cuda":
        return get_runtime_memory_config(detect_hbm_gb(device))
    return None


class ApiService:
    """Holds handlers, the job queue, and the worker thread."""

    def __init__(self, dit_handler, llm_handler, output_dir: str = "./outputs",
                 extra_dit_handlers: Optional[Dict[str, Any]] = None):
        self.dit_handler = dit_handler
        self.llm_handler = llm_handler
        # Multi-model registry (ref ACESTEP_CONFIG_PATH{,2,3}, api_server.py:1274-1291)
        self.dit_handlers: Dict[str, Any] = {"default": dit_handler}
        if extra_dit_handlers:
            self.dit_handlers.update(extra_dit_handlers)
        self.output_dir = output_dir
        # A merged batch holds at most the policy's max_batch_size rows.
        self.memory_policy = _memory_policy(dit_handler)
        self.store = JobStore()
        self.progress = ProgressEstimator(os.path.join(output_dir, ".cache", "progress_estimates.json"))
        # Ring buffer served at /v1/logs (ref LogBuffer, api_server.py:1173-1202).
        self.logs = install_logbuffer()
        # Persistent job-result mirror: /query_result falls back to it for
        # task ids the in-memory store has dropped.
        self.result_cache = get_cache(os.path.join(output_dir, ".cache", "job_results.sqlite3"))
        self.queue: "queue.Queue[str]" = queue.Queue(maxsize=MAX_QUEUE)
        # Jobs drained while assembling a merged batch but not compatible
        # with it — run next, FIFO (see _worker_loop dynamic batching).
        self._held: "collections.deque[str]" = collections.deque()
        # task_id → StreamChannel for jobs whose PCM streams to a live HTTP
        # connection (/v1/generate_stream). Mutated from HTTP threads while
        # the worker/finisher threads read it — same snapshot discipline as
        # JobStore: every access goes through the _stream_* helpers' lock.
        self._streams: Dict[str, StreamChannel] = {}
        self._streams_lock = threading.Lock()
        # Serializes weight swaps (/v1/reinitialize) against running jobs:
        # the worker holds it across each generate; reinit must acquire it
        # before touching handler state (the reference's asyncio init lock,
        # ref api_server.py:1263-1268). Without it a reinit racing a running
        # job can mix old/new params mid-trajectory.
        self.model_lock = threading.Lock()
        self.training = TrainingService(dit_handler, llm_handler, self.model_lock)
        # The dataset explorer: scan/load/samples/sample edit/save,
        # auto_label and preprocess (also as polled background tasks).
        self.dataset = DatasetService(dit_handler, llm_handler, self.model_lock)
        # Serializes admission (check-pending + put + position read): the
        # check-then-put is not atomic on its own, so a burst of concurrent
        # submits could admit past MAX_QUEUE and hand two clients the same
        # queue_position.
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()

    def _stream_set(self, task_id: str, channel: StreamChannel) -> None:
        with self._streams_lock:
            self._streams[task_id] = channel

    def _stream_get(self, task_id: str) -> Optional[StreamChannel]:
        with self._streams_lock:
            return self._streams.get(task_id)

    def _stream_pop(self, task_id: str) -> Optional[StreamChannel]:
        with self._streams_lock:
            return self._streams.pop(task_id, None)

    def _pending_full(self) -> bool:
        """Admission check counting BOTH the queue and the merge-drain hold
        pen: draining a queued job into _held frees a queue slot, so qsize()
        alone would admit one extra job past MAX_QUEUE."""
        return self.queue.qsize() + len(self._held) >= MAX_QUEUE

    def _queue_position(self) -> int:
        """Jobs ahead of the one just enqueued. Called under _submit_lock,
        AFTER the put, so concurrent submits each see their own slot."""
        return max(self.queue.qsize() - 1, 0) + len(self._held)

    def submit(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Enqueue a job; raises queue.Full when MAX_QUEUE jobs are pending so
        the HTTP layer returns 429 instead of blocking the request thread (the
        reference's bounded job-queue backpressure)."""
        task_id = self.store.create(payload)
        try:
            with self._submit_lock:
                if self._pending_full():
                    raise queue.Full
                self.queue.put_nowait(task_id)
                pos = self._queue_position()
        except queue.Full:
            self.store.mark(task_id, status="failed", error="queue full")
            self._unlink_temp_files(payload)  # job never starts: no worker cleanup
            raise
        return {"task_id": task_id, "queue_position": pos}

    @staticmethod
    def _unlink_temp_files(payload: Dict[str, Any]) -> None:
        for p in payload.get("_temp_files", []) or []:
            try:
                os.unlink(p)
            except OSError:
                pass

    def submit_stream(self, payload: Dict[str, Any]) -> tuple:
        """Enqueue a streamed job and return (task_id, channel). The caller
        (HTTP thread) drains the channel and MUST discard it when done."""
        payload = dict(payload)
        payload["batch_size"] = 1  # one PCM stream per connection
        channel = StreamChannel()
        task_id = self.store.create(payload)
        self._stream_set(task_id, channel)
        try:
            with self._submit_lock:
                if self._pending_full():
                    raise queue.Full
                self.queue.put_nowait(task_id)
        except queue.Full:
            self._stream_pop(task_id)
            self.store.mark(task_id, status="failed", error="queue full")
            self._unlink_temp_files(payload)
            raise
        return task_id, channel

    def _worker_loop(self) -> None:
        """Serial job worker with BACK-TO-BACK PIPELINING and DYNAMIC
        BATCHING.

        Pipelining: job N's decode transfer + save (result.finish()) runs on
        a single finalize thread WHILE job N+1's LM/conditioning/denoise
        executes on this one, so under sustained load the device never idles
        on host transfers AND a finished job's status publishes as soon as
        its own transfers drain — not after the next job's compute (the
        single-worker role of ref api_server.py:1210-1212, plus the overlap
        the single-GPU reference cannot do). Depth is bounded to one
        outstanding finalize so device buffers from at most two jobs are
        live. Disable with ACESTEP_PIPELINE_JOBS=0.

        Dynamic batching: when several already-queued requests share a merge
        key (plain text2music, same duration/steps/guidance/format — see
        inference.merge_group_key), they fuse into ONE batch-N generation:
        N compatible requests cost one batch-N denoise and decode instead of
        N batch-1 runs, whose kernels leave most of the card idle.
        Only requests ALREADY in the queue merge — an empty queue adds zero
        latency. Non-matching drained jobs are held FIFO and run next.
        Disable with ACESTEP_MERGE_JOBS=0; cap via ACESTEP_MERGE_MAX (def 4),
        and at the memory policy's max_batch_size (every merged job has one
        row).
        """
        pipeline_jobs = os.environ.get("ACESTEP_PIPELINE_JOBS", "1") != "0"
        merge_jobs = os.environ.get("ACESTEP_MERGE_JOBS", "1") != "0"
        merge_max = max(1, int(os.environ.get("ACESTEP_MERGE_MAX", "4")))
        if self.memory_policy is not None:
            merge_max = min(merge_max, self.memory_policy.max_batch_size)
        finisher = ThreadPoolExecutor(max_workers=1)
        prev_future = None
        while True:
            task_id = self._held.popleft() if self._held else self.queue.get()
            group = [task_id]
            if merge_jobs and merge_max > 1:
                # The whole drain runs under _submit_lock: a queue→_held move
                # is two steps (get_nowait, then append), and a concurrent
                # submit between them would see the job in NEITHER count and
                # admit one past MAX_QUEUE. Jobs moved into `group` are
                # dispatching — their slot is legitimately freed.
                with self._submit_lock:
                    key0 = self._merge_key(task_id)
                    while True:
                        # held jobs first (FIFO), then the live queue
                        try:
                            tid = self._held.popleft() if self._held else self.queue.get_nowait()
                        except queue.Empty:
                            break
                        if (
                            key0 is not None
                            and len(group) < merge_max
                            and self._merge_key(tid) == key0
                        ):
                            group.append(tid)
                        else:
                            self._held.append(tid)
                            break  # keep FIFO order beyond the first non-match
            # Job N's finalize (on the finisher thread) overlaps job N+1's
            # generate below; we only JOIN it afterwards, bounding the
            # pipeline to two jobs' device buffers without re-serializing.
            # model_lock serializes the generate against /v1/reinitialize:
            # a weight swap mid-denoise would mix old/new params in one
            # trajectory (or crash a re-trace). Held only for the dispatch
            # phase — the deferred finalize reads device buffers the old
            # params already produced, which a swap cannot invalidate.
            with self.model_lock:
                if len(group) > 1:
                    started_list = self._start_job_group(group, defer=pipeline_jobs)
                else:
                    started = self._start_job(task_id, defer=pipeline_jobs)
                    started_list = [started] if started is not None else []
            if prev_future is not None:
                prev_future.result()
                prev_future = None
            if started_list:
                def _finalize_all(items=tuple(started_list)):
                    for it in items:
                        self._finalize_job(*it)

                if pipeline_jobs:
                    prev_future = finisher.submit(_finalize_all)
                else:
                    _finalize_all()

    def _merge_key(self, task_id: str):
        """Merge-compatibility key for a queued job, or None if unmergeable."""
        job = self.store.get(task_id)
        if job is None:
            return None
        if self._stream_get(task_id) is not None:
            return None  # streamed jobs own their decode chunk sink
        payload = job["payload"]
        if payload.get("_temp_files"):
            return None
        try:
            params = _params_from_payload(payload)
            cfg = _config_from_payload(payload)
        except Exception:  # noqa: BLE001 — let _start_job surface the error
            return None
        key = merge_group_key(params, cfg)
        if key is None:
            return None
        return (payload.get("model", "default"), key)

    def _start_job_group(self, task_ids, *, defer: bool):
        """Run a merged group as one batched generation; returns the list of
        (task_id, payload, t0, result) tuples to finalize."""
        t0 = time.time()
        items, metas = [], []
        for tid in task_ids:
            job = self.store.get(tid)
            if job is None:
                continue
            payload0 = job["payload"]
            self.store.mark(
                tid, status="running", progress=0.05,
                run_meta={
                    "started_at": t0,
                    "duration_s": float(payload0.get("duration", 30) or 30),
                    "batch": len(task_ids),
                    "steps": int(payload0.get("inference_steps", 8) or 8),
                    "merged": len(task_ids),
                },
            )
            params = _params_from_payload(payload0)
            cfg = _config_from_payload(payload0)
            cfg.output_dir = self.output_dir
            items.append((params, cfg))
            metas.append((tid, payload0))
        if not items:
            return []
        model_name = metas[0][1].get("model", "default")
        dit = self.dit_handlers.get(model_name, self.dit_handler)
        self.logs.append(
            f"merged batch of {len(items)}: {[tid for tid, _ in metas]}"
        )
        try:
            results = generate_music_merged(dit, items, defer_finish=defer)
        except Exception as e:  # noqa: BLE001 — fail each job, not the server
            err = f"{e}\n{traceback.format_exc()}"
            for tid, payload0 in metas:
                self.store.mark(tid, status="failed", error=err)
                self._cleanup_job(payload0, t0)
            return []
        return [
            (tid, payload0, t0, res)
            for (tid, payload0), res in zip(metas, results)
        ]

    def _start_job(self, task_id: str, *, defer: bool):
        """Run a job up to (and including) its device dispatch; returns the
        pending (task_id, payload, t0, result) tuple to finalize, or None if
        the job already failed/vanished."""
        job = self.store.get(task_id)
        if job is None:
            return None
        payload0 = job["payload"]
        self.store.mark(
            task_id, status="running", progress=0.05,
            run_meta={
                "started_at": time.time(),
                "duration_s": float(payload0.get("duration", 30) or 30),
                # Same default as _config_from_payload → GenerationConfig,
                # so the progress estimator's per-batch buckets see the batch
                # that actually ran.
                "batch": int(payload0.get("batch_size") or GenerationConfig().batch_size),
                "steps": int(payload0.get("inference_steps", 8) or 8),
            },
        )
        t0 = time.time()
        try:
            params = _params_from_payload(payload0)
            cfg = _config_from_payload(payload0)
            cfg.output_dir = self.output_dir
            model_name = payload0.get("model", "default")
            dit = self.dit_handlers.get(model_name, self.dit_handler)
            channel = self._stream_get(task_id)
            result = generate_music(dit, self.llm_handler, params, cfg,
                                    defer_finish=defer,
                                    chunk_sink=channel.sink if channel else None)
            # Uploaded temp files are consumed by generation (read during
            # conditioning, before this returns); remove them BEFORE the job
            # turns terminal so clients that poll success never observe
            # lingering uploads (_finalize_job keeps a safety net).
            for p in payload0.get("_temp_files", []) or []:
                try:
                    os.unlink(p)
                except OSError:
                    pass
            return (task_id, payload0, t0, result)
        except Exception as e:  # noqa: BLE001 — job must fail, not the server
            self.store.mark(task_id, status="failed", error=f"{e}\n{traceback.format_exc()}")
            self.logs.append(f"job {task_id} crashed: {e}")
            ch = self._stream_get(task_id)
            if ch is not None:
                ch.close(error=str(e))
            self._cleanup_job(payload0, t0)
            return None

    def _finalize_job(self, task_id: str, payload0: Dict[str, Any], t0: float, result) -> None:
        """Complete a started job: finish any deferred decode/save, publish
        the terminal status, mirror to the sqlite cache."""
        channel = self._stream_get(task_id)
        stream_err: Optional[str] = None
        try:
            result.finish()
            if result.success:
                tc = result.extra_outputs.get("time_costs", {})
                per_step = tc.get("diffusion_per_step_time_cost")
                if per_step:
                    job = self.store.get(task_id) or {}
                    rm = job.get("run_meta") or {}
                    self.progress.update(
                        rm.get("duration_s", 30), rm.get("batch", 1), float(per_step)
                    )
                self.store.mark(
                    task_id,
                    status="succeeded",
                    progress=1.0,
                    result={
                        "audio_paths": [a.get("path") for a in result.audios],
                        "params_paths": [a.get("params_path") for a in result.audios],
                        "keys": [a.get("key") for a in result.audios],
                        "seeds": [a.get("seed") for a in result.audios],
                        "lrcs": [a.get("lrc") for a in result.audios],
                        "lyrics_scores": [a.get("lyrics_score") for a in result.audios],
                        # Audio-free jobs (analysis_only/full_analysis_only)
                        # surface the LM metas directly.
                        "metas": (result.audios[0].get("metas") if result.audios
                                  else result.extra_outputs.get("lm_metadata")),
                        "extra": {
                            k: v
                            for k, v in result.extra_outputs.items()
                            if k in ("time_costs", "lm_metadata", "lm_draft",
                                     "lm_seed", "audio_codes", "merged_batch")
                        },
                        **({"streamed_chunks": channel.chunks} if channel else {}),
                    },
                )
                done = self.store.get(task_id)
                if done is not None:
                    self.result_cache.set(
                        "job:" + task_id,
                        {"status": "succeeded", "result": done["result"]},
                        ex=7 * 24 * 3600,
                    )
            else:
                stream_err = result.error or "generation failed"
                self.store.mark(task_id, status="failed", error=result.error)
                self.logs.append(f"job {task_id} failed: {result.error}")
                self.result_cache.set(
                    "job:" + task_id,
                    {"status": "failed", "error": result.error},
                    ex=24 * 3600,
                )
        except Exception as e:  # noqa: BLE001 — job must fail, not the server
            stream_err = str(e)
            self.store.mark(task_id, status="failed", error=f"{e}\n{traceback.format_exc()}")
            self.logs.append(f"job {task_id} crashed: {e}")
        finally:
            if channel is not None:
                channel.close(error=stream_err)
            self._cleanup_job(payload0, t0)

    def _cleanup_job(self, payload0: Dict[str, Any], t0: float) -> None:
        self._unlink_temp_files(payload0)
        self.store.record_duration(time.time() - t0)
        self.store.gc()


_PARAM_ALIASES = {
    "prompt": "caption",
    "audio_duration": "duration",
    "key_scale": "keyscale",
    "time_signature": "timesignature",
    # sample_query aliases (ref api_server.py:353 accepts description/desc)
    "description": "sample_query",
    "desc": "sample_query",
    # The reference schema's canonical names for these fields
    # (GenerateMusicRequest, ref api_server.py:485-528).
    "reference_audio_path": "reference_audio",
    "src_audio_path": "src_audio",
    "constrained_decoding": "use_constrained_decoding",
    "track_classes": "complete_track_classes",
}


def _request_seed(body: Dict[str, Any]) -> int:
    """Client-pinned seed, else a fresh 31-bit draw. Used by the LM-only
    endpoints so unseeded calls vary instead of replaying seed 0 forever."""
    try:
        seed = int(body.get("seed", -1))
    except (TypeError, ValueError):
        seed = -1
    if seed >= 0:
        return seed
    return int.from_bytes(os.urandom(4), "little") >> 1


def _params_from_payload(payload: Dict[str, Any]) -> GenerationParams:
    import dataclasses

    fields = {f.name for f in dataclasses.fields(GenerationParams)}
    kw = {}
    for k, v in payload.items():
        k = _PARAM_ALIASES.get(k, k)
        if k in fields and v is not None and not k.startswith("_"):
            kw[k] = v
    return GenerationParams(**kw)


def _parse_multipart(raw: bytes, content_type: str) -> Dict[str, Any]:
    """Parse a multipart/form-data body into a release_task payload.

    File parts are written to temp files and their PATHS become the param
    values — the reference's upload plumbing (`api_server.py:2460-2673`, JSON
    or multipart accepted on /release_task so cover/repaint/extract/lego/
    complete can be driven over HTTP). Repeated `reference_audio` parts become
    a list (multi-reference timbre). Scalar form fields are JSON-coerced
    ("30" → 30, "true" → True; non-JSON text stays a string). Temp paths are
    recorded under "_temp_files" for post-job cleanup.
    """
    import tempfile
    from email.parser import BytesParser
    from email.policy import HTTP

    msg = BytesParser(policy=HTTP).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + raw
    )
    payload: Dict[str, Any] = {}
    temp_files: List[str] = []
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        filename = part.get_filename()
        data = part.get_payload(decode=True)
        if filename:
            suffix = os.path.splitext(filename)[1] or ".bin"
            fd, path = tempfile.mkstemp(suffix=suffix, prefix="acestep_upload_")
            with os.fdopen(fd, "wb") as f:
                f.write(data or b"")
            temp_files.append(path)
            if name in payload:  # repeated file field → list
                prev = payload[name]
                payload[name] = (prev if isinstance(prev, list) else [prev]) + [path]
            else:
                payload[name] = path
        else:
            text = (data or b"").decode("utf-8", "replace")
            try:
                payload[name] = json.loads(text)
            except json.JSONDecodeError:
                payload[name] = text
    if temp_files:
        payload["_temp_files"] = temp_files
    return payload


def _config_from_payload(payload: Dict[str, Any]) -> GenerationConfig:
    import dataclasses

    fields = {f.name for f in dataclasses.fields(GenerationConfig)}
    kw = {k: v for k, v in payload.items() if k in fields and v is not None}
    return GenerationConfig(**kw)


def make_handler(service: ApiService, api_key: Optional[str] = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, obj: Any) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _auth_ok(self) -> bool:
            if not api_key:
                return True
            auth = self.headers.get("Authorization", "")
            if auth == f"Bearer {api_key}" or self.headers.get("X-API-Key") == api_key:
                return True
            # ?key= fallback ONLY for the media GET that cannot carry headers
            # (the studio page's <audio src> / download links). Accepting it
            # on every route would leak keys into proxy/access logs and
            # Referer headers for requests that can use headers instead.
            url = urlparse(self.path)
            if self.command == "GET" and url.path == "/v1/audio":
                q = parse_qs(url.query)
                return (q.get("key") or [""])[0] == api_key
            return False

        def _client_gone(self) -> bool:
            """True when the client socket has hit EOF (disconnect). The
            request body is fully consumed before streaming starts, so any
            zero-byte read on a readable socket means the peer closed; a
            readable socket WITH data (a pipelined request) counts as alive
            and is left unconsumed (MSG_PEEK).

            Known tradeoff: a client that half-closes its WRITE side after
            the request (shutdown(SHUT_WR)) while still reading presents the
            same FIN and is treated as gone — indistinguishable from a real
            disconnect without writing bytes first. Such a client gets a
            clean connection close instead of the stream; the job itself
            keeps running and its file result stays pollable."""
            import select
            import socket as _socket

            try:
                readable, _, _ = select.select([self.connection], [], [], 0)
                if not readable:
                    return False
                return self.connection.recv(1, _socket.MSG_PEEK) == b""
            except (OSError, ValueError):
                return True

        def _read_body(self) -> Dict[str, Any]:
            length = int(self.headers.get("Content-Length", 0))
            if length == 0:
                return {}
            raw = self.rfile.read(length)
            ctype = self.headers.get("Content-Type", "")
            if ctype.startswith("multipart/form-data"):
                return _parse_multipart(raw, ctype)
            try:
                return json.loads(raw)
            except json.JSONDecodeError:
                return {}

        def _generate_stream(self, body: Dict[str, Any]) -> None:
            """Progressive audio delivery: ONE valid WAV response whose PCM
            frames are written as each decode chunk's device→host transfer
            lands, instead of after the whole waveform arrives.

            The latent shape is known up front, so the exact sample count (a
            complete RIFF header and Content-Length) is sent before the first
            byte of audio exists; the decode's chunks then feed the socket as
            each one's copy reaches the host. Any WAV client can play the
            response as it arrives (`curl ... | mpv -`). The job also saves
            its file result and stays pollable via /query_result; the
            reference has no streaming-audio equivalent (its SSE chat path
            returns one final base64 blob)."""
            if int(body.get("batch_size", 1) or 1) != 1:
                return self._json(
                    400, {"error": "streaming serves one sample per "
                                   "connection (batch_size=1)"})
            try:
                task_id, channel = service.submit_stream(body)
            except queue.Full:
                return self._json(429, {"error": "queue full"})
            # The RIFF header must advertise the rate of the model that will
            # actually decode this job (the payload may select a non-default
            # entry from the multi-model registry).
            dit = service.dit_handlers.get(
                body.get("model", "default"), service.dit_handler)
            sr = dit.vae_config.sampling_rate
            header_sent = False
            try:
                while True:
                    try:
                        item = channel.q.get(timeout=2.0)
                    except queue.Empty:
                        # Pre-first-chunk the loop only polls channel.q, so a
                        # client that vanished while the job is still queued/
                        # running would otherwise pin this connection thread
                        # (and up to MAX_BUFFER_BYTES of PCM) for the job's
                        # whole queue wait + runtime. Probe the socket for
                        # EOF; the job itself keeps running and its file
                        # result stays pollable. Only BEFORE the header: a
                        # half-closed (SHUT_WR) client that is still reading
                        # presents the same FIN, and truncating a committed
                        # response mid-body would corrupt its WAV.
                        if not header_sent and self._client_gone():
                            return
                        # No terminal sentinel yet — make sure the job is
                        # still alive (crash paths close the channel, but a
                        # vanished job must not hang the connection).
                        job = service.store.get(task_id)
                        if job is None:
                            item = ("error", "job vanished")
                        else:
                            continue
                    kind = item[0]
                    if kind == "start":
                        total, channels = int(item[1]), int(item[2])
                        self.send_response(200)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header(
                            "Content-Length", str(44 + total * channels * 2))
                        self.send_header("X-Task-Id", task_id)
                        self.end_headers()
                        self.wfile.write(
                            audio_utils.wav_header(total, channels, sr))
                        self.wfile.flush()
                        header_sent = True
                    elif kind == "pcm":
                        self.wfile.write(item[1])
                        self.wfile.flush()
                        channel.consumed(len(item[1]))
                    elif kind == "done":
                        return
                    else:  # ("error", msg)
                        if not header_sent:
                            return self._json(
                                500, {"error": item[1], "task_id": task_id})
                        # Mid-stream failure: the short body (vs the declared
                        # Content-Length) signals truncation to the client.
                        return
            except (BrokenPipeError, ConnectionResetError):
                pass  # client left; abandon() below stops the buffering
            finally:
                channel.abandon()  # nobody drains past this point
                service._stream_pop(task_id)

        def _stream_chat(self, body: Dict[str, Any]) -> None:
            """SSE streaming chat completion: progress chunks while the job
            runs, final chunk with audio (ref OpenRouter SSE progress)."""
            import uuid as _uuid

            from acestep_tpu_torch.service.openrouter import (
                build_chat_request,
                chat_upload_assignments,
            )

            # ONE shared assembly with the non-streaming path (message input
            # modes, audio_config, body knobs, task-routed upload assignment —
            # ref openrouter_adapter.py:323-427,660-722). Streaming forces
            # batch 1 + wav (one progressive PCM stream per connection).
            # Build BEFORE committing the SSE 200: a malformed body (e.g.
            # audio_config.duration = "thirty") must surface as a 400 JSON,
            # not a dead stream with no error event.
            llm_ok = (service.llm_handler is not None
                      and getattr(service.llm_handler, "initialized", False))
            try:
                params, cfg_kw, audio_parts, (src_i, ref_i) = build_chat_request(
                    body, llm_ok)
            except (ValueError, TypeError) as e:
                return self._json(
                    400, {"error": {"code": 400, "message": f"bad request: {e}"}})
            payload = {**params.to_dict(), **cfg_kw,
                       "batch_size": 1, "audio_format": "wav"}

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            cid = f"chatcmpl-{_uuid.uuid4().hex[:24]}"

            def emit(obj):
                self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
                self.wfile.flush()
            if body.get("model"):  # multi-model registry selection
                payload["model"] = str(body["model"])
            if audio_parts:
                # Temp files ride "_temp_files" so the worker cleans them up
                # after the job turns terminal.
                tmp, assignments = chat_upload_assignments(
                    audio_parts, src_i, ref_i, prefix="acestep_sse_")
                payload.update(assignments)
                payload["_temp_files"] = tmp
            try:
                task = service.submit(payload)
            except queue.Full:
                self.wfile.write(
                    b'data: {"error": {"code": 429, "message": "queue full"}}\n\n'
                    b"data: [DONE]\n\n"
                )
                self.wfile.flush()
                return
            # A dropped client raises on the next SSE write; stop polling then
            # (the job itself keeps running — it may be another poller's too).
            try:
                emit({"id": cid, "object": "chat.completion.chunk",
                      "choices": [{"delta": {"role": "assistant",
                                              "content": f"queued {task['task_id']}"}, "index": 0}]})
                while True:
                    time.sleep(1.0)
                    job = service.store.get(task["task_id"])
                    if job is None or job["status"] in ("succeeded", "failed"):
                        break
                    emit({"id": cid, "object": "chat.completion.chunk",
                          "choices": [{"delta": {"content": f"progress {job['progress']:.0%}"},
                                        "index": 0}]})
                if job and job["status"] == "succeeded":
                    import base64 as _b64

                    parts = []
                    for p in job["result"]["audio_paths"]:
                        with open(p, "rb") as f:
                            parts.append({"type": "audio",
                                          "audio": {"data": _b64.b64encode(f.read()).decode(),
                                                    "format": p.rsplit(".", 1)[-1]}})
                    emit({"id": cid, "object": "chat.completion.chunk",
                          "choices": [{"delta": {"content": parts}, "index": 0,
                                        "finish_reason": "stop"}]})
                else:
                    emit({"id": cid, "object": "chat.completion.chunk",
                          "choices": [{"delta": {"content": f"error: {(job or {}).get('error', 'unknown')}"},
                                        "index": 0, "finish_reason": "error"}]})
                self.wfile.write(b"data: [DONE]\n\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                service.logs.append(f"SSE client disconnected ({cid}); polling stopped")

        def do_GET(self):  # noqa: N802
            url = urlparse(self.path)
            if url.path in ("/", "/studio"):
                from acestep_tpu_torch.service.webui import STUDIO_HTML

                body = STUDIO_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if url.path == "/health":
                return self._json(200, {"status": "ok", "initialized": service.dit_handler.initialized})
            # Everything past the open surfaces (studio page, health) is
            # gated like POSTs — the reference guards its GET routes with the
            # same verify_api_key dependency (ref api_server.py:2804,3227).
            if not self._auth_ok():
                return self._json(401, {"error": "unauthorized"})
            if url.path == "/v1/stats":
                payload = {"queue_depth": service.queue.qsize(), **service.store.stats()}
                lm = service.llm_handler
                if lm is not None and getattr(lm, "prefill_cache", None) is not None:
                    payload["lm_prefix_cache"] = lm.prefill_cache.stats()
                return self._json(200, payload)
            if url.path == "/v1/logs":
                try:
                    n = int(url.query.split("n=")[1].split("&")[0]) if "n=" in url.query else 200
                except Exception:
                    n = 200
                return self._json(200, {"lines": service.logs.tail(n)})
            if url.path == "/v1/example":
                # Random example params (ref metadata_loading.sample_example
                # over examples/*.json; these are this repo's own examples).
                import glob as _glob
                import random as _random

                root = os.environ.get(
                    "ACESTEP_EXAMPLES_DIR",
                    os.path.join(os.path.dirname(os.path.dirname(
                        os.path.dirname(os.path.abspath(__file__)))), "examples", "params"),
                )
                files = sorted(_glob.glob(os.path.join(root, "*.json")))
                if not files:
                    return self._json(404, {"error": "no examples installed"})
                with open(_random.choice(files), "r", encoding="utf-8") as f:
                    return self._json(200, {"example": json.load(f)})
            if url.path == "/v1/models":
                from acestep_tpu_torch.service.openrouter import models_response
                from acestep_tpu_torch.utils.downloader import list_available_models

                ids = [
                    "acestep-v15-tpu" if name == "default" else name
                    for name in service.dit_handlers
                ]
                return self._json(
                    200,
                    {
                        # OpenAI-format listing for OpenRouter-style clients
                        # (ref openrouter_api_server.py GET /v1/models)
                        **models_response(ids),
                        "models": [
                            {
                                "id": "acestep-v15-tpu" if name == "default" else name,
                                "version": h.config.model_version,
                                "tasks": ["text2music", "repaint", "cover", "extract", "lego", "complete"],
                            }
                            for name, h in service.dit_handlers.items()
                        ],
                        # Local checkpoint catalog with component verification
                        # (ref init_service_catalog; ACESTEP_CHECKPOINT_ROOT)
                        "catalog": list_available_models(),
                    },
                )
            if url.path == "/v1/audio":
                q = parse_qs(url.query)
                path = (q.get("path") or [""])[0]
                full = os.path.abspath(path)
                root = os.path.abspath(service.output_dir)
                # Separator-boundary containment: bare startswith(root) would
                # also match sibling dirs like "outputs_private".
                if (
                    not (full == root or full.startswith(root + os.sep))
                    or not os.path.exists(full)
                ):
                    return self._json(404, {"error": "not found"})
                with open(full, "rb") as f:
                    data = f.read()
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            # Dataset explorer reads, and the background tasks' status.
            if url.path == "/v1/dataset/samples":
                return self._json(200, service.dataset.samples())
            if url.path.startswith("/v1/dataset/sample/"):
                try:
                    idx = int(url.path.rsplit("/", 1)[-1])
                except ValueError:
                    return self._json(400, {"error": "bad sample index"})
                out = service.dataset.get_sample(idx)
                return self._json(200 if out.get("success") else 404, out)
            for kind in ("auto_label", "preprocess"):
                prefix = f"/v1/dataset/{kind}_status"
                if url.path.startswith(prefix):
                    tid = url.path[len(prefix):].strip("/") or None
                    return self._json(200, service.dataset.task_status(kind, tid))
            return self._json(404, {"error": "unknown endpoint"})

        def do_POST(self):  # noqa: N802
            if not self._auth_ok():
                return self._json(401, {"error": "unauthorized"})
            url = urlparse(self.path)
            body = self._read_body()
            if url.path == "/release_task":
                try:
                    resp = service.submit(body)
                    return self._json(200, resp)
                except queue.Full:
                    return self._json(429, {"error": "queue full"})
            if url.path == "/v1/generate_stream":
                return self._generate_stream(body)
            if url.path == "/query_result":
                ids = body.get("task_ids") or ([body["task_id"]] if "task_id" in body else [])
                results = []
                for tid in ids:
                    if not isinstance(tid, str):
                        # null/numeric ids (e.g. a client polling after a 429
                        # submit with no task_id) must not crash the handler.
                        results.append({
                            "task_id": tid, "status": 2, "progress": 0.0,
                            "result": None, "error": "bad task id",
                        })
                        continue
                    job = service.store.get(tid)
                    if job is None:
                        # Fall back to the persistent mirror (post-GC/restart).
                        cached = service.result_cache.get("job:" + tid)
                        if cached is not None:
                            results.append({
                                "task_id": tid,
                                "status": 1 if cached.get("status") == "succeeded" else 2,
                                "progress": 1.0,
                                "result": cached.get("result"),
                                "error": cached.get("error"),
                            })
                        else:
                            results.append({"task_id": tid, "status": 2, "error": "unknown task"})
                        continue
                    status = {"queued": 0, "running": 0, "succeeded": 1, "failed": 2}[job["status"]]
                    progress = job["progress"]
                    rm = job.get("run_meta")
                    if job["status"] == "running" and rm:
                        progress = max(
                            progress,
                            service.progress.progress_fraction(
                                rm["started_at"], rm["duration_s"], rm["batch"], rm["steps"]
                            ),
                        )
                    results.append(
                        {
                            "task_id": tid,
                            "status": status,
                            "progress": progress,
                            "result": job["result"],
                            "error": job["error"],
                        }
                    )
                return self._json(200, {"results": results})
            if url.path == "/create_random_sample":
                # A fresh draw unless the client pins one — the handler's
                # seed default is 0, which would make every "random" sample
                # identical (the reference samples unseeded here).
                out = create_sample(
                    service.llm_handler, body.get("query", ""),
                    seed=_request_seed(body),
                )
                return self._json(200, out)
            if url.path == "/format_input":
                out = format_sample(
                    service.llm_handler,
                    body.get("input") or body.get("user_input") or body.get("text", ""),
                    seed=_request_seed(body),
                )
                return self._json(200, out)
            if url.path == "/understand":
                res = understand_music(service.llm_handler, body.get("audio_codes", ""))
                return self._json(200, res.to_dict())
            if url.path == "/v1/train/start":
                try:
                    return self._json(200, service.training.start_run(body))
                except KeyError as e:
                    return self._json(400, {"error": f"missing field: {e}"})
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
            if url.path == "/v1/train/status":
                st = service.training.status(body.get("run_id", ""))
                if st is None:
                    return self._json(404, {"error": "unknown run"})
                return self._json(200, st)
            if url.path == "/v1/train/export":
                return self._json(200, service.training.export_adapter(body.get("run_id", ""), body.get("target_dir")))
            if url.path == "/v1/train/stop":
                return self._json(200, {"stopped": service.training.stop(body.get("run_id", ""))})
            if url.path == "/v1/train/list":
                return self._json(200, service.training.list_runs())
            if url.path == "/v1/train/build_dataset":
                try:
                    return self._json(200, service.training.build_dataset(body))
                except KeyError as e:
                    return self._json(400, {"error": f"missing field: {e}"})
            if url.path.startswith("/v1/dataset/"):
                ds = service.dataset
                op = url.path[len("/v1/dataset/"):]
                ops = {"scan": ds.scan, "load": ds.load, "save": ds.save, "auto_label": ds.auto_label,
                       "auto_label_async": ds.auto_label_async, "preprocess": ds.preprocess,
                       "preprocess_async": ds.preprocess_async}
                try:
                    if op in ops:
                        return self._json(200, ops[op](body))
                    if op.startswith("sample/"):
                        try:
                            idx = int(op.rsplit("/", 1)[-1])
                        except ValueError:
                            return self._json(400, {"error": "bad sample index"})
                        out = ds.update_sample(idx, body)
                        return self._json(200 if out.get("success") else 404, out)
                except Exception as e:  # noqa: BLE001
                    return self._json(500, {"success": False, "error": str(e)})
                return self._json(404, {"error": "unknown dataset endpoint"})
            if url.path == "/v1/reinitialize":
                # Reload checkpoints in place (ref api_server.py:3126),
                # serialized against the job worker via model_lock (the
                # reference's asyncio init lock, ref :1263-1268): the swap
                # waits for the running job's dispatch to complete — or
                # fails with 503 rather than corrupting it.
                if not service.model_lock.acquire(timeout=float(
                        os.environ.get("ACESTEP_REINIT_WAIT_S", "300"))):
                    return self._json(503, {
                        "success": False,
                        "error": "busy: a job is running; retry later"})
                try:
                    msg = service.dit_handler.initialize_service(
                        body.get("checkpoint_dir"),
                        random_init=body.get("random_init"),
                    )
                    return self._json(200, {"success": True, "message": msg})
                except Exception as e:  # noqa: BLE001
                    return self._json(500, {"success": False, "error": str(e)})
                finally:
                    service.model_lock.release()
            if url.path == "/v1/chat/completions":
                from acestep_tpu_torch.service.openrouter import handle_chat_completions

                if body.get("stream"):
                    return self._stream_chat(body)
                # Non-streaming chat generates on THIS HTTP thread (it never
                # enters the job queue), so it must hold the same model_lock
                # the worker's dispatch holds — otherwise /v1/reinitialize
                # could swap weights mid-trajectory under this generation.
                # The body `model` selects from the multi-model registry,
                # like the job API's `model` field.
                dit = service.dit_handlers.get(
                    str(body.get("model") or "default"), service.dit_handler)
                try:
                    with service.model_lock:
                        out = handle_chat_completions(
                            dit, service.llm_handler, body, service.output_dir,
                        )
                except (ValueError, TypeError) as e:
                    # Malformed body values (bad numerics in audio_config /
                    # seed / batch_size) — a client error, not a 500.
                    return self._json(
                        400, {"error": {"code": 400, "message": f"bad request: {e}"}})
                except Exception as e:  # noqa: BLE001
                    return self._json(
                        500, {"error": {"code": 500, "message": str(e)}})
                return self._json(200, out)
            # LoRA lifecycle (ref api_server.py:3014-3104)
            if url.path.startswith("/v1/lora/"):
                op = url.path.rsplit("/", 1)[-1]
                h = service.dit_handler
                try:
                    if op == "load":
                        meta = h.load_lora(body["name"], body["path"])
                        return self._json(200, {"success": True, "meta": meta})
                    if op == "unload":
                        return self._json(200, {"success": h.unload_lora(body["name"])})
                    if op == "toggle":
                        en = h.toggle_lora(body["name"], body.get("enabled"))
                        return self._json(200, {"success": True, "enabled": en})
                    if op == "scale":
                        h.set_lora_scale(body["name"], float(body["scale"]))
                        return self._json(200, {"success": True})
                    if op == "status":
                        return self._json(200, {"success": True, "adapters": h.lora_status()})
                except KeyError as e:
                    return self._json(400, {"success": False, "error": f"missing/unknown: {e}"})
                except Exception as e:  # noqa: BLE001
                    return self._json(500, {"success": False, "error": str(e)})
            return self._json(404, {"error": "unknown endpoint"})

        # The reference edits a dataset sample with PUT
        # (/v1/dataset/sample/{idx}); both verbs answer.
        do_PUT = do_POST  # noqa: N815

    return Handler


def serve(
    dit_handler,
    llm_handler,
    host: str = "127.0.0.1",
    port: int = 8001,
    api_key: Optional[str] = None,
    output_dir: str = "./outputs",
    extra_dit_handlers: Optional[Dict[str, Any]] = None,
) -> ThreadingHTTPServer:
    """Start the API server (returns the server; call serve_forever() or poll)."""
    service = ApiService(dit_handler, llm_handler, output_dir, extra_dit_handlers)
    server = ThreadingHTTPServer((host, port), make_handler(service, api_key))
    server.service = service  # type: ignore[attr-defined]
    return server


def main(argv=None) -> None:
    """Load the DiT and the planner (random weights when no checkpoint
    directory is given) and serve until interrupted."""
    import argparse

    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    ap = argparse.ArgumentParser(prog="acestep-tpu-torch-api")
    ap.add_argument("--checkpoint-dir", default=os.environ.get("ACESTEP_CONFIG_PATH"))
    ap.add_argument("--lm-checkpoint-dir", default=os.environ.get("ACESTEP_LM_MODEL_PATH"))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8001, help="0 binds a free port (printed)")
    ap.add_argument("--api-key", default=os.environ.get("ACESTEP_API_KEY"))
    ap.add_argument("--output-dir", default="./outputs")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dit = AceStepHandler(device=args.device)
    print(dit.initialize_service(args.checkpoint_dir), flush=True)
    llm = LLMHandler(device=args.device)
    print(llm.initialize(args.lm_checkpoint_dir), flush=True)
    server = serve(dit, llm, args.host, args.port, args.api_key, args.output_dir)
    print(f"listening on {args.host}:{server.server_address[1]}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
