"""Training REST service: LoRA runs (start, status, stop, export) and the
dataset builder and explorer.

Port of `acestep_tpu/service/train_api.py`. `TrainingService` runs the
trainer on a thread of its own; its metrics stream from the trainer's
`metrics.jsonl`. `DatasetService` holds one `DatasetBuilder` at a time for
the interactive explorer: scan or load labels, read and edit samples, save,
auto-label, preprocess, the last two also as background tasks with status
polling.

The trainer takes `dit_handler.training_params()`, the weights as they are
(under a tensor-parallel mesh with the whole decoder gathered from its tp
ranks): the port's decoder layers are already the per-layer list it trains,
so the JAX package's `unstack_decoder_params` has no counterpart.

Which work holds `model_lock` (the server passes its own, the lock its job
worker holds across each dispatch): the dataset work that runs the handlers
on the card (`build_dataset`, `auto_label`, `preprocess`), one sample at a
time (the builder's `lock`), so that it never shares the planner's caches
with a served job and a queued job waits for one sample, not the dataset. A
training run does not hold it, or it would stop serving for the whole run;
it relies on the process-wide TF32 guard (`utils/precision.strict_fp32`)
instead, and serving's bf16 paths compute the same beside it. The JAX
package takes no lock here.

A run's worker thread finishes a run under the service's own lock, its
adapter path before its terminal status, and `status` / `list_runs` copy a
run's state under that lock: a poll never sees a finished run without its
adapter, nor a state that changes size while it is copied. The JAX package
sets the status first and copies without the lock.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import traceback
import uuid
from typing import Any, Dict, List, Optional

from acestep_tpu_torch.training.dataset import PreprocessedDataset
from acestep_tpu_torch.training.dataset_builder import DatasetBuilder
from acestep_tpu_torch.training.trainer import LoRAConfig, LoRATrainer, TrainingConfig


class TrainingService:
    def __init__(self, dit_handler, llm_handler=None, model_lock: Optional[threading.Lock] = None):
        self.dit_handler = dit_handler
        self.llm_handler = llm_handler
        self.model_lock = model_lock or threading.Lock()
        self._runs: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------

    def start_run(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        run_id = uuid.uuid4().hex[:12]
        dataset_dir = payload["dataset_dir"]
        output_dir = payload.get("output_dir", f"./lora_runs/{run_id}")
        lcfg = LoRAConfig(
            rank=int(payload.get("rank", 32)),
            alpha=float(payload.get("alpha", 32.0)),
            adapter_type=str(payload.get("adapter_type", "lora")).lower(),
            lokr_factor=int(payload.get("lokr_factor", 8)),
        )
        tcfg = TrainingConfig(
            learning_rate=float(payload.get("learning_rate", 1e-4)),
            max_steps=int(payload.get("max_steps", 1000)),
            batch_size=int(payload.get("batch_size", 1)),
            gradient_accumulation_steps=int(payload.get("gradient_accumulation_steps", 1)),
            checkpoint_every=int(payload.get("checkpoint_every", 200)),
            output_dir=output_dir,
            resume_from=payload.get("resume_from"),
            seed=int(payload.get("seed", 0)),
            timestep_sampling=str(payload.get("timestep_sampling", "sidestep")),
        )
        state = {
            "status": "starting",
            "step": 0,
            "loss": None,
            "started": time.time(),
            "output_dir": output_dir,
            "error": None,
            "stop_requested": False,
        }
        with self._lock:
            self._runs[run_id] = state

        def worker():
            try:
                ds = PreprocessedDataset(dataset_dir)
                trainer = LoRATrainer(self.dit_handler.training_params(), self.dit_handler.config, lcfg, tcfg)
                state["status"] = "running"
                for step, loss, _msg in trainer.train(ds.batches(tcfg.batch_size)):
                    state["step"], state["loss"] = step, loss
                    if state["stop_requested"]:
                        trainer.save_checkpoint()
                        break
                final = "stopped" if state["stop_requested"] else "completed"
                with self._lock:  # a poll sees a finished run whole: its adapter with its status
                    state["adapter_path"] = os.path.join(output_dir, "adapter.npz")
                    state["status"] = final
            except Exception as e:  # noqa: BLE001 — surfaced via the status API
                error = f"{e}\n{traceback.format_exc()}"
                with self._lock:
                    state["error"] = error
                    state["status"] = "failed"

        threading.Thread(target=worker, daemon=True).start()
        return {"run_id": run_id, "output_dir": output_dir}

    def export_adapter(self, run_id: str, target_dir: Optional[str] = None) -> Dict[str, Any]:
        """A run's adapter.npz for serving, copied to `target_dir` as
        `{run_id}.npz` when one is given, so the LoRA routes can load it."""
        with self._lock:
            state = self._runs.get(run_id)
        if state is None:
            return {"success": False, "error": f"unknown run {run_id}"}
        adapter = os.path.join(state["output_dir"], "adapter.npz")
        if not os.path.exists(adapter):
            return {"success": False, "error": "no adapter checkpoint written yet"}
        out = adapter
        if target_dir:
            os.makedirs(target_dir, exist_ok=True)
            out = os.path.join(target_dir, f"{run_id}.npz")
            shutil.copy2(adapter, out)
        return {"success": True, "adapter_path": out, "step": state.get("step")}

    def status(self, run_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:  # the worker adds keys under this lock: copy the state whole
            state = self._runs.get(run_id)
            if state is None:
                return None
            out = {k: v for k, v in state.items() if k != "stop_requested"}
        metrics = os.path.join(state["output_dir"], "metrics.jsonl")
        if os.path.exists(metrics):
            with open(metrics) as f:
                lines = f.readlines()[-20:]
            out["recent_metrics"] = [json.loads(line) for line in lines if line.strip()]
        return out

    def stop(self, run_id: str) -> bool:
        with self._lock:
            state = self._runs.get(run_id)
            if state is None:
                return False
            state["stop_requested"] = True
        return True

    def list_runs(self) -> Dict[str, Any]:
        with self._lock:
            return {
                rid: {"status": s["status"], "step": s["step"], "loss": s["loss"],
                      "output_dir": s.get("output_dir"), "error": s.get("error")}
                for rid, s in self._runs.items()
            }

    # ------------------------------------------------------------------

    def build_dataset(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Scan -> label -> preprocess an audio directory into training
        tensors. Labels come from the sidecar files, any CSV with a `file`
        column, the caller's `captions` / `lyrics` dicts (by filename), and,
        with `label_with_lm` and a planner, the planner's understand-on-codes."""
        audio_dir = payload["audio_dir"]
        # `or`, not a .get default: the webui sends the field as "" when blank.
        out_dir = payload.get("output_dir") or (audio_dir.rstrip("/") + "_tensors")
        captions: Dict[str, str] = payload.get("captions", {})
        lyrics: Dict[str, str] = payload.get("lyrics", {})

        builder = DatasetBuilder(self.dit_handler, self.llm_handler, lock=self.model_lock)
        samples, scan_msg = builder.scan_directory(audio_dir)
        for s in samples:
            if s.filename in captions:
                s.caption = captions[s.filename]
            if s.filename in lyrics:
                s.lyrics = lyrics[s.filename]
        label_msgs: List[str] = []
        if payload.get("label_with_lm") and self.llm_handler is not None:
            label_msgs = builder.label_all(
                format_lyrics=bool(payload.get("format_lyrics")),
                temperature=float(payload.get("label_temperature", 0.7)),
            )
            builder.save_labels()
        written, msg = builder.preprocess_to_tensors(out_dir, max_duration=float(payload.get("max_duration", 240.0)))
        labels_preview = [
            {"file": s.filename, "caption": s.caption, "bpm": s.bpm, "keyscale": s.keyscale,
             "language": s.language, "source": s.label_source}
            for s in samples[:20]
        ]
        return {"output_dir": out_dir, "samples": len(written), "errors": {}, "scan": scan_msg, "status": msg,
                "labels": labels_preview, "label_log": label_msgs[:20]}


class DatasetService:
    """The dataset explorer's backend: one `DatasetBuilder` at a time; edits
    go through `update_sample`, so labels can be corrected before
    preprocessing."""

    EDITABLE_FIELDS = ("caption", "lyrics", "raw_lyrics", "bpm", "keyscale", "timesignature", "language", "genre",
                       "labeled")

    def __init__(self, dit_handler, llm_handler=None, model_lock: Optional[threading.Lock] = None):
        self.dit_handler = dit_handler
        self.llm_handler = llm_handler
        self.model_lock = model_lock or threading.Lock()
        self.builder: Optional[DatasetBuilder] = None
        self._tasks: Dict[str, Dict[str, Any]] = {}
        self._latest: Dict[str, Optional[str]] = {"auto_label": None, "preprocess": None}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- dataset
    def _require(self) -> DatasetBuilder:
        if self.builder is None:
            raise ValueError("no dataset loaded — call /v1/dataset/scan or /load first")
        return self.builder

    def scan(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        directory = payload.get("directory") or payload.get("audio_dir")
        if not directory:
            return {"success": False, "error": "missing field: directory"}
        builder = DatasetBuilder(self.dit_handler, self.llm_handler, lock=self.model_lock)
        samples, msg = builder.scan_directory(directory)
        if builder.directory is None:
            return {"success": False, "error": msg}
        self.builder = builder
        return {"success": True, "message": msg, "total_samples": len(samples),
                "samples": [s.to_dict() for s in samples]}

    def load(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Load a saved labels.json (`path`, or the one in `directory`)."""
        path = payload.get("path")
        directory = payload.get("directory")
        builder = DatasetBuilder(self.dit_handler, self.llm_handler, lock=self.model_lock)
        builder.directory = directory or (os.path.dirname(path) if path else None)
        try:
            n = builder.load_labels(path)
        except (OSError, ValueError, TypeError) as e:
            return {"success": False, "error": str(e)}
        self.builder = builder
        return {"success": True, "total_samples": n, "samples": [s.to_dict() for s in builder.samples]}

    def samples(self) -> Dict[str, Any]:
        try:
            b = self._require()
        except ValueError as e:
            return {"success": False, "error": str(e)}
        return {"success": True, "total_samples": len(b.samples), "samples": [s.to_dict() for s in b.samples]}

    def get_sample(self, idx: int) -> Dict[str, Any]:
        try:
            b = self._require()
        except ValueError as e:
            return {"success": False, "error": str(e)}
        if not (0 <= idx < len(b.samples)):
            return {"success": False, "error": f"invalid sample index {idx}"}
        return {"success": True, "sample_idx": idx, "sample": b.samples[idx].to_dict()}

    def update_sample(self, idx: int, payload: Dict[str, Any]) -> Dict[str, Any]:
        try:
            b = self._require()
        except ValueError as e:
            return {"success": False, "error": str(e)}
        if not (0 <= idx < len(b.samples)):
            return {"success": False, "error": f"invalid sample index {idx}"}
        s = b.samples[idx]
        for k in self.EDITABLE_FIELDS:
            if k in payload:
                v = payload[k]
                if k == "bpm" and v is not None:
                    try:
                        v = int(v)
                    except (TypeError, ValueError):
                        continue
                setattr(s, k, v)
        if payload.get("caption"):
            s.labeled = True
            s.label_source = s.label_source or "manual"
        return {"success": True, "sample": s.to_dict()}

    def save(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        try:
            b = self._require()
        except ValueError as e:
            return {"success": False, "error": str(e)}
        try:
            path = b.save_labels(payload.get("path"))
        except OSError as e:
            return {"success": False, "error": str(e)}
        return {"success": True, "path": path, "total_samples": len(b.samples)}

    # --------------------------------------------------------------- label
    def _label_indices(self, payload: Dict[str, Any]) -> List[int]:
        b = self._require()
        idxs = payload.get("indices")
        if idxs is None:
            idxs = list(range(len(b.samples)))
            if payload.get("skip_labeled"):
                idxs = [i for i in idxs if not b.samples[i].labeled]
        return [i for i in idxs if 0 <= i < len(b.samples)]

    def auto_label(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        try:
            b = self._require()
            idxs = self._label_indices(payload)
        except ValueError as e:
            return {"success": False, "error": str(e)}
        if self.llm_handler is None:
            return {"success": False, "error": "no LM handler loaded for auto-labeling"}
        kw = dict(format_lyrics=bool(payload.get("format_lyrics")),
                  temperature=float(payload.get("temperature", 0.7)), seed=int(payload.get("seed", 0)))
        msgs = [b.label_sample(i, **kw)[1] for i in idxs]
        if payload.get("save", True):
            b.save_labels()
        labeled = sum(1 for s in b.samples if s.labeled)
        return {"success": True, "labeled": labeled, "total": len(b.samples), "messages": msgs,
                "samples": [b.samples[i].to_dict() for i in idxs]}

    def auto_label_async(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._spawn("auto_label", self.auto_label, payload)

    # ----------------------------------------------------------- preprocess
    def preprocess(self, payload: Dict[str, Any], task: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        try:
            b = self._require()
        except ValueError as e:
            return {"success": False, "error": str(e)}
        out_dir = payload.get("output_dir") or ((b.directory or ".").rstrip("/") + "_tensors")

        def cb(i, s, status):
            if task is not None:
                task["current"] = i + 1
                task["message"] = f"{s.filename}: {status}"

        if task is not None:
            task["total"] = len(b.samples)
        written, msg = b.preprocess_to_tensors(out_dir, max_duration=float(payload.get("max_duration", 240.0)),
                                               progress_cb=cb)
        return {"success": True, "output_dir": out_dir, "written": len(written), "total": len(b.samples),
                "message": msg}

    def preprocess_async(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        return self._spawn("preprocess", self.preprocess, payload, pass_task=True)

    # ----------------------------------------------------------- task state
    def _spawn(self, kind: str, fn, payload: Dict[str, Any], pass_task: bool = False) -> Dict[str, Any]:
        task_id = uuid.uuid4().hex[:12]
        task = {"task_id": task_id, "kind": kind, "status": "running", "started": time.time(), "current": 0,
                "total": None, "message": "", "result": None, "error": None}
        with self._lock:
            self._tasks[task_id] = task
            self._latest[kind] = task_id

        def worker():
            try:
                out = fn(payload, task) if pass_task else fn(payload)
                task["result"] = out
                task["status"] = "completed" if out.get("success") else "failed"
                task["error"] = out.get("error")
            except Exception as e:  # noqa: BLE001 — surfaced via the status API
                task["status"] = "failed"
                task["error"] = f"{e}\n{traceback.format_exc()}"

        threading.Thread(target=worker, daemon=True).start()
        return {"success": True, "task_id": task_id}

    def task_status(self, kind: str, task_id: Optional[str] = None) -> Dict[str, Any]:
        with self._lock:
            tid = task_id or self._latest.get(kind)
            task = self._tasks.get(tid) if tid else None
        if task is None:
            return {"success": False, "error": f"no {kind} task" + (f" {task_id}" if task_id else " started yet")}
        return {"success": True, **task}
