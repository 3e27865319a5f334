"""The port's training REST API over loopback HTTP (CPU, fp32, tiny configs),
and the TF32 guard that lets a training run share the process with serving.

Against the JAX package's server, on one set of weights (the DiT handlers
and greedy planners of `tests/test_torch_dataset_builder.py`): the training
flow (`/v1/train/build_dataset` with the planner's labels -> `start` ->
`status` to completed -> `list` -> `export` -> `/v1/lora/load`, and the bad
bodies) and the dataset explorer's flow (scan, samples, edits by PUT and
POST, save and load, auto-label, preprocess in the background with status
polling), request by request: equal status codes and bodies, leaving out
timing fields, run and task ids and the adapter's values (the loss). The
port alone: a run's adapter against a direct `LoRATrainer` run with the same
seed and dataset, bit for bit; `stop` and a failed run; which work waits for
the server's `model_lock`, and that a queued job runs between two samples
of the dataset work. Every wait is bounded (`DEADLINE_S`), so a hang fails
the test.
"""

import json
import os
import threading
import time
import wave

import numpy as np
import pytest
import torch

import acestep_tpu_torch.pipeline.handler as TH
import acestep_tpu_torch.training.dataset_builder as TB
from acestep_tpu_torch.config import Qwen3Config
from acestep_tpu_torch.lm.handler import LLMHandler
from acestep_tpu_torch.training.dataset import PreprocessedDataset
from acestep_tpu_torch.training.trainer import LoRAConfig, LoRATrainer, TrainingConfig
from acestep_tpu_torch.utils import precision
from tests.test_torch_dataset_builder import SECONDS, _write_wav, pairs  # noqa: F401 (a fixture)
from tests.test_torch_serve import BUCKETS, DEADLINE_S, TINY_TEXT, Server, _handler

SONG_S = 0.3  # 450 latent frames of the tiny VAE


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these tiny shapes the suite's parallel workers
    contending for the cores cost far more than a thread pool saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dit():
    with pytest.MonkeyPatch.context() as mp:
        for name, val in BUCKETS.items():
            mp.setattr(TH, name, val)
        yield _handler()


@pytest.fixture(scope="module")
def llm():
    h = LLMHandler(Qwen3Config(**TINY_TEXT), dtype=torch.float32, device="cpu")
    h.initialize(random_init=True)
    for api in ("understand_audio_from_codes", "format_sample_from_input"):
        orig = getattr(h, api)
        setattr(h, api, lambda x, _orig=orig, **kw: _orig(x, **{**kw, "max_new_tokens": 24}))
    return h


@pytest.fixture
def server(dit, llm, tmp_path):
    s = Server(dit, tmp_path / "out", llm=llm)
    yield s
    s.close()


def _songs(d, names=("a", "b")):
    os.makedirs(d)
    rng = np.random.default_rng(0)
    for name in names:
        pcm = (rng.standard_normal(int(2 * 48_000 * SONG_S)) * 2000).astype(np.int16)
        with wave.open(os.path.join(d, name + ".wav"), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(48_000)
            w.writeframes(pcm.tobytes())
    with open(os.path.join(d, "a.caption.txt"), "w") as f:
        f.write("sidecar caption")
    return d


def _poll(fn, done, what):
    deadline = time.time() + DEADLINE_S
    while True:
        out = fn()
        if done(out):
            return out
        assert time.time() < deadline, (what, out)
        time.sleep(0.05)


def _run_status(server, run_id):
    return _poll(lambda: server.post("/v1/train/status", {"run_id": run_id})[1],
                 lambda st: st["status"] in ("completed", "failed", "stopped"), "train status")


def _adapter(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_build_train_export_load(server, dit, tmp_path):
    """build_dataset (sidecar caption, the caller's caption for b) -> start ->
    status to completed -> list -> export -> /v1/lora/load; the run's adapter
    equals a direct LoRATrainer run's bit for bit. Bad bodies: 400 / 404."""
    songs = _songs(str(tmp_path / "songs"))
    status, out = server.post("/v1/train/build_dataset", {"audio_dir": songs, "output_dir": "",
                                                          "captions": {"b.wav": "given caption"}})
    assert status == 200 and out["samples"] == 2 and out["errors"] == {}, out
    assert out["output_dir"] == songs + "_tensors" and out["status"] == f"wrote 2/2 samples to {songs}_tensors"
    assert [(r["file"], r["caption"], r["source"]) for r in out["labels"]] == [
        ("a.wav", "sidecar caption", "sidecar"), ("b.wav", "given caption", "")]
    assert out["scan"] == "2 audio files (1 captions, 0 lyrics, 0 csv rows)" and out["label_log"] == []
    ds_dir = out["output_dir"]

    body = {"dataset_dir": ds_dir, "max_steps": 3, "rank": 4, "seed": 5, "checkpoint_every": 3,
            "output_dir": str(tmp_path / "run")}
    status, out = server.post("/v1/train/start", body)
    assert status == 200 and out["output_dir"] == body["output_dir"], out
    run_id = out["run_id"]
    st = _run_status(server, run_id)
    assert st["status"] == "completed" and st["step"] == 3 and st["error"] is None, st.get("error")
    assert st["adapter_path"] == os.path.join(body["output_dir"], "adapter.npz") and np.isfinite(st["loss"])
    assert server.post("/v1/train/list", {})[1][run_id] == {
        "status": "completed", "step": 3, "loss": st["loss"], "output_dir": body["output_dir"], "error": None}

    trainer = LoRATrainer(dit.params, dit.config, LoRAConfig(rank=4),
                          TrainingConfig(max_steps=3, seed=5, checkpoint_every=3, output_dir=str(tmp_path / "direct")))
    for _ in trainer.train(PreprocessedDataset(ds_dir).batches(1)):
        pass
    got, want = _adapter(st["adapter_path"]), _adapter(str(tmp_path / "direct" / "adapter.npz"))
    assert sorted(got) == sorted(want) and len(got) > 1
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    status, out = server.post("/v1/train/export", {"run_id": run_id, "target_dir": str(tmp_path / "adapters")})
    assert status == 200 and out == {"success": True, "adapter_path": str(tmp_path / "adapters" / f"{run_id}.npz"),
                                     "step": 3}
    status, loaded = server.post("/v1/lora/load", {"name": "trained", "path": out["adapter_path"]})
    assert status == 200 and loaded["success"] and loaded["meta"] == {"rank": 4, "alpha": 32.0,
                                                                      "adapter_type": "lora", "step": 3}
    assert server.post("/v1/lora/unload", {"name": "trained"}) == (200, {"success": True})

    assert server.post("/v1/train/export", {"run_id": "nope"})[1] == {"success": False, "error": "unknown run nope"}
    assert server.post("/v1/train/status", {"run_id": "nope"}) == (404, {"error": "unknown run"})
    assert server.post("/v1/train/start", {"max_steps": 1}) == (400, {"error": "missing field: 'dataset_dir'"})
    status, out = server.post("/v1/train/start", {"dataset_dir": ds_dir, "timestep_sampling": "uniform"})
    assert status == 400 and "timestep_sampling" in out["error"]
    assert server.post("/v1/train/build_dataset", {}) == (400, {"error": "missing field: 'audio_dir'"})


def test_stop_and_failed_runs(server, tmp_path):
    """stop: the run saves its adapter and ends "stopped" before max_steps;
    a run on a missing dataset ends "failed" with the reason."""
    from acestep_tpu_torch.training.dataset import save_sample, write_manifest

    ds = str(tmp_path / "tensors")
    os.makedirs(ds)
    rng = np.random.default_rng(0)
    save_sample(os.path.join(ds, "s0.npz"), {
        "target_latents": rng.standard_normal((16, 64)).astype(np.float32),
        "encoder_hidden_states": rng.standard_normal((8, 64)).astype(np.float32),
        "encoder_attention_mask": np.ones((8,), np.int32),
        "context_latents": rng.standard_normal((16, 128)).astype(np.float32),
        "attention_mask": np.ones((16,), np.int32),
    })
    write_manifest(ds, [{"file": "s0.npz"}])
    run_id = server.post("/v1/train/start", {"dataset_dir": ds, "max_steps": 100000, "rank": 2,
                                             "output_dir": str(tmp_path / "run")})[1]["run_id"]
    _poll(lambda: server.post("/v1/train/status", {"run_id": run_id})[1], lambda st: st["step"] >= 2, "steps")
    assert server.post("/v1/train/stop", {"run_id": run_id}) == (200, {"stopped": True})
    st = _run_status(server, run_id)
    assert st["status"] == "stopped" and 2 <= st["step"] < 100000 and os.path.exists(st["adapter_path"])
    assert server.post("/v1/train/stop", {"run_id": "nope"}) == (200, {"stopped": False})

    run_id = server.post("/v1/train/start", {"dataset_dir": str(tmp_path / "none"),
                                             "output_dir": str(tmp_path / "run2")})[1]["run_id"]
    st = _run_status(server, run_id)
    assert st["status"] == "failed" and "No such file or directory" in st["error"]


class _Trainer:
    """A trainer that takes one step, then waits for `go` before it ends."""

    go = threading.Event()

    def __init__(self, *a, **kw):
        pass

    def train(self, batches):
        yield 1, 0.5, "step 1"
        assert _Trainer.go.wait(DEADLINE_S)

    def save_checkpoint(self):
        pass


def _is_worker(frame):
    from acestep_tpu_torch.service import train_api

    return frame.f_code.co_name == "worker" and frame.f_code.co_filename == train_api.__file__


@pytest.mark.parametrize("interleaving", ["poll_after_status", "poll_during_copy"])
def test_status_sees_a_finished_run_whole(monkeypatch, tmp_path, interleaving):
    """Both races between a run's worker thread and a status poll, forced by
    tracing rather than left to the scheduler:
    poll_after_status: the worker is stopped at the first line it runs after
      its run shows a terminal status, and `status` is called from another
      thread there: the status must come with its `adapter_path`;
    poll_during_copy: `status` is stopped while it copies the run's state (at
      the second line event of that copy, inside its loop), and the worker
      finishes the run then: the copy must not see the state change size.
    A poll that has to wait for the worker's lock is let go after 0.5 s and
    finishes when the worker has."""
    import sys

    from acestep_tpu_torch.service import train_api

    monkeypatch.setattr(train_api, "PreprocessedDataset", lambda d: type("D", (), {"batches": lambda s, n: iter(())})())
    monkeypatch.setattr(train_api, "LoRATrainer", _Trainer)
    svc = train_api.TrainingService(type("H", (), {"params": None, "config": None,
                                                   "training_params": lambda self: None})())
    polls, errors = [], []

    def poll(run_id, tracer=None):
        def body():
            if tracer is not None:
                sys.settrace(tracer)
            try:
                polls.append(svc.status(run_id))
            except Exception as e:  # noqa: BLE001 — the race under test
                errors.append(e)
            finally:
                sys.settrace(None)

        th = threading.Thread(target=body)
        th.start()
        return th

    threads = []
    if interleaving == "poll_after_status":
        _Trainer.go.set()

        def worker_tracer(frame, event, arg):
            if not _is_worker(frame):
                return None

            def local(frame, event, arg):
                state = frame.f_locals.get("state")  # the worker's run, a variable of its closure
                if event in ("line", "return") and state and state["status"] == "completed" and not threads:
                    rid = next(k for k, v in list(svc._runs.items()) if v is state)
                    threads.append(poll(rid))
                    threads[0].join(0.5)
                return local

            return local

        threading.settrace(worker_tracer)
        try:
            run_id = [svc.start_run({"dataset_dir": str(tmp_path), "output_dir": str(tmp_path / "run")})["run_id"]]
        finally:
            threading.settrace(None)
        _poll(lambda: list(threads), bool, "a poll at the terminal status")
    else:
        _Trainer.go.clear()
        run_id = [svc.start_run({"dataset_dir": str(tmp_path), "output_dir": str(tmp_path / "run")})["run_id"]]
        _poll(lambda: svc.status(run_id[0]), lambda st: st["step"] == 1, "first step")
        seen = []

        def copy_tracer(frame, event, arg):
            if frame.f_code.co_name != "status" or frame.f_code.co_filename != train_api.__file__:
                return None

            def local(frame, event, arg):
                if event == "line":
                    seen.append(frame.f_lineno)
                    if len(seen) >= 2 and seen[-1] == seen[-2] and not _Trainer.go.is_set():
                        _Trainer.go.set()  # the copy's loop has begun: let the worker finish the run now
                        deadline = time.time() + 0.5
                        while "adapter_path" not in svc._runs[run_id[0]] and time.time() < deadline:
                            time.sleep(0.001)
                return local

            return local

        threads.append(poll(run_id[0], copy_tracer))
        threads[0].join(DEADLINE_S)
        assert _Trainer.go.is_set(), "the copy's loop was never traced"
    for th in threads:
        th.join(DEADLINE_S)
    assert not errors, errors
    assert polls, "no poll ran"
    if interleaving == "poll_after_status":
        st = polls[0]
        assert st["status"] == "completed" and st["adapter_path"] == str(tmp_path / "run" / "adapter.npz"), st
    st = _poll(lambda: svc.status(run_id[0]), lambda st: st["status"] == "completed", "completed")
    assert st["adapter_path"] == str(tmp_path / "run" / "adapter.npz")


@pytest.fixture(scope="module")
def both(pairs, tmp_path_factory):
    """The JAX package's server and the port's, on the paired handlers."""
    from acestep_tpu.service.api_server import serve as jax_serve

    (jd, jl), (td, tl) = pairs
    servers = (Server(jd, tmp_path_factory.mktemp("jax_out"), llm=jl, serve_fn=jax_serve),
               Server(td, tmp_path_factory.mktemp("torch_out"), llm=tl))
    yield servers
    for s in servers:
        s.close()


# Body fields that differ between two runs of one package: timing, ids, the
# adapter's values.
VOLATILE = ("started", "task_id", "run_id", "loss", "time")


def _norm(body, subs=()):
    """`body` with each (old, new) of `subs` replaced in its text (paths, ids)
    and each VOLATILE field's value masked."""
    text = json.dumps(body, sort_keys=True)
    for old, new in subs:
        text = text.replace(old, new)

    def mask(x):
        if isinstance(x, dict):
            return {k: "*" if k in VOLATILE else mask(v) for k, v in x.items()}
        return [mask(v) for v in x] if isinstance(x, list) else x

    return mask(json.loads(text))


def _same(both, method, path, body=None, subs=((), ())):
    """One request to each server: equal status codes and bodies after
    `_norm` (each server's own `subs`). Returns the port's body."""
    got = []
    for server, sub in zip(both, subs):
        status, out, _ = server.request(method, path, body(server) if callable(body) else body)
        got.append((status, _norm(out, sub), out))
    assert got[1][:2] == got[0][:2], (path, got[0][2], got[1][2])
    return got[1][2]


def _dataset_dir(d, names=("a", "b")):
    os.makedirs(d)
    for i, name in enumerate(names):
        _write_wav(os.path.join(d, name + ".wav"), seed=i + 1)
    with open(os.path.join(d, "a.caption.txt"), "w") as f:
        f.write("sidecar caption")
    return d


def test_training_flow_matches_jax(both, tmp_path):
    """build_dataset (the planner labels b, greedy) -> start -> status to
    completed -> list -> export -> /v1/lora/load, and the bad bodies: each
    answer equals the JAX server's. Each server writes its own tensors and
    run, and the paths and run ids are named alike before the comparison."""
    songs = _dataset_dir(str(tmp_path / "songs"))
    out = {id(s): str(tmp_path / n) for s, n in zip(both, ("jax", "torch"))}
    subs = [[(out[id(s)], "OUT")] for s in both]
    built = _same(both, "POST", "/v1/train/build_dataset",
                  lambda s: {"audio_dir": songs, "output_dir": out[id(s)] + "/tensors", "label_with_lm": True,
                             "label_temperature": 0.0}, subs)
    assert built["samples"] == 2 and built["label_log"] == ["labeled a.wav via lm", "labeled b.wav via lm"]
    start = lambda s: {"dataset_dir": out[id(s)] + "/tensors", "max_steps": 2, "rank": 4, "seed": 5,
                       "checkpoint_every": 2, "output_dir": out[id(s)] + "/run"}
    runs = [server.post("/v1/train/start", start(server)) for server in both]
    assert [r[0] for r in runs] == [200, 200] and sorted(runs[0][1]) == sorted(runs[1][1]) == ["output_dir", "run_id"]
    for sub, (_, r) in zip(subs, runs):
        sub.append((r["run_id"], "RUN"))
    for server, (_, r) in zip(both, runs):
        _run_status(server, r["run_id"])
    st = _same(both, "POST", "/v1/train/status", lambda s: {"run_id": runs[both.index(s)][1]["run_id"]}, subs)
    assert st["status"] == "completed" and st["step"] == 2 and st["error"] is None
    _same(both, "POST", "/v1/train/list", {}, subs)
    exported = _same(both, "POST", "/v1/train/export",
                     lambda s: {"run_id": runs[both.index(s)][1]["run_id"], "target_dir": out[id(s)] + "/adapters"},
                     subs)
    assert exported["success"] and exported["step"] == 2
    loaded = _same(both, "POST", "/v1/lora/load", lambda s: {"name": "trained", "path": os.path.join(
        out[id(s)], "adapters", runs[both.index(s)][1]["run_id"] + ".npz")}, subs)
    assert loaded["success"] and loaded["meta"]["rank"] == 4
    assert _same(both, "POST", "/v1/lora/unload", {"name": "trained"})["success"]
    for path, body in (("/v1/train/export", {"run_id": "nope"}), ("/v1/train/status", {"run_id": "nope"}),
                       ("/v1/train/stop", {"run_id": "nope"}), ("/v1/train/start", {"max_steps": 1}),
                       ("/v1/train/build_dataset", {})):
        _same(both, "POST", path, body)


def _task(server, kind, tid):
    return _poll(lambda: server.get(f"/v1/dataset/{kind}_status/{tid}")[1],
                 lambda st: st["status"] != "running", kind)


def test_dataset_explorer_flow_matches_jax(both, tmp_path):
    """The reads before any scan; scan -> samples / sample -> edits by PUT
    and POST (a bad bpm, bad indices) -> save / load -> auto_label (greedy)
    -> auto_label_async -> preprocess_async with status polling, by id and
    latest: each answer equals the JAX server's."""
    d = _dataset_dir(str(tmp_path / "songs"))
    for method, path in (("GET", "/v1/dataset/samples"), ("GET", "/v1/dataset/preprocess_status"),
                         ("GET", "/v1/dataset/auto_label_status"), ("POST", "/v1/dataset/save")):
        _same(both, method, path, None if method == "GET" else {})
    assert _same(both, "POST", "/v1/dataset/scan", {"directory": d})["total_samples"] == 2
    _same(both, "GET", "/v1/dataset/samples")
    for idx in ("0", "9", "x"):
        _same(both, "GET", f"/v1/dataset/sample/{idx}")
    edited = _same(both, "PUT", "/v1/dataset/sample/1", {"caption": "manual caption", "bpm": "95",
                                                          "keyscale": "D minor"})
    assert edited["sample"]["label_source"] == "manual" and edited["sample"]["bpm"] == 95
    _same(both, "POST", "/v1/dataset/sample/1", {"lyrics": "la la", "bpm": "fast"})
    _same(both, "POST", "/v1/dataset/sample/7", {"caption": "x"})
    assert _same(both, "POST", "/v1/dataset/save", {})["path"] == os.path.join(d, "labels.json")
    _same(both, "POST", "/v1/dataset/load", {"path": os.path.join(d, "labels.json")})
    _same(both, "POST", "/v1/dataset/load", {"path": str(tmp_path / "none.json")})
    labeled = _same(both, "POST", "/v1/dataset/auto_label", {"indices": [0], "temperature": 0.0})
    assert labeled["messages"] == ["labeled a.wav via lm"]

    ids = [s.post("/v1/dataset/auto_label_async", {"skip_labeled": True, "save": False})[1]["task_id"]
           for s in both]
    subs = [[(tid, "TASK")] for tid in ids]
    done = [_norm(_task(s, "auto_label", tid), sub) for s, tid, sub in zip(both, ids, subs)]
    assert done[1] == done[0] and done[1]["status"] == "completed" and done[1]["result"]["messages"] == []
    out = {id(s): str(tmp_path / n) for s, n in zip(both, ("jax", "torch"))}
    ids = [s.post("/v1/dataset/preprocess_async", {"output_dir": out[id(s)]})[1]["task_id"] for s in both]
    subs = [[(tid, "TASK"), (out[id(s)], "OUT")] for tid, s in zip(ids, both)]
    done = [_norm(_task(s, "preprocess", tid), sub) for s, tid, sub in zip(both, ids, subs)]
    assert done[1] == done[0] and done[1]["status"] == "completed" and done[1]["result"]["written"] == 2
    _same(both, "GET", "/v1/dataset/preprocess_status", subs=subs)
    with open(os.path.join(out[id(both[0])], "manifest.json")) as f, \
            open(os.path.join(out[id(both[1])], "manifest.json")) as g:
        assert json.load(g) == json.load(f)
    for path in ("/v1/dataset/nope", "/v1/dataset/scan"):
        _same(both, "POST", path, {})


def test_dataset_work_waits_for_the_model_lock_and_training_does_not(server, dit, tmp_path):
    """While a job holds `model_lock`, a background preprocess waits and a
    training run goes on to its end; the preprocess ends once the lock is
    free."""
    from acestep_tpu_torch.training.dataset_builder import DatasetBuilder

    d = _songs(str(tmp_path / "songs"), names=("a",))
    ds = str(tmp_path / "ready")
    b = DatasetBuilder(dit)
    b.scan_directory(d)
    b.preprocess_to_tensors(ds)
    assert server.post("/v1/dataset/scan", {"directory": d})[1]["success"]
    with server.service.model_lock:
        tid = server.post("/v1/dataset/preprocess_async", {"output_dir": str(tmp_path / "tensors")})[1]["task_id"]
        run_id = server.post("/v1/train/start", {"dataset_dir": ds, "max_steps": 2, "rank": 2,
                                                 "output_dir": str(tmp_path / "run")})[1]["run_id"]
        assert _run_status(server, run_id)["status"] == "completed"
        st = server.get(f"/v1/dataset/preprocess_status/{tid}")[1]
        assert st["status"] == "running" and st["current"] == 0
    st = _poll(lambda: server.get(f"/v1/dataset/preprocess_status/{tid}")[1],
               lambda st: st["status"] != "running", "preprocess")
    assert st["status"] == "completed" and st["result"]["written"] == 1


@pytest.mark.parametrize("route", ["build_dataset", "auto_label", "preprocess"])
def test_queued_work_runs_between_samples(server, monkeypatch, tmp_path, route):
    """The dataset work holds `model_lock` one sample at a time: when the
    second sample's audio is read, the first sample's work has let the lock
    go, and work that waited for it (as the server's worker waits to
    dispatch a job) runs before the second sample takes it again. Held for
    the whole dataset, the lock would stay taken and the wait time out."""
    from acestep_tpu_torch.utils import audio as audio_utils

    d = _songs(str(tmp_path / "songs"))
    lock, ran, reads = server.service.model_lock, threading.Event(), []
    real_load = audio_utils.load_audio

    def queued_job():
        with lock:
            ran.set()

    def load_audio(path, *a, **kw):
        reads.append(os.path.basename(path))
        if reads == ["a.wav", "b.wav"]:
            assert ran.wait(DEADLINE_S), "the queued work did not run between the samples"
        return real_load(path, *a, **kw)

    monkeypatch.setattr(audio_utils, "load_audio", load_audio)
    waiter = None

    def start_waiter():
        nonlocal waiter
        waiter = threading.Thread(target=queued_job)
        waiter.start()

    real_convert, real_pre = server.service.dit_handler.convert_audio_to_codes, TB.preprocess_audio_to_sample

    def convert(*a, **kw):  # inside the first sample's lock: the job queues behind it
        if waiter is None:
            start_waiter()
        return real_convert(*a, **kw)

    def pre(*a, **kw):
        if waiter is None:
            start_waiter()
        return real_pre(*a, **kw)

    monkeypatch.setattr(server.service.dit_handler, "convert_audio_to_codes", convert)
    monkeypatch.setattr(TB, "preprocess_audio_to_sample", pre)
    if route == "build_dataset":
        status, out = server.post("/v1/train/build_dataset", {"audio_dir": d, "output_dir": str(tmp_path / "t")})
        assert status == 200 and out["samples"] == 2, out
    else:
        assert server.post("/v1/dataset/scan", {"directory": d})[1]["success"]
        body = {"indices": [0, 1]} if route == "auto_label" else {"output_dir": str(tmp_path / "t")}
        status, out = server.post(f"/v1/dataset/{route}", body)
        assert status == 200 and out["success"], out
    waiter.join(DEADLINE_S)
    assert ran.is_set() and reads[:2] == ["a.wav", "b.wav"] and not lock.locked()


# Each thread's action at each barrier phase: A enters, B enters, A leaves, B
# leaves (both outside); then B enters first and leaves last.
GUARD_SCHEDULE = {
    "A": ("enter", None, "leave", None, None, "enter", "leave", None),
    "B": (None, "enter", None, "leave", "enter", None, None, "leave"),
}


def test_strict_fp32_guard_across_threads(monkeypatch):
    """Two threads interleave the guard's entries and exits on barriers: both
    flags are False whenever either thread is inside, and come back to the
    caller's values once both have left, each time."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    phase = threading.Barrier(2, timeout=DEADLINE_S)
    seen = {"A": [], "B": []}

    def thread(name):
        cm = None
        for action in GUARD_SCHEDULE[name]:
            if action == "enter":
                cm = precision.strict_fp32()
                cm.__enter__()
            elif action == "leave":
                cm.__exit__(None, None, None)
            phase.wait()  # every action of this phase is done
            seen[name].append(flags())
            phase.wait()  # both threads have read

    threads = [threading.Thread(target=thread, args=(n,)) for n in GUARD_SCHEDULE]
    for t in threads:
        t.start()
    for t in threads:
        t.join(DEADLINE_S)
    inside = [any(sum((x == "enter") - (x == "leave") for x in GUARD_SCHEDULE[n][: i + 1]) for n in GUARD_SCHEDULE)
              for i in range(len(GUARD_SCHEDULE["A"]))]
    assert inside == [True, True, True, False, True, True, True, False]
    assert seen["A"] == seen["B"] == [(False, False) if x else (True, True) for x in inside]
    assert flags() == (True, True) and precision._depth == 0


def test_strict_fp32_guard_stress(monkeypatch):
    """16 threads (more than the cores) enter and leave the guard 200 times
    each with a 1 us switch interval: every reading inside sees both flags
    False, and the flags and the depth come back once all have left (a lost
    update of the depth would leave them off, or restore them too early)."""
    import sys

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    bad = []

    def hammer():
        for _ in range(200):
            with precision.strict_fp32():
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    bad.append(1)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(DEADLINE_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, False)
    assert precision._depth == 0 and precision._saved is None
