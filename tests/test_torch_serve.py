"""The port's REST server over real loopback HTTP (CPU, fp32, tiny configs).

The job flow (release -> query -> /v1/audio), 429 on a full queue, API-key
gating, multipart upload, `/v1/generate_stream`, dynamic batching of queued
jobs, the pipelined worker against the serial one, `/v1/reinitialize` from
`tests/goldens/checkpoint_tiny`, the chat API (streaming and not), and the
training and dataset routes' answers to bodies that reach no handler, held
against the JAX package's server. Otherwise the port alone: its requests are
compared with its own direct calls. Every test shuts its server down and
bounds every wait (a poll deadline of 60 s at most), so a hang fails the
test instead of stalling the suite.
"""

import http.client
import io
import json
import os
import queue
import tempfile
import threading
import time
import wave
from urllib.parse import quote

import numpy as np
import pytest
import torch

import acestep_tpu_torch.pipeline.handler as TH
from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config
from acestep_tpu_torch.service.api_server import serve
from acestep_tpu_torch.utils import flac

TINY_DIT = dict(
    hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
    num_key_value_heads=2, head_dim=16, sliding_window=8, text_hidden_dim=32,
    num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
    num_attention_pooler_hidden_layers=1, fsq_dim=64, timbre_fix_frame=10,
)
TINY_VAE = dict(
    encoder_hidden_size=128, downsampling_ratios=(2, 4, 4), channel_multiples=(1, 1, 1),
    decoder_channels=16, decoder_input_channels=64, audio_channels=2, sampling_rate=800,
)
TINY_TEXT = dict(
    vocab_size=300, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
    num_attention_heads=4, num_key_value_heads=2, head_dim=8,
)
BUCKETS = dict(LATENT_BUCKETS=(64, 128, 256), TEXT_BUCKETS=(32, 64), LYRIC_BUCKETS=(32, 64))
CKPT = os.path.join(os.path.dirname(__file__), "goldens", "checkpoint_tiny")
DEADLINE_S = 60.0
JOB = dict(caption="test song", duration=2.0, thinking=False, batch_size=1, seed=3)
SAMPLES = 250 * 32  # the service clamps durations up to 10 s: 250 latent frames of 32 samples


def _handler():
    h = TH.AceStepHandler(AceStepConfig(**TINY_DIT), OobleckConfig(**TINY_VAE), Qwen3Config(**TINY_TEXT),
                          dtype=torch.float32, device="cpu")
    h.initialize_service(random_init=True)
    return h


@pytest.fixture(scope="module")
def dit():
    with pytest.MonkeyPatch.context() as mp:
        for name, val in BUCKETS.items():
            mp.setattr(TH, name, val)
        yield _handler()


class Server:
    """A port server on a free loopback port, with JSON helpers."""

    def __init__(self, dit, out_dir, llm=None, serve_fn=serve, **kw):
        self.server = serve_fn(dit, llm, host="127.0.0.1", port=0, output_dir=str(out_dir), **kw)
        self.service = self.server.service
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    def request(self, method, path, body=None, headers=None, raw=False):
        c = http.client.HTTPConnection("127.0.0.1", self.port, timeout=DEADLINE_S)
        data = body if isinstance(body, bytes) or body is None else json.dumps(body).encode()
        c.request(method, path, body=data, headers={"Content-Type": "application/json", **(headers or {})})
        r = c.getresponse()
        out = r.read()
        c.close()
        return r.status, (out if raw else json.loads(out)), r

    def post(self, path, body, **kw):
        status, out, _ = self.request("POST", path, body, **kw)
        return status, out

    def get(self, path, **kw):
        status, out, _ = self.request("GET", path, **kw)
        return status, out

    def release(self, **fields):
        status, out = self.post("/release_task", {**JOB, **fields})
        assert status == 200, out
        return out["task_id"]

    def wait(self, ids):
        """Poll until every job is terminal; returns {task_id: result}."""
        deadline = time.time() + DEADLINE_S
        while True:
            res = self.post("/query_result", {"task_ids": list(ids)})[1]["results"]
            if all(r["status"] in (1, 2) for r in res):
                return {r["task_id"]: r for r in res}
            assert time.time() < deadline, res
            time.sleep(0.05)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


@pytest.fixture
def server(dit, tmp_path):
    s = Server(dit, tmp_path / "out")
    yield s
    s.close()


def _read_pcm(path):
    """int16 (2, L) of a saved FLAC or 16-bit WAV."""
    with open(path, "rb") as f:
        blob = f.read()
    if path.endswith(".flac"):
        pcm, _, bps = flac.decode(blob)
        assert bps == 16
        return pcm.astype(np.int16)
    with wave.open(io.BytesIO(blob)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels()).T


def test_job_flow(server, dit):
    """release -> query -> /v1/audio: a FLAC (the default format) with its
    sidecar, the audio the direct service call gives; health, models, stats
    and logs answer; unknown and malformed task ids fail cleanly."""
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    assert server.get("/health")[1] == {"status": "ok", "initialized": True}
    status, page, _ = server.request("GET", "/", raw=True)
    assert status == 200 and b"<html" in page
    models = server.get("/v1/models")[1]
    assert models["models"][0]["id"] == models["data"][0]["id"] == "acestep-v15-tpu"
    tid = server.release()
    res = server.wait([tid])[tid]
    assert res["status"] == 1, res
    path, side = res["result"]["audio_paths"][0], res["result"]["params_paths"][0]
    assert path.endswith(".flac") and os.path.exists(side)
    assert res["result"]["seeds"] == [3]
    want = generate_music(dit, None, GenerationParams(**{k: v for k, v in JOB.items() if k != "batch_size"}),
                          GenerationConfig(batch_size=1), save_audio=False).audios[0]["audio"]
    np.testing.assert_array_equal(_read_pcm(path), want)
    status, body, resp = server.request("GET", "/v1/audio?path=" + quote(path), raw=True)
    assert status == 200 and body == open(path, "rb").read()
    assert server.get("/v1/audio?path=" + quote("/etc/passwd"))[0] == 404
    stats = server.get("/v1/stats")[1]
    assert stats["jobs"] >= 1 and stats["by_status"].get("succeeded", 0) >= 1
    assert server.get("/v1/logs?n=5")[0] == 200
    res = server.post("/query_result", {"task_ids": ["nope", None]})[1]["results"]
    assert res[0]["status"] == 2 and res[0]["error"] == "unknown task"
    assert res[1]["status"] == 2 and res[1]["error"] == "bad task id"
    assert server.get("/v1/unknown")[0] == 404


def test_queue_full_is_429(server):
    """A full queue answers 429 and marks the refused job failed, instead of
    blocking the HTTP thread."""
    full = queue.Queue(maxsize=1)
    full.put_nowait("sentinel")
    server.service.queue = full  # the worker blocks on the old queue
    status, out = server.post("/release_task", JOB)
    assert (status, out) == (429, {"error": "queue full"})
    status, out, _ = server.request("POST", "/v1/generate_stream", JOB)
    assert status == 429


def test_concurrent_submits_admit_up_to_the_limit(server, monkeypatch):
    """Twelve threads submit at once into a queue of five (the worker holds
    no lock and waits on its old queue): exactly five are admitted, each at
    its own position, and the other seven answer 429 and are marked failed."""
    import sys

    import acestep_tpu_torch.service.api_server as api

    monkeypatch.setattr(api, "MAX_QUEUE", 5)
    server.service.queue = queue.Queue(maxsize=api.MAX_QUEUE)
    results, start = [], threading.Barrier(12)

    def submit(i):
        start.wait(timeout=DEADLINE_S)
        results.append(server.post("/release_task", {**JOB, "seed": i}))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=DEADLINE_S)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(results) == 12
    admitted = [out for status, out in results if status == 200]
    assert sorted(out["queue_position"] for out in admitted) == [0, 1, 2, 3, 4]
    assert sorted(status for status, _ in results) == [200] * 5 + [429] * 7
    failed = [j for j in server.service.store._jobs.values() if j["status"] == "failed"]
    assert len(failed) == 7 and all(j["error"] == "queue full" for j in failed)


def test_api_key_gating(dit, tmp_path):
    out_dir = tmp_path / "outputs"
    out_dir.mkdir()
    (out_dir / "a.wav").write_bytes(b"RIFFdata")
    s = Server(dit, out_dir, api_key="sek")
    try:
        assert s.get("/health")[0] == 200
        assert s.request("GET", "/", raw=True)[0] == 200
        for path in ("/v1/stats", "/v1/logs", "/v1/models", "/v1/stats?key=sek"):
            assert s.get(path)[0] == 401, path
        assert s.get("/v1/stats", headers={"X-API-Key": "sek"})[0] == 200
        assert s.get("/v1/stats", headers={"Authorization": "Bearer sek"})[0] == 200
        assert s.get("/v1/stats", headers={"X-API-Key": "wrong"})[0] == 401
        assert s.post("/query_result?key=sek", {"task_ids": []})[0] == 401
        assert s.post("/query_result", {"task_ids": []}, headers={"X-API-Key": "sek"})[0] == 200
        assert s.post("/release_task", JOB)[0] == 401
        ok = s.request("GET", "/v1/audio?path=" + quote(str(out_dir / "a.wav")) + "&key=sek", raw=True)
        assert ok[0] == 200 and ok[1] == b"RIFFdata"
    finally:
        s.close()


def test_multipart_upload(server, tmp_path, monkeypatch):
    """A multipart /release_task with a WAV source runs a repaint; the
    uploaded temp file is gone when the job is done. The upload lands in
    this test's own temp directory: the JAX package's twin asserts that the
    shared one holds no `acestep_upload_*` file, and the two can run at
    once."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(48_000)
        w.writeframes((np.random.default_rng(0).standard_normal(2 * 96_000) * 3000).astype(np.int16).tobytes())
    boundary = "portboundary7"
    fields = {"task_type": "repaint", "caption": "repaint me", "duration": "2.0", "thinking": "false",
              "batch_size": "1", "audio_format": "wav", "seed": "5", "repainting_start": "0.0",
              "repainting_end": "1.0"}
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in fields.items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="src_audio"; filename="src.wav"\r\n'
                 f"Content-Type: audio/wav\r\n\r\n".encode() + buf.getvalue() + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    status, out = server.post("/release_task", b"".join(parts),
                              headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    assert status == 200, out
    payload = server.service.store.get(out["task_id"])["payload"]
    assert payload["seed"] == 5 and payload["thinking"] is False and payload["src_audio"].endswith(".wav")
    assert os.path.dirname(payload["src_audio"]) == str(tmp_path)
    res = server.wait([out["task_id"]])[out["task_id"]]
    assert res["status"] == 1, res
    assert res["result"]["audio_paths"][0].endswith(".wav")
    assert not os.path.exists(payload["src_audio"])


def test_generate_stream(server, monkeypatch):
    """/v1/generate_stream: one WAV response fed chunk by chunk (10 s, the
    service's shortest duration: 4 chunks at a 64-frame core), its bytes
    equal to the job's saved file and to a released job of the same seed;
    batch 2 is refused."""
    monkeypatch.setattr(TH.AceStepHandler, "_decode_chunk_core", staticmethod(lambda t, b: 64))
    req = {**JOB, "seed": 11, "audio_format": "wav"}
    status, body, resp = server.request("POST", "/v1/generate_stream", req, raw=True)
    assert status == 200 and resp.getheader("Content-Type") == "audio/wav"
    assert len(body) == int(resp.getheader("Content-Length")) == 44 + 2 * 2 * SAMPLES
    with wave.open(io.BytesIO(body)) as w:
        assert (w.getnchannels(), w.getframerate(), w.getnframes()) == (2, 800, SAMPLES)
    tid = resp.getheader("X-Task-Id")
    res = server.wait([tid])[tid]
    assert res["status"] == 1 and res["result"]["streamed_chunks"] == 4, res
    assert open(res["result"]["audio_paths"][0], "rb").read() == body
    tid2 = server.release(**req)
    res2 = server.wait([tid2])[tid2]
    assert open(res2["result"]["audio_paths"][0], "rb").read() == body
    status, out, _ = server.request("POST", "/v1/generate_stream", {**req, "batch_size": 2})
    assert status == 400


@pytest.mark.parametrize("hbm_gb", [None, "8"])
def test_dynamic_batching(dit, tmp_path, monkeypatch, hbm_gb):
    """Compatible jobs queued behind a running one run as one merged batch
    (each with its own file and seed, merged_share 1/2); a job of another
    duration is held and runs alone, as does the running one. On a card of
    8 GB (`ACESTEP_MAX_HBM_GB`) the memory policy allows batches of one
    row, so nothing merges."""
    if hbm_gb is not None:
        monkeypatch.setenv("ACESTEP_MAX_HBM_GB", hbm_gb)
    server = Server(dit, tmp_path / "out")
    try:
        svc = server.service
        assert (svc.memory_policy is None) == (hbm_gb is None)
        assert svc.model_lock.acquire(timeout=10)  # keep the worker at its first job
        try:
            lead = server.release(caption="lead", duration=4.0, seed=1)
            deadline = time.time() + DEADLINE_S
            while svc.queue.qsize():  # the worker took the lead job and waits on the lock
                assert time.time() < deadline
                time.sleep(0.01)
            merged = [server.release(caption=c, duration=3.0, seed=100 + i) for i, c in enumerate(("alpha", "beta"))]
            odd = server.release(caption="odd", seed=7)
        finally:
            svc.model_lock.release()
        res = server.wait([lead, *merged, odd])
    finally:
        server.close()
    assert all(r["status"] == 1 for r in res.values()), res
    if hbm_gb is None:
        assert [res[t]["result"]["extra"].get("merged_batch") for t in merged] == [2, 2]
        assert [res[t]["result"]["extra"]["time_costs"]["merged_share"] for t in merged] == [0.5, 0.5]
    else:
        assert svc.memory_policy.max_batch_size == 1
        assert [res[t]["result"]["extra"].get("merged_batch") for t in merged] == [None, None]
    assert [res[t]["result"]["seeds"][0] for t in merged] == [100, 101]
    assert res[merged[0]]["result"]["audio_paths"] != res[merged[1]]["result"]["audio_paths"]
    for t in (lead, odd):
        assert "merged_batch" not in res[t]["result"]["extra"]


@pytest.mark.parametrize("merge", ["0", "1"])
def test_pipelined_worker_matches_serial(dit, tmp_path, monkeypatch, merge):
    """Three queued jobs through the pipelined worker (job N's finish after
    job N+1's dispatch) give the serial worker's files byte for byte, with
    merging off and on. The worker is held while jobs 2 and 3 queue, so both
    workers see the same groups (with merging: job 1 alone, then 2 and 3)."""
    monkeypatch.setenv("ACESTEP_MERGE_JOBS", merge)
    files = {}
    for pipeline in ("1", "0"):
        monkeypatch.setenv("ACESTEP_PIPELINE_JOBS", pipeline)
        s = Server(dit, tmp_path / f"out{pipeline}")
        try:
            assert s.service.model_lock.acquire(timeout=10)
            try:
                ids = [s.release(caption="pipelined 0", seed=100, audio_format="wav")]
                deadline = time.time() + DEADLINE_S
                while s.service.queue.qsize():
                    assert time.time() < deadline
                    time.sleep(0.01)
                ids += [s.release(caption=f"pipelined {i}", seed=100 + i, audio_format="wav") for i in (1, 2)]
            finally:
                s.service.model_lock.release()
            res = s.wait(ids)
            merged = [res[t]["result"]["extra"].get("merged_batch") for t in ids]
            assert merged == ([None, 2, 2] if merge == "1" else [None] * 3), merged
            assert all(res[t]["status"] == 1 for t in ids), res
            files[pipeline] = [open(res[t]["result"]["audio_paths"][0], "rb").read() for t in ids]
        finally:
            s.close()
    assert files["1"] == files["0"]


def test_reinitialize_from_checkpoint_tiny(tmp_path):
    """/v1/reinitialize loads the repo's tiny reference-layout checkpoint into
    a running random-init server; a job then completes on it."""
    with pytest.MonkeyPatch.context() as mp:
        for name, val in BUCKETS.items():
            mp.setattr(TH, name, val)
        h = _handler()
        s = Server(h, tmp_path / "out")
        try:
            status, out = s.post("/v1/reinitialize", {"checkpoint_dir": CKPT})
            assert status == 200 and out["success"], out
            assert h.config.audio_acoustic_hidden_dim == 16
            tid = s.release(caption="after reload", audio_format="wav")
            res = s.wait([tid])[tid]
            assert res["status"] == 1, res
            assert os.path.exists(res["result"]["audio_paths"][0])
            status, out = s.post("/v1/reinitialize", {"checkpoint_dir": str(tmp_path / "none"), "random_init": False})
            assert status == 500 and not out["success"]
        finally:
            s.close()


def test_chat_completions(server):
    """Non-streaming chat: a completion whose content holds the saved audio
    as base64 WAV; streaming: SSE chunks ending in the audio and [DONE]; a
    malformed body is a 400 on both paths."""
    import base64

    body = {"messages": [{"role": "user", "content": "tiny test, 2 seconds"}], "seed": 4}
    status, out = server.post("/v1/chat/completions", body)
    assert status == 200 and out["object"] == "chat.completion", out
    content = out["choices"][0]["message"]["content"]
    assert out["choices"][0]["finish_reason"] == "stop"
    audio = [c for c in content if c["type"] == "audio"]
    assert len(audio) == 1 and audio[0]["audio"]["format"] == "wav"
    with wave.open(io.BytesIO(base64.b64decode(audio[0]["audio"]["data"]))) as w:
        assert (w.getnchannels(), w.getnframes()) == (2, SAMPLES)
    status, raw, resp = server.request("POST", "/v1/chat/completions", {**body, "stream": True}, raw=True)
    assert status == 200 and resp.getheader("Content-Type").startswith("text/event-stream")
    lines = [ln[6:] for ln in raw.decode().splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    events = [json.loads(ln) for ln in lines[:-1]]
    assert events[0]["object"] == "chat.completion.chunk"
    last = events[-1]["choices"][0]
    assert last["finish_reason"] == "stop" and last["delta"]["content"][0]["type"] == "audio"
    for stream in (False, True):
        bad = {**body, "stream": stream, "audio_config": {"duration": "thirty"}}
        assert server.post("/v1/chat/completions", bad)[0] == 400


@pytest.fixture(scope="module")
def jax_server(tmp_path_factory):
    """The JAX package's server with no handlers: these requests reach none."""
    from acestep_tpu.service.api_server import serve as jax_serve

    s = Server(None, tmp_path_factory.mktemp("jax_out"), serve_fn=jax_serve)
    yield s
    s.close()


@pytest.mark.parametrize("method,path", [
    ("POST", "/v1/train/start"),
    ("POST", "/v1/train/list"),
    ("POST", "/v1/dataset/scan"),
    ("GET", "/v1/dataset/samples"),
    ("PUT", "/v1/dataset/sample/0"),
])
def test_training_routes_answer_as_jax(server, jax_server, method, path):
    """The training and dataset routes with an empty body, before any run or
    scan: the port's status and body equal the JAX server's."""
    body = {} if method != "GET" else None
    status, out, _ = server.request(method, path, body)
    want_status, want, _ = jax_server.request(method, path, body)
    assert (status, sorted(out)) == (want_status, sorted(want))
    assert out == want and status != 501


def test_lora_routes_lifecycle(server, dit, tmp_path, monkeypatch):
    """`/v1/lora/*` over HTTP with JAX's bodies: load, status, scale, toggle,
    unload; 400 on a missing field or an unknown name, 500 on an unreadable
    file. The served latents under each state: on, they are a direct request
    on the merged decoder bit for bit; at scale 0.5 they differ from on and
    off; toggled off and unloaded, they are the base request bit for bit."""
    from acestep_tpu_torch.training.lora import init_lora_params, merge_lora

    lora = init_lora_params(0, dit.params["decoder"], rank=4)
    gen = torch.Generator().manual_seed(1)
    for ab in lora.values():
        ab["b"] = torch.randn(ab["b"].shape, generator=gen) * 0.05
    path = str(tmp_path / "adapter.npz")
    meta = {"rank": 4, "alpha": 4.0, "adapter_type": "lora", "step": 3}
    np.savez(path, **{f"{p}|{k}": v.numpy() for p, ab in lora.items() for k, v in ab.items()},
             __meta__=np.asarray(json.dumps(meta)))
    seen = []
    orig = dit.generate_music

    def spy(*a, **kw):
        out = orig(*a, **kw)
        seen.append(out["latents"])
        return out

    monkeypatch.setattr(dit, "generate_music", spy)

    def served():
        tid = server.release()
        assert server.wait([tid])[tid]["status"] == 1
        return seen[-1]

    try:
        base = served()
        assert server.post("/v1/lora/load", {"name": "style", "path": path}) == (200, {"success": True,
                                                                                       "meta": meta})
        status, out = server.post("/v1/lora/status", {})
        assert status == 200 and out["adapters"] == {"style": {"enabled": True, "scale": 1.0, "meta": meta,
                                                               "path": path}}
        on = served()
        with monkeypatch.context() as mp:
            mp.setattr(dit, "params", {**dit.params, "decoder": merge_lora(dit.params["decoder"], lora, alpha=4.0,
                                                                           rank=4)})
            mp.setattr(dit, "lora", TH.LoRARegistry())
            from acestep_tpu_torch.service.inference import generate_music
            from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

            r = generate_music(dit, None, GenerationParams(**{k: v for k, v in JOB.items() if k != "batch_size"}),
                               GenerationConfig(batch_size=1), save_audio=False)
            assert r.success, r.error
            np.testing.assert_array_equal(seen[-1], on)
        assert server.post("/v1/lora/scale", {"name": "style", "scale": 0.5}) == (200, {"success": True})
        half = served()
        assert server.post("/v1/lora/toggle", {"name": "style", "enabled": False}) == (200, {"success": True,
                                                                                             "enabled": False})
        off = served()
        np.testing.assert_array_equal(off, base)
        for a, b in ((on, base), (half, base), (half, on)):
            assert np.linalg.norm(a - b) / np.linalg.norm(b) > 1e-3
        assert server.post("/v1/lora/toggle", {"name": "style"})[1]["enabled"] is True
        for body, route in (({"name": "nope"}, "toggle"), ({"name": "nope", "scale": 2}, "scale"),
                            ({"name": "style"}, "scale"), ({"path": path}, "load")):
            status, out = server.post(f"/v1/lora/{route}", body)
            assert status == 400 and not out["success"] and "missing/unknown" in out["error"], (route, out)
        status, out = server.post("/v1/lora/load", {"name": "x", "path": str(tmp_path / "none.npz")})
        assert status == 500 and not out["success"]
        assert server.post("/v1/lora/unload", {"name": "style"}) == (200, {"success": True})
        assert server.post("/v1/lora/unload", {"name": "style"}) == (200, {"success": False})
        assert server.post("/v1/lora/status", {})[1]["adapters"] == {}
        np.testing.assert_array_equal(served(), base)
        assert server.get("/v1/lora/status")[0] == 404  # the routes are POST, as in JAX
    finally:
        for name in list(dit.lora_status()):
            dit.unload_lora(name)
