"""`cli generate` and `cli serve` with the mesh flags, in subprocesses on the
CPU: `tests/torch_tiny_cli.py` runs the port's command line at the tiny
configs, and `--dp 2` spawns two gloo ranks of it.

`generate --dp 2` and `generate --sp 2 --tp 2` (four ranks) write the PCM of
`--dp 1` (within the pipeline tests' 2.5 PCM steps), and `ACESTEP_TPU_DP=2`
without the flag does what `--dp 2` does; `generate --tp 2 --thinking` splits
the planner too and writes the PCM of `--thinking` on one process; a `--tp`
that does not divide the DiT's heads fails on every rank; `serve --dp 2` and
`serve --tp 2` (a thinking job, on the split planner) answer a batch-2 job
over loopback HTTP, then stop on SIGTERM with every rank gone. Every wait is
bounded.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
import wave

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CLI = [sys.executable, os.path.join(HERE, "torch_tiny_cli.py")]
GENERATE = ["generate", "--device", "cpu", "--random-init", "--batch-size", "2", "--caption", "warm lofi beat",
            "--seed", "3", "--format", "wav"]
DEADLINE_S = 120.0


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACESTEP_TPU_")}
    return {**env, **extra}


def _pcm(path) -> np.ndarray:
    with wave.open(str(path)) as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").reshape(-1, w.getnchannels()).T


def _wavs(d) -> dict:
    return {p: _pcm(os.path.join(d, p)) for p in sorted(os.listdir(d)) if p.endswith(".wav")}


def _ranks_of(pid: int) -> list:
    """Pids of the spawned ranks (`spawn_main`) whose parent is `pid`."""
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid and b"spawn_main" in cmd:
            out.append(int(d))
    return out


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """`generate` at --dp 1, at --dp 2, with ACESTEP_TPU_DP=2, at --sp 2
    --tp 2, and with --thinking at 1 x 1 x 1 and at --tp 2, all at once:
    {name: (exit code, stdout, stderr, output dir)}."""
    d = tmp_path_factory.mktemp("cli")
    runs = {"dp1": (["--dp", "1"], {}), "dp2": (["--dp", "2"], {}), "env": ([], {"ACESTEP_TPU_DP": "2"}),
            "sp2tp2": (["--sp", "2", "--tp", "2"], {}), "think1": (["--thinking"], {}),
            "think_tp2": (["--tp", "2", "--thinking"], {})}
    procs = {name: subprocess.Popen(CLI + GENERATE + ["--output-dir", str(d / name)] + flags, env=_env(**env),
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for name, (flags, env) in runs.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=DEADLINE_S)
            out[name] = (p.returncode, stdout, stderr, d / name)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_generate_dp2_writes_the_pcm_of_dp1(generated):
    rc1, out1, err1, d1 = generated["dp1"]
    rc2, out2, err2, d2 = generated["dp2"]
    assert rc1 == 0, err1
    assert rc2 == 0, err2
    assert "mesh enabled: dp=2 sp=1 tp=1" in out2 and "mesh enabled" not in out1
    assert out2.count("Generated 2 audio(s)") == 1  # rank 0 alone prints
    want, got = _wavs(d1), _wavs(d2)
    assert len(want) == 2 and sorted(got) == sorted(want)
    for name, pcm in want.items():
        assert got[name].shape == pcm.shape and np.abs(pcm).max() > 0
        assert np.abs(got[name].astype(int) - pcm.astype(int)).max() <= 2, name


def test_generate_takes_dp_from_the_environment(generated):
    rc, out, err, d = generated["env"]
    assert rc == 0, err
    assert "mesh enabled: dp=2 sp=1 tp=1" in out
    want, got = _wavs(generated["dp2"][3]), _wavs(d)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])


def test_generate_sp2_tp2_writes_the_pcm_of_dp1(generated):
    rc1, _, err1, d1 = generated["dp1"]
    rc, out, err, d = generated["sp2tp2"]
    assert rc1 == 0, err1
    assert rc == 0, err
    assert "mesh enabled: dp=1 sp=2 tp=2" in out and "device collectives on gloo" in out
    assert out.count("Generated 2 audio(s)") == 1
    want, got = _wavs(d1), _wavs(d)
    assert len(want) == 2 and sorted(got) == sorted(want)
    for name, pcm in want.items():
        assert got[name].shape == pcm.shape
        assert np.abs(got[name].astype(int) - pcm.astype(int)).max() <= 2, name


def test_generate_tp2_thinking_splits_the_planner(generated):
    """`generate --tp 2 --thinking`: both ranks load the planner and split it
    over the mesh (rank 0 prints the planner's mesh once); the planner's
    plan and the DiT's PCM equal one process's (PCM within 2 steps)."""
    rc1, out1, err1, d1 = generated["think1"]
    rc, out, err, d = generated["think_tp2"]
    assert rc1 == 0, err1
    assert rc == 0, err
    assert [ln for ln in out.splitlines() if ln.startswith("planner mesh")] == [
        "planner mesh: tp=2 on ranks 0-1 (dp group 0, sp 0; device collectives on gloo)"]
    assert "planner mesh" not in out1 and out.count("Generated 2 audio(s)") == 1
    want, got = _wavs(d1), _wavs(d)
    assert len(want) == 2 and sorted(got) == sorted(want)
    for name, pcm in want.items():
        assert got[name].shape == pcm.shape and np.abs(pcm).max() > 0
        assert np.abs(got[name].astype(int) - pcm.astype(int)).max() <= 2, name
    for name in want:
        sidecar = name[:-len(".wav")] + ".json"
        with open(os.path.join(d1, sidecar)) as f1, open(os.path.join(d, sidecar)) as f2:
            a, b = json.load(f1), json.load(f2)
        assert a["metas"] and a["audio_codes"] and (a["metas"], a["audio_codes"]) == (b["metas"], b["audio_codes"])


def test_generate_refuses_sp_and_tp():
    """The refusal that remains on the command line: a tp that does not
    divide the DiT's 4 heads fails on every rank, before any request."""
    r = subprocess.run(CLI + GENERATE + ["--tp", "3"], env=_env(), capture_output=True, text=True,
                       timeout=DEADLINE_S)
    assert r.returncode != 0 and "tp=3 does not divide the DiT's num_attention_heads (4)" in r.stderr, r.stderr
    assert "Generated" not in r.stdout


def _lines(stream, q):
    for line in stream:
        q.put(line)


def _call(port, path, body):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("POST", path, body=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    r = c.getresponse()
    out = json.loads(r.read())
    c.close()
    return r.status, out


def _serve_round(tmp_path, flags, thinking: bool = False) -> list:
    """`serve` with `flags` on two ranks: one batch-2 job over loopback HTTP
    (with the planner's `thinking` or not), then SIGTERM; every rank gone.
    Returns the server's output lines."""
    p = subprocess.Popen(CLI + ["serve", "--device", "cpu", "--random-init", *flags, "--host", "127.0.0.1",
                                "--port", "0", "--output-dir", str(tmp_path)],
                         env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines: queue.Queue = queue.Queue()
    threading.Thread(target=_lines, args=(p.stdout, lines), daemon=True).start()
    seen = []
    try:
        deadline = time.time() + DEADLINE_S
        port = None
        while port is None:
            line = lines.get(timeout=max(0.1, deadline - time.time()))
            seen.append(line)
            if line.startswith("listening on "):
                port = int(line.rsplit(":", 1)[1])
        ranks = _ranks_of(p.pid)
        assert len(ranks) == 2, seen
        status, out = _call(port, "/release_task", dict(caption="warm lofi beat", duration=2.0, thinking=thinking,
                                                        batch_size=2, seed=3))
        assert status == 200, out
        tid = out["task_id"]
        while True:
            res = _call(port, "/query_result", {"task_ids": [tid]})[1]["results"][0]
            if res["status"] in (1, 2):
                break
            assert time.time() < deadline, res
            time.sleep(0.05)
        assert res["status"] == 1, res
        paths = res["result"]["audio_paths"]
        assert len(paths) == 2 and all(os.path.exists(x) for x in paths)
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0, "".join(seen)
        assert not any(_alive(pid) for pid in ranks)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return seen


def test_serve_dp2_answers_and_stops_clean(tmp_path):
    _serve_round(tmp_path, ["--dp", "2"])


def test_serve_tp2_answers_and_stops_clean(tmp_path):
    """`serve --tp 2`: the decoder and the planner split over two ranks;
    rank 0 prints the planner's mesh once, and a thinking job runs on it."""
    seen = _serve_round(tmp_path, ["--tp", "2"], thinking=True)
    assert any(ln.startswith("mesh enabled: dp=1 sp=1 tp=2") for ln in seen), seen
    assert [ln for ln in seen if ln.startswith("planner mesh")] == [
        "planner mesh: tp=2 on ranks 0-1 (dp group 0, sp 0; device collectives on gloo)\n"]


def test_dp2_without_a_card_needs_device_cpu(monkeypatch):
    """`--dp 2` without a card and without `--device cpu` raises before any
    rank starts."""
    import torch

    from acestep_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["generate", "--random-init", "--caption", "x", "--dp", "2"],
                 ["serve", "--random-init", "--port", "0", "--dp", "2"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
