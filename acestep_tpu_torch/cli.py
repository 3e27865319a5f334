"""Command-line interface of the port: `generate`, `generate-examples`, `serve`,
`train`, `estimate`, `build-dataset`, `download`, `verify-checkpoint` and
`profile`.

Port of those subcommands of `acestep_tpu/cli.py`, with their flags, plus
`--device` (the card unless `cpu` is asked for). The JAX package's
persistent XLA compile cache has no counterpart: the port compiles only its
CUDA and C++ libraries, which it caches under `acestep_tpu_torch/_build/`.

`generate` and `serve` take the mesh flags `--dp`, `--sp` and `--tp`
(defaults `ACESTEP_TPU_DP` / `_SP` / `_TP`, else 1). Above 1 x 1 x 1 the
command runs on dp·sp·tp ranks (`parallel.mesh.launch`): it spawns them
itself, or runs as one rank of the group torchrun started. Rank r takes
`cuda:{r % device_count}` (two ranks may share a card), or the CPU with
`--device cpu` (gloo either way). Rank 0 loads the planner, prints, saves and
serves HTTP; the other ranks compute their rows of each request
(`AceStepHandler.serve_followers`) until rank 0 stops them. Only dp runs:
sp or tp above 1 raises (ROADMAP A.11b).

- `generate` runs the port's `service.inference.generate_music`;
  `--thinking` runs the 5 Hz LM planner (`LLMHandler()`, the 0.6B size)
  before the DiT, and `--steps` above 8 runs the base model's guided
  sampling (APG at the service's default scale 7.0). Saves each result in
  `--format` (flac by default; wav, wav16, wav32, or any format ffmpeg
  writes) with its params sidecar, named by the request's deterministic key.
- `generate-examples` drafts `--num` samples with the planner's
  create_sample and writes each as `example_NN.json` in the params-file
  format. Draft i takes seed i (the JAX command draws every example at
  seed 0, so its examples repeat).
- `serve` loads the DiT and the planner, runs `--warmup` requests, and
  starts the REST server (`service.api_server`), printing the port it bound.
- `train` fine-tunes a LoRA adapter on a preprocessed dataset
  (`training.dataset.PreprocessedDataset`) against the handler's own
  weights, `handler.params` as they are (the port's decoder layers are
  already the per-layer list the trainer takes); it writes `metrics.jsonl`,
  `checkpoints/step_N.pt` and `adapter.npz` under `--output-dir`.
- `estimate` ranks the decoder's attention projections by gradient
  sensitivity over `--num-batches` batches (`training.estimate`).
- `build-dataset` scans an audio directory, labels it (sidecars, CSV, and
  with `--label-with-lm` the planner) and preprocesses it into training
  tensors (`training.dataset_builder`).
- `download` ensures each model of `--models` in `--cache-dir`, component
  by component (`utils.downloader.ensure_components`); exit 1 while any
  component is missing. `verify-checkpoint` checks one directory (the LM
  layout with `--lm` or when the directory's name says lm); exit 1 when
  incomplete. Neither imports torch's CUDA side.
- `profile` times the Duration x Batch x Think x Steps matrix (wall, LM,
  DiT, VAE and transfer seconds; `--json-out` writes the rows with the JAX
  command's keys; `--trace-dir` writes a `torch.profiler` Chrome trace of
  each timed run), or with `--lm` the planner's prefill and code decode
  (tokens a second) at each batch of `--batches`.

Run as ``python -m acestep_tpu_torch.cli generate --random-init --thinking --caption "..."``,
``python -m acestep_tpu_torch.cli generate-examples --random-init --num 3`` or
``python -m acestep_tpu_torch.cli serve --random-init --port 8001 --warmup 1x30``,
``python -m acestep_tpu_torch.cli train --random-init --dataset-dir data --max-steps 100``,
``python -m acestep_tpu_torch.cli estimate --random-init --dataset-dir data --json-out ranks.json``,
``python -m acestep_tpu_torch.cli build-dataset --random-init --audio-dir songs --label-with-lm``,
``python -m acestep_tpu_torch.cli download --models acestep-v15-turbo``,
``python -m acestep_tpu_torch.cli verify-checkpoint checkpoints/acestep-v15-turbo`` or
``python -m acestep_tpu_torch.cli profile --random-init --durations 30,60 --batches 1,2 --json-out m.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=int(os.environ.get("ACESTEP_TPU_DP", 1)),
                   help="data-parallel mesh axis (shards the request batch)")
    p.add_argument("--sp", type=int, default=int(os.environ.get("ACESTEP_TPU_SP", 1)),
                   help="sequence-parallel mesh axis (not ported yet)")
    p.add_argument("--tp", type=int, default=int(os.environ.get("ACESTEP_TPU_TP", 1)),
                   help="tensor-parallel mesh axis (not ported yet)")


def _on_ranks(run, args) -> int:
    """`run(args, leader)` here at 1 x 1 x 1; else on every rank of the
    mesh, returning rank 0's exit code. Refuses sp and tp, and a run without
    a card and without `--device cpu`, before any rank starts."""
    n = args.dp * args.sp * args.tp
    if n <= 1:
        return run(args, True)
    from acestep_tpu_torch.device import resolve_device
    from acestep_tpu_torch.parallel.mesh import launch, refuse_sp_tp

    refuse_sp_tp(args.sp, args.tp)
    resolve_device(args.device)
    return launch(_rank, n, run, args)


def _rank(run, args) -> int:
    import torch.distributed as dist

    return run(args, dist.get_rank() == 0)


def _load_dit(args):
    """The DiT handler on this rank's device, loaded, with the mesh flags
    applied (rank 0 prints its load line)."""
    from acestep_tpu_torch.parallel.mesh import rank_device
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    mesh = args.dp * args.sp * args.tp > 1
    dit = AceStepHandler(device=rank_device(args.device) if mesh else args.device)
    msg = dit.initialize_service(args.checkpoint_dir, random_init=args.random_init or None)
    dit.enable_mesh(dp=args.dp, sp=args.sp, tp=args.tp)
    if dit.mesh is None or dit.mesh.is_leader:
        print(msg, flush=True)
        if dit.mesh is not None:
            print(f"mesh enabled: dp={args.dp} sp={args.sp} tp={args.tp}", flush=True)
    return dit


def cmd_generate(args) -> int:
    return _on_ranks(_generate, args)


def _generate(args, leader: bool) -> int:
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    dit = _load_dit(args)
    if not leader:
        dit.serve_followers()
        return 0
    try:
        llm = None
        if args.thinking:
            llm = LLMHandler(device=dit.device)
            print(llm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None))
        params = GenerationParams(
            caption=args.caption,
            lyrics=args.lyrics,
            duration=args.duration,
            task_type=args.task,
            thinking=args.thinking,
            seed=args.seed,
            inference_steps=args.steps,
            shift=args.shift,
        )
        cfg = GenerationConfig(
            batch_size=args.batch_size,
            audio_format=args.format,
            output_dir=args.output_dir,
            use_random_seed=args.seed < 0,
        )
        result = generate_music(dit, llm, params, cfg)
        print(result.status_message)
        if not result.success:
            print(result.error, file=sys.stderr)
            return 1
        for a in result.audios:
            print("  ", a["path"])
        print({k: round(v, 3) for k, v in result.extra_outputs["time_costs"].items()})
        return 0
    finally:
        dit.stop_followers()


def cmd_generate_examples(args) -> int:
    """Draft `--num` samples with the planner (create_sample) and write each
    as `<output-dir>/example_NN.json`, the params-file format of the JAX
    package's examples. Draft i takes seed i."""
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.service.inference import create_sample

    llm = LLMHandler(device=args.device)
    print(llm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None))
    os.makedirs(args.output_dir, exist_ok=True)
    written = 0
    for i in range(args.num):
        try:
            out = create_sample(llm, args.query, seed=i)
        except Exception as e:  # noqa: BLE001 — keep drafting the rest
            print(f"example {i + 1} failed: {e}", file=sys.stderr)
            continue
        md = out["metadata"]
        example = {
            "think": True,
            "caption": md.get("caption", ""),
            "lyrics": md.get("lyrics", "[Instrumental]"),
            "bpm": md.get("bpm"),
            "duration": md.get("duration"),
            "keyscale": md.get("keyscale", ""),
            "language": md.get("language", "unknown"),
            "timesignature": str(md.get("timesignature", "4")),
        }
        path = os.path.join(args.output_dir, f"example_{args.start_index + written:02d}.json")
        with open(path, "w", encoding="utf-8") as f:
            json.dump(example, f, indent=4, ensure_ascii=False)
        written += 1
        print(f"wrote {path}")
    return 0 if written else 1


def run_warmup(dit, warmup_spec: str, llm=None) -> None:
    """Run one request of each expected shape before the server binds its
    port, so the first requests do not pay the kernels' first calls and the
    allocator's growth. Spec: 'BxD,BxD,...' (batch x duration-seconds), e.g.
    '1x30,2x60'; the token 'lm' runs one planner draft (create_sample)."""
    for spec in warmup_spec.split(","):
        spec = spec.strip()
        if spec.lower() == "lm":
            if llm is None or not getattr(llm, "initialized", False):
                print("[warmup] lm requested but no LM initialized — skipped")
                continue
            t0 = time.time()
            llm.create_sample_from_query("warmup", seed=0)
            print(f"[warmup] lm draft ran in {time.time() - t0:.1f}s")
            continue
        b, _, d = spec.partition("x")
        b, d = int(b), float(d or 30)
        t0 = time.time()
        dit.generate_music(
            captions=["warmup"] * b, lyrics=["[Instrumental]"] * b,
            audio_duration=d, batch_size=b, seeds=list(range(b)),
            use_random_seed=False, decode_audio=True,
        )
        print(f"[warmup] {b}x{d:g}s ran in {time.time() - t0:.1f}s", flush=True)


def cmd_serve(args) -> int:
    # A named checkpoint must be complete before the port binds: abort with
    # the missing components named (the port has no downloader yet).
    if args.checkpoint_dir and not args.random_init:
        from acestep_tpu_torch.utils.downloader import DIT_CHECKPOINT_COMPONENTS, verify_checkpoint

        status = verify_checkpoint(args.checkpoint_dir, DIT_CHECKPOINT_COMPONENTS)
        missing = [c for c, good in status.items() if not good]
        if missing:
            print(f"checkpoint {args.checkpoint_dir} incomplete — missing: {', '.join(missing)}", file=sys.stderr)
            return 1
    return _on_ranks(_serve, args)


def _serve(args, leader: bool) -> int:
    """One rank of `serve`: rank 0 (or the only process) loads the planner
    and the extra DiT models and serves HTTP until an interrupt (SIGTERM too
    under a mesh) or `shutdown()`, then stops its followers."""
    import signal

    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.service.api_server import serve

    dit = _load_dit(args)
    if not leader:
        dit.serve_followers()
        return 0
    try:
        if dit.mesh is not None:
            signal.signal(signal.SIGTERM, _interrupt)
        llm = LLMHandler(device=dit.device)
        print(llm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None), flush=True)
        # More DiT models (ACESTEP_CONFIG_PATH2/3), chosen by a request's "model".
        extra = {}
        for n in (2, 3):
            path = os.environ.get(f"ACESTEP_CONFIG_PATH{n}")
            if path and os.path.isdir(path):
                h = AceStepHandler(device=dit.device)
                print(f"[model {n}] " + h.initialize_service(path))
                extra[os.path.basename(os.path.normpath(path))] = h
        if args.warmup:
            run_warmup(dit, args.warmup, llm=llm)

        server = serve(dit, llm, args.host, args.port, args.api_key, args.output_dir,
                       extra_dit_handlers=extra or None)
        print(f"listening on {args.host}:{server.server_address[1]}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            print("interrupted: stopping the server", flush=True)
        finally:
            server.server_close()
    finally:
        if dit.mesh is not None:
            signal.signal(signal.SIGINT, signal.SIG_IGN)  # the followers' stop must not be cut short
            dit.stop_followers()
    return 0


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def cmd_train(args) -> int:
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.training.dataset import PreprocessedDataset
    from acestep_tpu_torch.training.trainer import LoRAConfig, LoRATrainer, TrainingConfig

    handler = AceStepHandler(device=args.device)
    print(handler.initialize_service(args.checkpoint_dir, random_init=args.random_init or None), flush=True)
    ds = PreprocessedDataset(args.dataset_dir)
    # Training starts from the weights the handler serves; no second copy.
    trainer = LoRATrainer(
        handler.params,
        handler.config,
        LoRAConfig(rank=args.rank, alpha=args.alpha),
        TrainingConfig(
            learning_rate=args.lr,
            max_steps=args.max_steps,
            batch_size=args.batch_size,
            output_dir=args.output_dir,
            resume_from=args.resume_from,
        ),
    )
    for step, _, msg in trainer.train(ds.batches(args.batch_size)):
        if step % 10 == 0 or "[checkpoint]" in msg:
            print(msg, flush=True)
    print(f"done: adapter at {os.path.join(args.output_dir, 'adapter.npz')}")
    return 0


def cmd_estimate(args) -> int:
    """Gradient-sensitivity ranking of the decoder's attention projections."""
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.training.dataset import PreprocessedDataset
    from acestep_tpu_torch.training.estimate import run_estimation

    handler = AceStepHandler(device=args.device)
    print(handler.initialize_service(args.checkpoint_dir, random_init=args.random_init or None), flush=True)
    ds = PreprocessedDataset(args.dataset_dir)
    results = run_estimation(
        handler.params, handler.config, ds.batches(args.batch_size, shuffle=False),
        num_batches=args.num_batches, top_k=args.top_k, granularity=args.granularity, cfg_ratio=args.cfg_ratio,
    )
    print(f"{'rank':>4} {'sensitivity':>14}  module")
    for i, r in enumerate(results):
        print(f"{i + 1:>4} {r['sensitivity']:>14.5f}  {r['module']}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(results, f, indent=2)
    return 0


def cmd_build_dataset(args) -> int:
    """Scan, label and preprocess an audio directory into training tensors."""
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.training.dataset_builder import DatasetBuilder

    dit = AceStepHandler(device=args.device)
    print(dit.initialize_service(args.checkpoint_dir, random_init=args.random_init or None), flush=True)
    llm = None
    if args.label_with_lm:
        from acestep_tpu_torch.lm.handler import LLMHandler

        llm = LLMHandler(device=args.device)
        print(llm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None), flush=True)
    builder = DatasetBuilder(dit, llm)
    _, msg = builder.scan_directory(args.audio_dir)
    print(f"scan: {msg}", flush=True)
    if args.label_with_lm:
        for line in builder.label_all(format_lyrics=args.format_lyrics):
            print("  " + line, flush=True)
        print(f"labels saved to {builder.save_labels()}")
    out_dir = args.output_dir or args.audio_dir.rstrip("/") + "_tensors"
    _, msg = builder.preprocess_to_tensors(out_dir, max_duration=args.max_duration)
    print(msg)
    return 0


def cmd_download(args) -> int:
    """Ensure each model of `--models` component by component; 1 while any
    component of any of them is missing."""
    from acestep_tpu_torch.utils.downloader import ensure_components

    ok = True
    for name in [n.strip() for n in args.models.split(",") if n.strip()]:
        out = ensure_components(name, args.cache_dir)
        missing = [c for c, good in out["components"].items() if not good]
        state = "complete" if not missing else f"MISSING: {', '.join(missing)}"
        print(f"{name}: {out['path'] or '(no source reachable)'} — {state}"
              + ("  [downloaded]" if out["downloaded"] else ""))
        ok = ok and not missing
    return 0 if ok else 1


def cmd_verify_checkpoint(args) -> int:
    """Verify one checkpoint directory component by component (the DiT
    layout unless `--lm` or the directory's name says lm)."""
    from acestep_tpu_torch.utils.downloader import (
        DIT_CHECKPOINT_COMPONENTS,
        LM_CHECKPOINT_COMPONENTS,
        verify_checkpoint,
    )

    lm = args.lm or "lm" in os.path.basename(os.path.normpath(args.path)).lower()
    status = verify_checkpoint(args.path, LM_CHECKPOINT_COMPONENTS if lm else DIT_CHECKPOINT_COMPONENTS)
    for comp, good in status.items():
        print(f"  {comp:>14}: {'ok' if good else 'MISSING'}")
    if all(status.values()):
        print(f"{args.path}: complete")
        return 0
    print(f"{args.path}: INCOMPLETE")
    return 1


def _profile_lm(args) -> int:
    """Planner decode throughput (tokens a second) at each batch size: the
    prefill, then `lm.sampling.generate_codes_scan` on the device; the best
    of three timed runs after one untimed."""
    import numpy as np
    import torch

    from acestep_tpu_torch.lm import sampling
    from acestep_tpu_torch.lm.handler import LLMHandler

    lm = LLMHandler(device=args.device)
    print(lm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None), flush=True)
    n_steps = args.lm_tokens
    rows = []
    print(f"{'Batch':>6} {'Prefill(s)':>11} {'Decode(s)':>10} {'tok/s':>9}")
    for b in [int(x) for x in args.batches.split(",")]:
        prompts = ["# Caption\nan energetic synthwave track\n\n# Lyric\n[Instrumental]\n"] * b
        ids, mask, bucket = lm._encode_prompts(prompts, budget=n_steps + 8)
        code_start = max(lm.fsm.code_token_start, 0)
        n_codes = lm.fsm.num_code_tokens or min(4096, lm.config.vocab_size - code_start)

        @torch.inference_mode()
        def run():
            t0 = time.time()
            logits, cache = lm._prefill(ids, mask, bucket + n_steps + 8)
            positions = lm._tensor(mask.sum(axis=1).astype(np.int32))
            feed = torch.argmax(logits[:, code_start : code_start + n_codes], dim=-1) + code_start
            float(logits[:, :8].float().sum())  # waits for the prefill
            t1 = time.time()
            toks, _ = sampling.generate_codes_scan(
                lm.params, lm.config, feed, positions, cache, lm._generator(0), n_steps=n_steps - 1,
                code_start=code_start, n_codes=n_codes, temperature=0.85, top_k=0, top_p=0.9,
            )
            toks.cpu()
            return t1 - t0, time.time() - t1

        run()  # first calls: kernel loads and the allocator's growth
        pre, dec = min([run() for _ in range(3)], key=lambda x: x[1])
        # The first code comes from the prefill's logits (inside the prefill
        # span); the decode span covers n_steps - 1 tokens.
        rows.append({"batch": b, "prefill_s": pre, "decode_s": dec, "tok_s": b * (n_steps - 1) / dec})
        print(f"{b:>6} {pre:>11.3f} {dec:>10.3f} {rows[-1]['tok_s']:>9.0f}", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


def _traced(fn, trace_path: str):
    """Run `fn` under `torch.profiler` (the card's activity too when it has
    one) and write the Chrome trace to `trace_path` after `fn` returns."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        out = fn()
    prof.export_chrome_trace(trace_path)
    return out


def cmd_profile(args) -> int:
    """The Duration x Batch x Think x Steps matrix: wall, LM, DiT, VAE and
    transfer seconds of each cell after one untimed run."""
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    if args.lm:
        return _profile_lm(args)
    handler = AceStepHandler(device=args.device)
    print(handler.initialize_service(args.checkpoint_dir, random_init=args.random_init or None), flush=True)
    think_modes = [t.strip().lower() in ("1", "true", "on", "yes") for t in args.think.split(",")]
    llm = None
    if any(think_modes):
        from acestep_tpu_torch.lm.handler import LLMHandler

        llm = LLMHandler(device=args.device)
        print(llm.initialize(args.lm_checkpoint_dir, random_init=args.random_init or None), flush=True)
    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)

    rows = []
    print(f"{'Dur(s)':>7} {'Batch':>6} {'Think':>6} {'Steps':>6} {'Wall(s)':>8} "
          f"{'LM(s)':>7} {'DiT(s)':>8} {'VAE(s)':>8} {'Xfer(s)':>8} {'audio_s/s':>10}")
    for d in [int(x) for x in args.durations.split(",")]:
        for b in [int(x) for x in args.batches.split(",")]:
            for think in think_modes:
                for steps in [int(x) for x in args.steps.split(",")]:
                    def run():
                        lm_cost, codes = 0.0, None
                        if think and llm is not None:
                            lm_out = llm.generate_with_stop_condition(
                                caption="profiling run", lyrics="[Instrumental]", target_duration=float(d),
                                batch_size=b, seed=1,
                            )
                            lm_cost = lm_out["time_costs"].get("lm_total_time_cost", 0.0)
                            codes = lm_out.get("batch_audio_codes")
                        out = handler.generate_music(
                            captions=["profiling run"] * b, lyrics=["[Instrumental]"] * b,
                            audio_duration=float(d), batch_size=b, seeds=list(range(b)), use_random_seed=False,
                            inference_steps=None if steps == 8 else steps, audio_code_strings=codes,
                        )
                        return out, lm_cost

                    def timed():
                        # The wall covers the run alone: with --trace-dir, not
                        # the profiler's start and stop or the trace's export.
                        t0 = time.time()
                        out, lm_cost = run()
                        return out, lm_cost, time.time() - t0

                    run()  # first calls: kernel loads and the allocator's growth
                    if args.trace_dir:
                        name = f"profile_d{d}_b{b}_think{int(think)}_s{steps}.json"
                        out, lm_cost, wall = _traced(timed, os.path.join(args.trace_dir, name))
                    else:
                        out, lm_cost, wall = timed()
                    tc = out["time_costs"]
                    transfer = tc.get("vae_decode_transfer_time_cost", 0)
                    rows.append({
                        "duration": d, "batch": b, "think": think, "steps": out["num_steps"], "wall": wall,
                        "lm": lm_cost, "dit": tc["diffusion_time_cost"], "vae": tc.get("vae_decode_time_cost", 0),
                        "transfer": transfer, "throughput": b * d / wall,
                        "throughput_device": b * d / max(wall - transfer, 1e-6),
                    })
                    r = rows[-1]
                    print(f"{d:>7} {b:>6} {str(think):>6} {r['steps']:>6} {r['wall']:>8.2f} "
                          f"{r['lm']:>7.2f} {r['dit']:>8.2f} {r['vae']:>8.2f} "
                          f"{r['transfer']:>8.2f} {r['throughput']:>10.2f}", flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


def _model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--checkpoint-dir", default=os.environ.get("ACESTEP_CONFIG_PATH"))
    p.add_argument("--lm-checkpoint-dir", default=os.environ.get("ACESTEP_LM_MODEL_PATH"))
    p.add_argument("--random-init", action="store_true", help="dev mode: random weights")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")


def main(argv=None) -> int:
    from acestep_tpu_torch.utils.env import load_dotenv

    load_dotenv()  # .env -> environment variables (CLI arguments still win)
    ap = argparse.ArgumentParser(prog="acestep-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="generate music from text")
    g.add_argument("--checkpoint-dir", default=os.environ.get("ACESTEP_CONFIG_PATH"))
    g.add_argument("--lm-checkpoint-dir", default=os.environ.get("ACESTEP_LM_MODEL_PATH"))
    g.add_argument("--random-init", action="store_true", help="dev mode: random weights")
    g.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    g.add_argument("--caption", required=True)
    g.add_argument("--lyrics", default="[Instrumental]")
    g.add_argument("--duration", type=float, default=30.0)
    g.add_argument("--task", default="text2music")
    g.add_argument("--thinking", action="store_true")
    g.add_argument("--seed", type=int, default=-1)
    g.add_argument("--steps", type=int, default=8)
    g.add_argument("--shift", type=float, default=3.0)
    g.add_argument("--batch-size", type=int, default=1)
    g.add_argument("--format", default="flac", help="flac (default), wav, wav16, wav32, or any format ffmpeg writes")
    g.add_argument("--output-dir", default="./outputs")
    _mesh_args(g)
    g.set_defaults(fn=cmd_generate)

    ge = sub.add_parser("generate-examples", help="batch-generate example params via the LM")
    ge.add_argument("--lm-checkpoint-dir", default=os.environ.get("ACESTEP_LM_MODEL_PATH"))
    ge.add_argument("--random-init", action="store_true", help="dev mode: random weights")
    ge.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ge.add_argument("--num", type=int, default=10)
    ge.add_argument("--query", default="", help="optional inspiration query")
    ge.add_argument("--output-dir", default="examples/params")
    ge.add_argument("--start-index", type=int, default=1)
    ge.set_defaults(fn=cmd_generate_examples)

    s = sub.add_parser("serve", help="start the REST job API server")
    s.add_argument("--checkpoint-dir", default=os.environ.get("ACESTEP_CONFIG_PATH"))
    s.add_argument("--lm-checkpoint-dir", default=os.environ.get("ACESTEP_LM_MODEL_PATH"))
    s.add_argument("--random-init", action="store_true", help="dev mode: random weights")
    s.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8001, help="0 binds a free port (printed)")
    s.add_argument("--api-key", default=os.environ.get("ACESTEP_API_KEY"))
    s.add_argument("--output-dir", default="./outputs")
    s.add_argument("--warmup", default=os.environ.get("ACESTEP_WARMUP"),
                   help="request shapes to run before binding the port, e.g. '1x30,2x60' "
                        "(batch x duration-seconds); the token 'lm' runs one planner draft")
    _mesh_args(s)
    s.set_defaults(fn=cmd_serve)

    t = sub.add_parser("train", help="LoRA fine-tune from preprocessed tensors")
    _model_args(t)
    t.add_argument("--dataset-dir", required=True)
    t.add_argument("--output-dir", default="./lora_output")
    t.add_argument("--rank", type=int, default=32)
    t.add_argument("--alpha", type=float, default=32.0)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--max-steps", type=int, default=1000)
    t.add_argument("--batch-size", type=int, default=1)
    t.add_argument("--resume-from", default=None, help="a checkpoints/step_N.pt file of an earlier run")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("estimate", help="rank attention modules by gradient sensitivity")
    _model_args(e)
    e.add_argument("--dataset-dir", required=True)
    e.add_argument("--num-batches", type=int, default=10)
    e.add_argument("--batch-size", type=int, default=1)
    e.add_argument("--top-k", type=int, default=16)
    e.add_argument("--granularity", choices=["module", "layer"], default="module")
    e.add_argument("--cfg-ratio", type=float, default=0.0)
    e.add_argument("--json-out", default=None)
    e.set_defaults(fn=cmd_estimate)

    bd = sub.add_parser("build-dataset", help="scan/label/preprocess audio into training tensors")
    _model_args(bd)
    bd.add_argument("--audio-dir", required=True)
    bd.add_argument("--output-dir", default=None)
    bd.add_argument("--label-with-lm", action="store_true", help="LM-assisted captions/metas via understand-on-codes")
    bd.add_argument("--format-lyrics", action="store_true", help="normalize preloaded lyrics with the LM")
    bd.add_argument("--max-duration", type=float, default=240.0)
    bd.set_defaults(fn=cmd_build_dataset)

    dl = sub.add_parser("download", help="ensure/download checkpoint components")
    dl.add_argument("--models", default="acestep-v15-turbo,acestep-5Hz-lm-0.6B",
                    help="comma list of model names (see downloader.MODEL_REPOS)")
    dl.add_argument("--cache-dir", default=os.environ.get("ACESTEP_CHECKPOINT_ROOT")
                    or os.path.expanduser("~/.cache/acestep_tpu/checkpoints"))
    dl.set_defaults(fn=cmd_download)

    vc = sub.add_parser("verify-checkpoint", help="verify a checkpoint dir per component")
    vc.add_argument("path")
    vc.add_argument("--lm", action="store_true", help="use the LM checkpoint layout")
    vc.set_defaults(fn=cmd_verify_checkpoint)

    p = sub.add_parser("profile", help="benchmark matrix (duration × batch)")
    _model_args(p)
    p.add_argument("--durations", default="30,60,120")
    p.add_argument("--batches", default="1,2")
    p.add_argument("--think", default="false", help="comma list of think modes, e.g. 'false,true' (needs LM)")
    p.add_argument("--steps", default="8", help="comma list of step counts, e.g. '8,16'")
    p.add_argument("--json-out", default=None)
    p.add_argument("--trace-dir", default=None, help="write a torch.profiler Chrome trace of each timed run")
    p.add_argument("--lm", action="store_true", help="profile LM decode throughput instead of the DiT matrix")
    p.add_argument("--lm-tokens", type=int, default=300,
                   help="decode steps per LM throughput run (default 300 = 60 s of codes)")
    p.set_defaults(fn=cmd_profile)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
