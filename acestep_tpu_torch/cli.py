"""Command-line interface of the port: `generate` and `generate-examples`.

Port of those subcommands of `acestep_tpu/cli.py`, with their flags, plus
`--device` (the card unless `cpu` is asked for).

- `generate` runs the port's `service.inference.generate_music`;
  `--thinking` runs the 5 Hz LM planner (`LLMHandler()`, the 0.6B size)
  before the DiT, and `--steps` above 8 runs the base model's guided
  sampling (APG at the service's default scale 7.0). Writes 16-bit stereo
  WAV files with the stdlib `wave` module, named by the request's
  deterministic key.
- `generate-examples` drafts `--num` samples with the planner's
  create_sample and writes each as `example_NN.json` in the params-file
  format. Draft i takes seed i (the JAX command draws every example at
  seed 0, so its examples repeat).

Run as ``python -m acestep_tpu_torch.cli generate --random-init --thinking --caption "..."``
or ``python -m acestep_tpu_torch.cli generate-examples --random-init --num 3``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import wave

import numpy as np


def write_wav(path: str, pcm: np.ndarray, sample_rate: int) -> None:
    """pcm: int16 (channels, samples)."""
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(np.ascontiguousarray(pcm.T).astype("<i2").tobytes())


def cmd_generate(args) -> int:
    from acestep_tpu_torch.lm.handler import LLMHandler
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.service.inference import generate_music
    from acestep_tpu_torch.service.params import GenerationConfig, GenerationParams

    if args.format != "wav":
        raise NotImplementedError(f"--format {args.format}: the port writes wav only")
    dit = AceStepHandler(device=args.device)
    print(dit.initialize_service(args.checkpoint_dir, random_init=args.random_init or None))
    llm = None
    if args.thinking:
        llm = LLMHandler(device=args.device)
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
    result = generate_music(dit, llm, params, cfg, save_audio=False)
    print(result.status_message)
    if not result.success:
        print(result.error, file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    for a in result.audios:
        path = os.path.join(args.output_dir, a["key"] + ".wav")
        write_wav(path, a["audio"], dit.sample_rate)
        print("  ", path)
    print({k: round(v, 3) for k, v in result.extra_outputs["time_costs"].items()})
    return 0


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


def main(argv=None) -> int:
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
    g.add_argument("--format", default="wav")
    g.add_argument("--output-dir", default="./outputs")
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
