"""Command-line interface of the port: `generate` only.

Port of the `generate` subcommand of `acestep_tpu/cli.py`, with its flags.
Writes 16-bit stereo WAV files with the stdlib `wave` module. Run as
``python -m acestep_tpu_torch.cli generate --random-init --caption "..."``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
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
    from acestep_tpu_torch.pipeline.handler import AceStepHandler

    if args.thinking:
        raise NotImplementedError("--thinking needs the 5 Hz LM planner, not ported yet")
    if args.format != "wav":
        raise NotImplementedError(f"--format {args.format}: the port writes wav only")
    h = AceStepHandler(device=args.device)
    print(h.initialize_service(args.checkpoint_dir, random_init=args.random_init or None))
    out = h.generate_music(
        captions=args.caption,
        lyrics=args.lyrics,
        batch_size=args.batch_size,
        audio_duration=args.duration,
        task_type=args.task,
        seeds=None if args.seed < 0 else args.seed,
        use_random_seed=args.seed < 0,
        inference_steps=None if args.steps == 8 else args.steps,
        shift=args.shift,
        normalize_db=-1.0,
        return_int16=True,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    stamp = time.strftime("%Y%m%d-%H%M%S")
    for i, pcm in enumerate(out["audios"]):
        path = os.path.join(args.output_dir, f"acestep_{stamp}_{out['seeds'][i]}_{i}.wav")
        write_wav(path, pcm, h.sample_rate)
        print("  ", path)
    print({k: round(v, 3) for k, v in out["time_costs"].items()})
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="acestep-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="generate music from text")
    g.add_argument("--checkpoint-dir", default=os.environ.get("ACESTEP_CONFIG_PATH"))
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
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
