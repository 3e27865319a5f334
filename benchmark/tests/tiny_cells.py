"""Tiny sizes of the benchmark's configurations and mixes, for runs of each
cell on the CPU through the port's plain versions."""

from __future__ import annotations

import copy
import os

from harness import spec

DIT = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
           num_key_value_heads=1, head_dim=32, sliding_window=8, text_hidden_dim=64,
           num_lyric_encoder_hidden_layers=2, num_timbre_encoder_hidden_layers=1,
           num_attention_pooler_hidden_layers=1, fsq_dim=64)
TEXT = dict(vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=1, head_dim=32)
VAE = dict(encoder_hidden_size=8, downsampling_ratios=[2, 4, 4], channel_multiples=[1, 2, 4], decoder_channels=8)


def shrink(cell: spec.Cell, duration_s: float = 10.0, steps: int = None) -> spec.Cell:
    cell = copy.deepcopy(cell)
    cell.config["dit"].update(DIT)
    cell.config["text_encoder"].update(TEXT)
    cell.config["vae"].update(VAE)
    if steps is not None:
        cell.config["sampler"]["inference_steps"] = steps
    cell.traffic.update(duration_s=duration_s, compare_requests=1)
    return cell


def tiny_cell(name: str, duration_s: float = 10.0, steps: int = None) -> spec.Cell:
    """A cell of `BENCHMARK.json` at tiny widths."""
    return shrink(spec.load_cell(name), duration_s, steps)


def tiny_cell_of(name: str, config: str, traffic: str, limits: str, duration_s: float = 10.0) -> spec.Cell:
    """A cell that `BENCHMARK.json` does not hold (yet), from its files:
    `configs/<config>.json`, `traffic/<traffic>.json`, `limits/<limits>.json`."""
    load = lambda kind, n: spec.load_json(os.path.join(spec.BENCH_DIR, kind, n + ".json"))
    cell = spec.Cell(name, {"name": name, "config": config, "traffic": traffic, "chips": 1},
                     load("configs", config), load("traffic", traffic), load("limits", limits), [], [])
    return shrink(cell, duration_s)
