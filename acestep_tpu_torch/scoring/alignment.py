"""Lyric-to-audio alignment: DTW over cross-attention, LRC timestamps.

Port of `acestep_tpu/scoring/alignment.py`, a copy in pure numpy (float64),
with the same names: `dtw_align` (monotonic 3-move DTW with backtrace, a
Python double loop of about lyric tokens x patched frames steps, as in the
JAX package), `median_filter`, `MusicStampsAligner` (bidirectional
consensus, token and sentence stamps), `alignment_confidence` and
`format_lrc`. It runs on the host over the (lyric tokens x audio frames)
attention that `models/dit.dit_cross_attention_capture` captures.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class TokenTimestamp:
    token: str
    start: float
    end: float


@dataclasses.dataclass
class SentenceTimestamp:
    text: str
    start: float
    end: float


def dtw_align(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW through a (N_text, M_frames) cost matrix.

    Returns (text_indices, frame_indices) of the optimal path. Standard
    3-move DP (diag / down / right) with backtrace, as in the reference's
    Whisper-derived `dtw_cpu`.
    """
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf, dtype=np.float64)
    trace = np.zeros((n + 1, m + 1), dtype=np.int8)
    acc[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c0 = acc[i - 1, j - 1]
            c1 = acc[i - 1, j]
            c2 = acc[i, j - 1]
            best = min(c0, c1, c2)
            acc[i, j] = cost[i - 1, j - 1] + best
            trace[i, j] = 0 if best == c0 else (1 if best == c1 else 2)

    ti, fi = [], []
    i, j = n, m
    while i > 0 and j > 0:
        ti.append(i - 1)
        fi.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(ti[::-1]), np.asarray(fi[::-1])


def median_filter(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis (ref _dtw.py:90)."""
    if width <= 1:
        return x
    pad = width // 2
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
    windows = np.lib.stride_tricks.sliding_window_view(xp, width, axis=-1)
    return np.median(windows, axis=-1)


class MusicStampsAligner:
    """Cross-attention → token/sentence timestamps (ref dit_alignment.py:39-440)."""

    def __init__(self, tokenizer, frames_per_second: float = 12.5):
        # DiT tokens are patch-2 over 25 Hz latents → 12.5 tokens/s.
        self.tokenizer = tokenizer
        self.fps = frames_per_second

    def _apply_bidirectional_consensus(
        self,
        stack: np.ndarray,  # (..., n_text, n_frames) — heads/layers stacked
        violence_level: float = 2.0,
        medfilt_width: int = 1,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Bidirectional-consensus denoising (ref dit_alignment.py:55-101):

        A. token→frame × frame→token probability product — a cell survives
           only if the token claims the frame AND the frame claims the token;
        B. row/column median suppression scaled by `violence_level` (kills
           horizontal and vertical crossing lines);
        C. power sharpening (²);
        D. z-score normalization;
        E. median filtering, then head averaging.

        Returns (calc_matrix, energy_matrix): the z-scored consensus map DTW
        paths through (reference feeds `dtw_cpu(-calc_matrix)`), and the
        pre-z-score energy for confidence scoring.

        Deviation noted: the capture path hands us attention PROBABILITIES
        (already softmaxed over text per audio frame — dit.py
        `dit_cross_attention_capture`), so the two directions are formed by
        per-axis renormalization rather than the reference's softmax over raw
        scores; the consensus product/suppression/sharpening pipeline is
        otherwise identical.
        """
        p = np.asarray(stack, np.float64)
        while p.ndim > 3:
            p = p.reshape(-1, p.shape[-2], p.shape[-1])
        if p.ndim == 2:
            p = p[None]
        row = p / np.maximum(p.sum(axis=-1, keepdims=True), 1e-12)  # token→frame
        col = p / np.maximum(p.sum(axis=-2, keepdims=True), 1e-12)  # frame→token
        proc = row * col
        proc = np.maximum(
            proc - violence_level * np.median(proc, axis=-1, keepdims=True), 0.0
        )
        proc = np.maximum(
            proc - violence_level * np.median(proc, axis=-2, keepdims=True), 0.0
        )
        proc = proc**2
        energy = proc.mean(axis=0)
        z = (proc - proc.mean()) / (proc.std() + 1e-9)
        calc = median_filter(z, medfilt_width).mean(axis=0)
        return calc, energy

    def token_timestamps(
        self,
        attention: np.ndarray,  # (..., n_text_tokens, n_audio_frames)
        token_ids: Sequence[int],
        violence_level: float = 2.0,
        medfilt_width: int = 1,
    ) -> List[TokenTimestamp]:
        calc, _ = self._apply_bidirectional_consensus(
            np.asarray(attention), violence_level, medfilt_width
        )
        n_text = min(len(token_ids), calc.shape[0])
        cost = -calc[:n_text]
        ti, fi = dtw_align(cost)

        stamps: List[TokenTimestamp] = []
        for tok_idx in range(n_text):
            frames = fi[ti == tok_idx]
            if len(frames) == 0:
                continue
            text = self.tokenizer.decode([token_ids[tok_idx]])
            stamps.append(
                TokenTimestamp(
                    token=text,
                    start=float(frames.min()) / self.fps,
                    end=float(frames.max() + 1) / self.fps,
                )
            )
        return stamps

    def sentence_timestamps(
        self,
        attention: np.ndarray,
        token_ids: Sequence[int],
        sentences: Sequence[str],
    ) -> List[SentenceTimestamp]:
        """Group token stamps into lyric lines by greedy text matching."""
        token_stamps = self.token_timestamps(attention, token_ids)
        out: List[SentenceTimestamp] = []
        cursor = 0
        for sent in sentences:
            target = sent.strip()
            if not target:
                continue
            taken, acc = [], ""
            while cursor < len(token_stamps) and len(acc.strip()) < len(target):
                taken.append(token_stamps[cursor])
                acc += token_stamps[cursor].token
                cursor += 1
            if taken:
                out.append(SentenceTimestamp(text=target, start=taken[0].start, end=taken[-1].end))
        return out


def alignment_confidence(attention: np.ndarray) -> float:
    """Lyric alignment quality score in [0, 1] (ref lyric_score role):
    mean per-token peak attention mass after normalization — diffuse
    attention (poor alignment) scores low, sharp monotonic attention high."""
    attn = np.asarray(attention, np.float64)
    while attn.ndim > 2:
        attn = attn.mean(axis=0)
    attn = attn / np.maximum(attn.sum(axis=-1, keepdims=True), 1e-9)
    peaks = attn.max(axis=-1)
    uniform = 1.0 / attn.shape[-1]
    score = (peaks - uniform) / (1.0 - uniform + 1e-9)
    return float(np.clip(score.mean(), 0.0, 1.0))


def format_lrc(stamps: Sequence[SentenceTimestamp]) -> str:
    """Sentence timestamps → LRC text (ref dit_alignment.format_lrc)."""
    lines = []
    for s in stamps:
        minutes = int(s.start // 60)
        seconds = s.start - 60 * minutes
        lines.append(f"[{minutes:02d}:{seconds:05.2f}]{s.text}")
    return "\n".join(lines)
