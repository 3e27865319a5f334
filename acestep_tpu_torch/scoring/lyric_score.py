"""Composite lyric-quality score from cross-attention energy.

Port of `acestep_tpu/scoring/lyric_score.py`, a copy in pure numpy:
`MusicLyricScorer` scores Coverage², Monotonicity² and Path-Confidence over
the min-max-normalised, head-averaged cross-attention, with DTW on the
squared energy. It feeds on the same captured attention as the LRC aligner
and gives the `lyrics_score` of a result.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np

from acestep_tpu_torch.scoring.alignment import dtw_align, median_filter


class MusicLyricScorer:
    """Lyrics-to-audio alignment quality (ref dit_score.py:15)."""

    def __init__(self, tokenizer: Any):
        self.tokenizer = tokenizer

    def token_type_mask(self, token_ids: Sequence[int]) -> np.ndarray:
        """1 for lyric tokens, 0 for structural [tags] (ref :32-54)."""
        decoded = [self.tokenizer.decode([int(t)]) for t in token_ids]
        mask = np.ones(len(token_ids), np.int32)
        in_bracket = False
        for i, tok in enumerate(decoded):
            if "[" in tok:
                in_bracket = True
            if in_bracket:
                mask[i] = 0
            if "]" in tok:
                in_bracket = False
                mask[i] = 0
        return mask

    @staticmethod
    def preprocess_attention(
        attention: Union[np.ndarray, Mapping[int, np.ndarray]],
        custom_config: Optional[Dict[int, List[int]]] = None,
        medfilt_width: int = 1,
    ):
        """Head-select → average → median-filter → min-max normalize
        (ref :56-125). Accepts a dense (L, H, T, F) tensor with
        `custom_config` {layer: [heads]}, or a {layer: (B|1, H, T, F)} capture
        dict straight from `dit_cross_attention_capture`.

        Returns (calc_matrix, energy_matrix): squared contrast-enhanced matrix
        for DTW pathfinding, and the normalized energy for scoring.
        """
        selected = []
        if not isinstance(attention, Mapping) and np.asarray(attention).ndim == 3:
            # Pre-selected head maps (N, T, F) — e.g. the LRC capture path's
            # already-gathered lyric-row slices.
            selected = [m for m in np.asarray(attention, np.float32)]
        elif isinstance(attention, Mapping):
            for layer, heads in (custom_config or {}).items():
                if layer not in attention:
                    continue
                a = np.asarray(attention[layer], np.float32)
                if a.ndim == 4:  # (B, H, T, F) — first sample
                    a = a[0]
                for h in heads:
                    if h < a.shape[0]:
                        selected.append(a[h])
        else:
            a = np.asarray(attention, np.float32)
            for layer, heads in (custom_config or {}).items():
                for h in heads:
                    if layer < a.shape[0] and h < a.shape[1]:
                        selected.append(a[layer, h])
        if not selected:
            return None, None
        avg = np.stack(selected, axis=0).mean(axis=0)  # (T, F)

        energy = median_filter(avg.astype(np.float64), medfilt_width)
        e_min, e_max = energy.min(), energy.max()
        if e_max - e_min > 1e-9:
            energy = (energy - e_min) / (e_max - e_min)
        else:
            energy = np.zeros_like(energy)
        return energy**2, energy

    @staticmethod
    def alignment_metrics(
        energy: np.ndarray,  # (T, F) normalized
        path_coords: np.ndarray,  # (S, 2)
        type_mask: np.ndarray,  # (T,)
        *,
        time_weight: float = 0.01,
        overlap_frames: float = 9.0,
        instrumental_weight: float = 1.0,
    ):
        """(coverage, monotonicity, confidence) — ref :127-215."""
        energy = energy.astype(np.float64)
        rows, cols = energy.shape
        is_lyric = type_mask.astype(bool)

        # A. Coverage: lyric rows whose peak energy clears 0.1
        row_max = energy.max(axis=1)
        total_sung = is_lyric.sum()
        coverage = (
            float((is_lyric & (row_max > 0.1)).sum() / total_sung) if total_sung else 1.0
        )

        # B. Monotonicity of energy centroids along lyric rows
        col_idx = np.arange(cols, dtype=np.float64)
        w = np.where(energy > time_weight, energy, 0.0)
        sum_w = w.sum(axis=1)
        centroids = np.full(rows, -1.0)
        valid = sum_w > 1e-9
        centroids[valid] = (w * col_idx).sum(axis=1)[valid] / sum_w[valid]
        sung_centroids = centroids[is_lyric & (centroids >= 0)]
        if sung_centroids.shape[0] > 1:
            non_dec = (sung_centroids[1:] >= sung_centroids[:-1] - overlap_frames).sum()
            monotonicity = float(non_dec / (sung_centroids.shape[0] - 1))
        else:
            monotonicity = 1.0

        # C. Path confidence: mean on-path energy, tag steps down-weighted
        if path_coords.shape[0]:
            pr, pc = path_coords[:, 0], path_coords[:, 1]
            step_w = np.where(type_mask[pr] == 0, instrumental_weight, 1.0)
            confidence = float((energy[pr, pc] * step_w).sum() / max(step_w.sum(), 1e-9))
        else:
            confidence = 0.0
        return coverage, monotonicity, confidence

    def score(
        self,
        attention: Union[np.ndarray, Mapping[int, np.ndarray]],
        token_ids: Sequence[int],
        custom_config: Dict[int, List[int]],
        *,
        medfilt_width: int = 1,
        time_weight: float = 0.01,
        overlap_frames: float = 9.0,
        instrumental_weight: float = 1.0,
    ) -> Dict[str, Any]:
        """Full pipeline → {"lyrics_score", "coverage", "monotonicity",
        "confidence"}; final score = cov² · mono² · conf (ref :323-329)."""
        calc, energy = self.preprocess_attention(attention, custom_config, medfilt_width)
        if calc is None:
            return {"lyrics_score": 0.0, "error": "no valid attention heads"}
        type_mask = self.token_type_mask(token_ids)
        if len(type_mask) != energy.shape[0]:
            type_mask = np.ones(energy.shape[0], np.int32)
        ti, fi = dtw_align(-calc.astype(np.float32))
        path_coords = np.stack([ti, fi], axis=1)
        cov, mono, conf = self.alignment_metrics(
            energy, path_coords, type_mask,
            time_weight=time_weight, overlap_frames=overlap_frames,
            instrumental_weight=instrumental_weight,
        )
        final = float(np.clip(cov**2 * mono**2 * conf, 0.0, 1.0))
        return {
            "lyrics_score": round(final, 4),
            "coverage": round(cov, 4),
            "monotonicity": round(mono, 4),
            "confidence": round(conf, 4),
        }
