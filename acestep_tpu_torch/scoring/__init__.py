"""Lyric alignment and reward scoring of the PyTorch port; maps to
`acestep_tpu/scoring`."""

from acestep_tpu_torch.scoring.alignment import MusicStampsAligner, dtw_align, format_lrc, median_filter
from acestep_tpu_torch.scoring.lm_score import (
    calculate_reward_score,
    pmi_score,
    pmi_to_normalized_score,
    sequence_log_prob,
)

__all__ = [
    "calculate_reward_score",
    "pmi_score",
    "pmi_to_normalized_score",
    "sequence_log_prob",
    "MusicStampsAligner",
    "dtw_align",
    "format_lrc",
    "median_filter",
]
