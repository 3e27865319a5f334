"""The benchmark's operation and byte counts against hand counts at tiny shapes."""

import numpy as np
import pytest

from harness import measure


def brute_pairs(lq, lk, valid, window=None, causal=False):
    i = np.arange(lq)[:, None]
    j = np.arange(lk)[None, :]
    ok = np.broadcast_to(j < valid, (lq, lk)).copy()
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= np.abs(i - j) <= window
    return int(ok.sum())


@pytest.mark.parametrize("lq,lk,valid,window,causal", [
    (10, 10, 7, None, False), (10, 10, 10, 3, False), (10, 12, 9, 2, True), (20, 20, 15, None, True),
    (7, 30, 30, None, False), (64, 64, 40, 8, False)])
def test_allowed_pairs_match_a_brute_count(lq, lk, valid, window, causal):
    assert measure.allowed_pairs(lq, lk, [valid], window=window, causal=causal) == \
        brute_pairs(lq, lk, valid, window, causal)


def test_attention_flops_and_bytes_by_hand():
    # 2 rows of 4 queries against 4 keys, all allowed: 32 pairs, 4 heads of 8.
    assert measure.attention_flops(32, 4, 8) == 4 * 32 * 4 * 8
    # q and out: 2*4*4*8 elements each; k and v: 2*4*2*8 each; bf16; the mask 2*4 int32.
    assert measure.attention_bytes(2, 4, 4, 4, 2, 8) == 2 * (2 * 256 + 2 * 128) + 32


def test_bound_ms_picks_the_longer_side():
    ms, by = measure.bound_ms(989e9, 1.0)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = measure.bound_ms(1.0, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)


VAE = dict(downsampling_ratios=[2, 3], channel_multiples=[1, 2], decoder_channels=4, decoder_input_channels=5,
           audio_channels=2)


def test_vae_decode_flops_by_hand():
    # conv in: 5 -> 8 channels (4 * 2), k7, at 3 frames; block 0: stride 3, 8 -> 4, out 9 rows;
    # block 1: stride 2, 4 -> 4, out 18 rows; conv out: 4 -> 2, k7, at 18 rows.
    f = 2 * 3 * 7 * 5 * 8
    f += 4 * 9 * 8 * 4 + 48 * 9 * 4 * 4
    f += 4 * 18 * 4 * 4 + 48 * 18 * 4 * 4
    f += 2 * 18 * 7 * 4 * 2
    assert measure.vae_decode_flops(VAE, 1, 3) == f
    assert measure.vae_decode_flops(VAE, 2, 3) == 2 * f


def test_vae_decode_bytes_by_hand():
    w = 7 * 5 * 8 + (2 * 3 * 8 * 4 + 24 * 16) + (2 * 2 * 4 * 4 + 24 * 16) + 7 * 4 * 2
    assert measure.vae_decoder_weight_bytes(VAE) == 4 * w
    assert measure.vae_decode_bytes(VAE, 1, 3) == 2 * 3 * 5 + 4 * w + 2 * 3 * 6 * 2


DIT = dict(hidden_size=8, intermediate_size=12, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
           head_dim=4, patch_size=2, in_channels=6, audio_acoustic_hidden_dim=2, use_sliding_window=True,
           sliding_window=1)


def test_dit_forward_flops_by_hand():
    b, t, enc = 1, 8, [3]
    l = 4
    f = 2 * l * 2 * 6 * 8 + 2 * l * 8 * 2 * 2  # patch in, patch out
    f += 2 * 2 * (256 * 8 + 8 * 8 + 8 * 48)  # two timestep embeddings
    per_token = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8) + 2 * (8 * 8 + 8 * 8) + 6 * 8 * 12
    sliding = brute_pairs(l, l, l, window=1)
    full = l * l
    f += 2 * l * per_token + 4 * 2 * 4 * (sliding + full) + 2 * 4 * 2 * 4 * (l * 3)
    assert measure.dit_forward_flops(DIT, b, t, enc) == f


def test_text_encoder_flops_by_hand():
    tcfg = dict(hidden_size=8, intermediate_size=16, num_attention_heads=2, num_key_value_heads=1, head_dim=4,
                num_hidden_layers=3)
    per_token = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8) + 6 * 8 * 16
    pairs = 5 * 6 // 2
    assert measure.text_encoder_flops(tcfg, 1, 5) == 3 * (5 * per_token + 4 * pairs * 2 * 4)


def test_decode_chunks_follow_the_handler_rule():
    assert measure.decode_chunks(15000, 1) == [544] * 30
    assert measure.decode_chunks(1500, 4) == [408] * 4
    assert measure.decode_chunks(150, 1) == [150]
