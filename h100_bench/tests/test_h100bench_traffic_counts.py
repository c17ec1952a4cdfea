"""The traffic generators repeat exactly for a seed and differ across
seeds; the FLOP and byte counts against numbers worked out by hand."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench import harness
from h100_bench.frozen import counts, render

ROOT = harness.ROOT


def _driver(name, config, traffic, seed):
    ctx = harness.Context(root=ROOT, workload={"name": "test"}, config=config,
                          traffic=traffic, seed=seed, device=torch.device("cpu"))
    path = harness.BENCH_DIR / "drivers" / f"{name}.py"
    return harness.load_module(path, f"test_traffic_{name}").Driver(ctx)


def _load(kind, name):
    return json.loads((harness.BENCH_DIR / kind / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def catalog_requests():
    cfg, traffic = _load("configs", "etude_decoder"), _load("traffic", "catalog_b864")
    out = {}
    for seed in (2147483901, 2147483901, -5, 2 ** 40 + 3):
        d = _driver("catalog", cfg, traffic, seed)
        d.prepare_traffic()
        out.setdefault(seed, []).append([d.make_request(i) for i in range(3)])
    return out


def test_catalog_repeats_for_a_seed(catalog_requests):
    first, second = catalog_requests[2147483901]
    assert first == second


def test_catalog_differs_across_seeds_in_order_only(catalog_requests):
    """Every seed serves the same catalog (the same work), in its own order."""
    runs = [reqs[0] for reqs in catalog_requests.values()]
    orders = [[r[2] for r in run] for run in runs]
    assert orders[0] != orders[1] or [r[0] for r in runs[0]] != [r[0] for r in runs[1]]
    for run in runs[1:]:
        assert sorted(map(tuple, (r[2] for r in run))) == sorted(
            map(tuple, (r[2] for r in runs[0])))
        for a, b in zip(sorted(run, key=lambda r: r[2]), sorted(runs[0], key=lambda r: r[2])):
            assert sorted(map(repr, zip(a[0], a[1]))) == sorted(map(repr, zip(b[0], b[1])))


def test_catalog_request_shape(catalog_requests):
    traffic = _load("traffic", "catalog_b864")
    streams, bins, songs = catalog_requests[2147483901][0][0]
    styles = np.prod([len(v) for v in traffic["styles"].values()])
    assert len(songs) == traffic["songs_per_request"] == len(set(songs))
    assert len(streams) == len(bins) == traffic["songs_per_request"] * styles == 864
    assert all(len(s) == traffic["bars_per_section"] for s in streams)
    per_song = {}
    for stream, b in zip(streams, bins):
        per_song.setdefault(repr(stream), set()).add(tuple(sorted(b[0].items())))
    assert len(per_song) == len(songs)
    assert all(len(c) == styles for c in per_song.values())   # every style once per song
    later = [r[2] for r in catalog_requests[2147483901][0][1:]]
    assert not set(songs) & set(later[0]) and not set(later[0]) & set(later[1])


def test_catalog_bars_stay_in_the_largest_bucket(catalog_requests):
    """Every condition bar fits the 320 bucket, which the memory plan of
    the 864 streams assumes."""
    cfg = _load("configs", "etude_decoder")
    for reqs in catalog_requests.values():
        for streams, _, _ in reqs[0]:
            assert max(len(b) for s in streams for b in s) <= max(cfg["x_len_buckets"])


def test_songs_repeat_for_a_seed_and_differ_across_seeds():
    def song(seed):
        rng = np.random.default_rng(np.random.SeedSequence([seed, 0]))
        return render.song_pcm(rng, float(rng.uniform(90, 130)), 6.0, 44100)

    a, b, c = song(2147483901), song(2147483901), song(2147483902)
    assert a.dtype == np.int16 and len(a) == 6 * 44100 + 1
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert np.abs(a).max() > 1000                  # not silence


def test_decoder_flops_by_hand():
    cfg = _load("configs", "etude_decoder")
    # per layer: QKV 512x1536, attention output 512x512, MLP 512x2048 twice
    per_layer = 2 * (512 * 1536 + 512 * 512 + 512 * 2048 + 2048 * 512)
    assert counts.decoder_token_flops(cfg, 0) == 8 * per_layer + 2 * 512 * 116
    # scores and context: 2 products of 512 (8 heads x 64) per key per layer
    assert counts.decoder_token_flops(cfg, 1000) - counts.decoder_token_flops(cfg, 0) \
        == 8 * 4 * 512 * 1000


def test_decode_attention_bytes_by_hand():
    # K and V bf16 over 864 streams x 8 heads x 1217 slots x 64, q f32, bias
    # f32 [864, 1217], output bf16
    kv = 2 * 864 * 8 * 1217 * 64 * 2
    assert kv == 2_153_447_424
    assert counts.decode_attention_bytes(864, 8, 1217, 64) == \
        kv + 864 * 8 * 64 * 4 + 864 * 1217 * 4 + 864 * 8 * 64 * 2


def test_dilated_attention_bytes_by_hand():
    # q, k, v, o bf16 of 5 stems x 8 heads x 12,288 frames x 32, er f32
    assert counts.dilated_attention_bytes(5, 8, 12288, 32, 5) == \
        4 * 5 * 8 * 12288 * 32 * 2 + 8 * 32 * 5 * 4 == 125_834_240


def test_separator_flops_by_hand_on_one_stage():
    # depth 1, one channel (each conv emits two for the GLU): down 1 -> 2
    # at stride 2 and refine 1 -> 2 on 32 x 16, up 1 -> 2 and merge 1 + 1
    # -> 2 on 64 x 32, mask head 1 -> 5; 5x5 kernels
    k2 = 25
    want = (2 * 2 * 32 * 16 * 1 * k2 + 2 * 2 * 32 * 16 * 1 * k2
            + 2 * 2 * 64 * 32 * 1 * k2 + 2 * 2 * 64 * 32 * 2 * k2
            + 2 * 5 * 64 * 32 * 1 * k2)
    assert counts.separator_flops(64, freq_bins=32, base=1, depth=1, cap=2) == want


def test_beat_frontend_widths():
    """128 mel bins: 126 after the 3-wide conv, 42 pooled, 31 after the
    12-wide conv, 10 pooled, 5 after the 6-wide conv, 1 pooled."""
    frames = 100
    got = counts.beat_transformer_flops(frames, layers=0, instr_layers=0)
    want = (2 * 5 * 32 * frames * 126 * 1 * 5 * 3 + 2 * 5 * 64 * frames * 31 * 32 * 12
            + 2 * 5 * 256 * frames * 5 * 64 * 3 * 6 + 2 * frames * 256 * 302)
    assert got == want


def test_hft_flops_scale_with_segments():
    one = counts.hft_flops(1)
    assert counts.hft_flops(30) == 30 * one
    # the frequency encoder alone: 512 x 256 rows through 4 projections and
    # the MLP, and 512 x 4 heads of 256 x 256 attention, three layers
    enc = 3 * (4 * 2 * 512 * 256 * 256 * 256 + 2 * 2 * 512 * 4 * 256 * 256 * 64
               + 2 * 2 * 512 * 256 * 256 * 512)
    assert one > enc
