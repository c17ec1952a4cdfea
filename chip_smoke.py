#!/usr/bin/env python3
"""Smoke run of the PyTorch port (etude_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each announced with a flushed line when it starts and ends:

  1. environment    card name and power limit (nvidia-smi), torch/CUDA
                    versions; TF32 off for matmuls and cuDNN
  2. build          nvcc builds every CUDA source of the port and g++ the DBN
                    decoder, all at once; a second build must be a cache hit
  3. kernels        each hand kernel against its plain PyTorch version on the
                    card at the main path's shapes, with timings (L2 flushed,
                    device time) beside its bound and a library call where
                    one exists, and at its designs' edge cases; two
                    launches on the same inputs must give the same bits
  4. serving        the streaming engine at full decoder width (random weights
                    from a seed through the weight bridge) over 24 real corpus
                    bars, 16 lockstep streams, greedy then sampled; the K1
                    launch count must equal the engine's S = 1 chunks x
                    layers; a short window under torch.profiler shows where a
                    step's time goes; then the same chunks on the card and on
                    the CPU must agree
  5. structuralize  `InferencePipeline._run_stage2_structuralize` at full
                    separator and Beat-Transformer width (random weights from
                    a seed) on a 240 s click track synthesized from a seed:
                    span times, 9 K2 launches per forward, a well-formed
                    tempo.json; then, on a short input, the card's f32
                    separation features and bf16 beat activations against
                    the port's CPU f32 path, each beside a control it must
                    catch
  6. cli            `etude_tpu_torch.infer --decode-only` in-process on a work
                    dir that holds the tempo.json of phase 5, to a MIDI file
                    that parses

It prints a `{"kernels": [...]}` line, then `{"ok": true, "device": ...}` as
its last line, and exits 0. Any failure raises and exits non-zero with no
result line; so does a machine without CUDA, and a directory that holds this
script without the package. It imports nothing of JAX or of etude_tpu.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T0 = time.perf_counter()

LOGIT_ATOL, LOGIT_RTOL = 2e-2, 2e-2   # card vs CPU logits, both bf16 paths
# Card (bf16) vs CPU (f32) beat activations: sigmoid outputs near 0.5 with
# a spread of about 6e-3 under the random weights. The port's bf16 path
# differs from its f32 path by 1.5e-3 on the CPU (3 f16 ulps); zeroing one
# layer's attention output moves them by 1.6e-2 to 9.6e-2 (CPU f32, 12 s
# click track). Faults finer than that (head 7's keys, a wrong dilation) are
# held by the kernels phase, which checks every dilation and head7_bug.
ACT_ATOL = 5e-3
# Card f32 (TF32 off) vs CPU f32 separation features, in dB. Under random
# weights the quiet bins amplify rounding: on the CPU, the port's f32
# features and the JAX package's differ by up to 0.077 dB on the 12 s click
# track (mean 0.0014 dB), while scaling the first conv's weights by 1.01
# moves them by 1.6 dB and by 1.001 still by 0.16 dB.
SEP_DB_ATOL = 0.1
SONG_SECONDS = 240.0          # a 4-minute song: 10,336 frames at 44.1 kHz / 1024


def say(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t = time.perf_counter()
    say(f"[phase] {name}: start (t={t - T0:.1f}s)")
    yield
    say(f"[phase] {name}: done in {time.perf_counter() - t:.2f}s "
        f"(t={time.perf_counter() - T0:.1f}s)")


def check_kernel(B, C, seed, flush, timed=True):
    """K1 against its plain version on the card (inputs made on the card
    from a seed, H = 8, D = 64), within two bf16 ulps of the largest |o|; two
    launches on the same inputs must give the same bits. `timed` adds the
    kernel's, the plain version's and masked SDPA's times."""
    import torch
    import torch.nn.functional as F
    from etude_tpu_torch.ops.decode_attention import (
        decode_attention, decode_attention_plain,
    )
    from etude_tpu_torch.utils.kernel_bench import (
        attention_inputs, decode_bound, kernel_tolerance, time_ms,
    )

    q, k, v, bias = attention_inputs(B, C, seed)
    H, D = k.shape[1], k.shape[3]
    out = decode_attention(q, k, v, bias)
    again = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, bias)
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"decode_attention B={B} C={C}: non-finite output")
    if not torch.equal(out, again):
        raise RuntimeError(f"decode_attention B={B} C={C}: two launches differ")
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref)
    if err > tol:
        raise RuntimeError(f"decode_attention B={B} C={C}: max|kernel-plain| "
                           f"{err:.3g} > {tol:.3g}")
    row = {"B": B, "C": C, "max_abs_err": err, "tol": tol}
    if not timed:
        say(f"  decode_attention B={B:2d} C={C:4d}: max_abs_err={err:.3g} (tol {tol:.3g}), "
            f"deterministic")
        return row
    q4 = q.to(torch.bfloat16)[:, :, None]
    mask = bias.to(torch.bfloat16)[:, None, None, :]
    row["bound_ms"], row["bound_by"], n_bytes = decode_bound(B, H, C, D)
    row["ms"] = time_ms(lambda: decode_attention(q, k, v, bias), flush=flush)
    row["plain_ms"] = time_ms(lambda: decode_attention_plain(q, k, v, bias), flush=flush)
    row["library_ms"] = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k, v, attn_mask=mask), flush=flush)
    say(f"  decode_attention B={B:2d} C={C:4d}: max_abs_err={err:.3g} (tol {tol:.3g}) "
        f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
        f"sdpa={row['library_ms']:.4f} ms bound={row['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB, {row['bound_by']})")
    return row


def check_dilated(B, T, dilation, seed, flush, head7_bug=False):
    """K2 against its plain version on the card at the Beat-Transformer's
    widths (H = 8, d = 32), bf16 q/k/v made on the card from a seed, within
    two bf16 ulps of the largest |o|; two launches must give the same bits."""
    import torch
    from etude_tpu_torch.ops.dilated_attention import (
        dilated_attention, dilated_attention_plain,
    )
    from etude_tpu_torch.utils.kernel_bench import (
        dilated_bound, dilated_inputs, kernel_tolerance, time_ms,
    )

    q, k, v, er = dilated_inputs(B, T, seed)
    H, d = q.shape[1], q.shape[3]
    out = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    again = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    torch.cuda.synchronize()
    ref = dilated_attention_plain(q, k, v, er, dilation, head7_bug=head7_bug)
    name = f"dilated_attention B={B} T={T} dilation={dilation} head7_bug={head7_bug}"
    if not torch.isfinite(out.float()).all():
        raise RuntimeError(f"{name}: non-finite output")
    if not torch.equal(out, again):
        raise RuntimeError(f"{name}: two launches differ")
    err = (out.float() - ref.float()).abs().max().item()
    tol = kernel_tolerance(ref)
    if err > tol:
        raise RuntimeError(f"{name}: max|kernel-plain| {err:.3g} > {tol:.3g}")
    bound_ms, bound_by, n_bytes = dilated_bound(B, H, T, d)
    row = {
        "T": T, "dilation": dilation, "head7_bug": head7_bug,
        "max_abs_err": err, "tol": tol,
        "ms": time_ms(lambda: dilated_attention(q, k, v, er, dilation,
                                                head7_bug=head7_bug), flush=flush),
        "plain_ms": time_ms(lambda: dilated_attention_plain(
            q, k, v, er, dilation, head7_bug=head7_bug), iters=10, flush=flush),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
    }
    say(f"  dilated_attention B={B} T={T:5d} dil={dilation:3d}"
        f"{' head7_bug' if head7_bug else ''}: max_abs_err={err:.3g} (tol {tol:.3g}) "
        f"kernel={row['ms']:.4f} ms plain={row['plain_ms']:.4f} ms "
        f"bound={row['bound_ms']:.4f} ms ({n_bytes / 1e6:.1f} MB, {row['bound_by']})")
    return row


def host_launch_us(n: int = 20000) -> float:
    """Host cost of one eager launch: microseconds per in-place add on a
    one-element card tensor, with one synchronize at the end. The S = 1 step
    is a few hundred such launches, so this says how fast the host that
    feeds the card is, for comparing runs on different machines."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(1000):
        x.add_(1.0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t) / n


def corpus_bars(vocab, n_bars):
    import numpy as np
    from etude_tpu_torch.data.tokenizer import split_sequence_into_bars

    ids = np.load(ROOT / "dataset_distill/tokenized/0001/0001_src.npy").tolist()
    bars = split_sequence_into_bars(ids, vocab.bar_bos_id, vocab.bar_eos_id)
    if len(bars) < n_bars:
        raise RuntimeError(f"corpus song has {len(bars)} bars, need {n_bars}")
    return bars[:n_bars]


def check_streams(outs, n_bars, bos, eos, vocab_size, max_new):
    for s, bars in enumerate(outs):
        if len(bars) != n_bars:
            raise RuntimeError(f"stream {s}: {len(bars)} bars, expected {n_bars}")
        for bar in bars:
            if bar[0] != bos or len(bar) > 1 + max_new:
                raise RuntimeError(f"stream {s}: malformed bar {bar[:8]}...")
            if not all(0 <= t < vocab_size for t in bar):
                raise RuntimeError(f"stream {s}: token out of range")
            if eos in bar and bar.index(eos) != len(bar) - 1:
                raise RuntimeError(f"stream {s}: Bar_EOS not terminal")


def serve(engine, model, bars, attrs, **kw):
    import torch
    from etude_tpu_torch.ops.decode_attention import decode_attention

    engine.stats["single_token_chunks"] = 0
    decode_attention.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    outs = engine.generate_batch(model, [bars] * len(attrs), attrs, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    chunks = engine.stats["single_token_chunks"]
    launches = decode_attention.launches
    expected = chunks * model.config.num_hidden_layers
    tokens = sum(len(b) - 1 for s in outs for b in s)
    say(f"  {kw}: {tokens} tokens in {seconds:.2f} s = {tokens / seconds:.1f} tok/s; "
        f"{chunks} S=1 chunks, {1e3 * seconds / max(chunks, 1):.3f} ms per chunk "
        f"(wall, condition chunks included); kernel launches {launches} "
        f"(expected {expected})")
    if launches != expected or launches == 0:
        raise RuntimeError(f"decode_attention launched {launches} times, "
                           f"expected {expected}")
    return outs, launches


def profile_window(model, config, vocab, bars, attrs):
    """Where a decode step's time goes: 16 greedy streams x 2 bars of at
    most 64 steps, timed once without and once under torch.profiler (the
    same work). Prints device time per S = 1 chunk, the top kernels, and
    the device's idle share: 1 - device time / unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine

    engine = StreamingGenerationEngine(
        config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
        pad_id=vocab.pad_id, max_bar_token_limit=64,
    )
    window = ([bars[:2]] * len(attrs), [a[:2] for a in attrs])
    engine.generate_batch(model, *window)  # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    engine.generate_batch(model, *window)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t)
    engine.stats["single_token_chunks"] = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.generate_batch(model, *window)
        torch.cuda.synchronize()
    chunks = engine.stats["single_token_chunks"]
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        say("  profiler: no device time recorded; device busy share not measured")
        return
    say(f"  profiler: {chunks} S=1 chunks (seed and condition chunks included): "
        f"device {total_us / 1e3 / chunks:.4f} ms per chunk, unprofiled wall "
        f"{wall_ms / chunks:.4f} ms per chunk -> device idle share "
        f"{1 - total_us / 1e3 / wall_ms:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        say(f"    {e.self_device_time_total / total_us:6.1%}  {e.count:7d} launches  "
            f"{e.key[:90]}")


def chunk_parity(model, config, bars, attr):
    """Seed, condition and S = 1 chunks at full width: card (kernel) vs CPU
    (plain version), same weights and inputs."""
    import copy

    import numpy as np
    import torch
    from etude_tpu_torch.data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
    from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER
    from etude_tpu_torch.models.generate_stream import init_stream_cache, stream_chunk

    def run(m, device):
        B, hist, X = 2, 64, 64
        cache = init_stream_cache(config, B, hist + X + 1 + 8, device=device)
        zero = torch.zeros(B, dtype=torch.long, device=device)
        def t(a):
            return torch.tensor(np.asarray(a), dtype=torch.long, device=device)
        seed_ids = t([[bars[0][0], bars[0][-1]] * 8] * B)
        seed_cls = t([[SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2] * 4 * B).reshape(B, 16)
        ones = {n: torch.ones_like(seed_ids) for n in ATTRIBUTE_ORDER}
        outs = [stream_chunk(m, cache, seed_ids, seed_cls, ones, zero, zero, 0)[0]]
        x = np.zeros((B, X), np.int64)
        lens = [len(bars[1][:X]), len(bars[2][:X])]
        x[0, :lens[0]] = bars[1][:X]
        x[1, :lens[1]] = bars[2][:X]
        attrs = {n: t([[attr[n]] * X] * B) for n in ATTRIBUTE_ORDER}
        outs.append(stream_chunk(m, cache, t(x), t([[SRC_CLASS_ID] * X] * B), attrs,
                                 zero + 16, zero, hist, valid_len=t(lens))[0])
        pos = zero + 16 + t(lens)
        attr1 = {n: a[:, :1] for n, a in attrs.items()}
        # Teacher-forced (Bar_BOS, then a corpus bar's tokens), so a near-tie
        # on one device cannot steer the two runs apart.
        for step, tok in enumerate([bars[0][0]] + bars[3][1:4]):
            outs.append(stream_chunk(m, cache, t([[tok]] * B), t([[TGT_CLASS_ID]] * B),
                                     attr1, pos + step, zero, hist + X + step)[0])
        return [o.float().cpu() for o in outs]

    with torch.no_grad():
        card = run(model, "cuda")
        host = run(copy.deepcopy(model).cpu(), "cpu")
    worst = 0.0
    for a, b in zip(card, host):
        if not torch.isfinite(a).all():
            raise RuntimeError("non-finite logits on the card")
        excess = ((a - b).abs() - (LOGIT_ATOL + LOGIT_RTOL * b.abs())).max().item()
        worst = max(worst, (a - b).abs().max().item())
        if excess > 0:
            raise RuntimeError(f"card vs CPU logits differ by {worst:.3g} "
                               f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")
    say(f"  card vs CPU chunk logits: max|diff| {worst:.3g} over {len(card)} chunks "
        f"(atol {LOGIT_ATOL}, rtol {LOGIT_RTOL})")


def write_click_wav(path: Path, seconds: float, seed: int, bpm: float = 120.0,
                    sr: int = 44100) -> None:
    """A click track as 16-bit PCM: a quiet noise floor from `seed`, a 30 ms
    decaying 880 Hz click on every beat and a louder 1760 Hz one on every
    fourth (the downbeats)."""
    import numpy as np
    from etude_tpu_torch.utils.audio import save_wav

    rng = np.random.default_rng(seed)
    wave = 0.01 * rng.standard_normal(int(seconds * sr))
    n = int(0.03 * sr)
    t = np.arange(n) / sr
    env = np.exp(-t / 0.005)
    for i, start in enumerate(np.arange(0.25, seconds - 0.05, 60.0 / bpm)):
        s = int(start * sr)
        down = i % 4 == 0
        click = (0.8 if down else 0.4) * env * np.sin(2 * np.pi * (1760 if down else 880) * t)
        wave[s:s + n] += click[:len(wave) - s]
    save_wav(path, wave.astype(np.float32), sr)


def check_tempo(tempo, seconds):
    """tempo.json's contract: a list of regions {time_sig, bpm, start,
    downbeats} with finite numbers, positive tempo and increasing downbeats
    inside the song."""
    import math

    if not isinstance(tempo, list) or not tempo:
        raise RuntimeError(f"tempo.json holds no regions: {tempo!r:.200}")
    for r in tempo:
        if set(r) != {"time_sig", "bpm", "start", "downbeats"}:
            raise RuntimeError(f"tempo region keys {sorted(r)}")
        dbs = r["downbeats"]
        if not (isinstance(r["time_sig"], int) and r["time_sig"] > 0
                and math.isfinite(r["bpm"]) and r["bpm"] > 0
                and all(math.isfinite(x) and -1.0 <= x <= seconds + 1.0 for x in dbs)
                and all(a < b for a, b in zip(dbs, dbs[1:]))):
            raise RuntimeError(f"malformed tempo region {r!r:.200}")


def structuralize(root: Path):
    """Drive the port's Structuralize entry point on the card at full width
    on a 240 s click track, twice (the first run includes cuDNN's and the
    allocator's first-use costs), then once under the profiler; returns the
    work dir that holds its tempo.json and the warm run's K2 launches."""
    import numpy as np
    import torch
    from etude_tpu_torch.config import load_config
    from etude_tpu_torch.infer import InferencePipeline
    from etude_tpu_torch.ops.dilated_attention import dilated_attention

    wav = root / "click_240s.wav"
    write_click_wav(wav, SONG_SECONDS, seed=0)
    config = load_config(None, {"paths": {
        "infer_output_dir": str(root / "outputs" / "infer"),
        "separator_model": str(root / "no_separator.ckpt"),
        "beat_detector_model": str(root / "no_beat.ckpt"),
    }})
    pipeline = InferencePipeline(config, device="cuda", allow_random_weights=True)
    walls = {}
    for run in ("cold", "warm"):
        pipeline.timer.spans.clear()
        torch.cuda.reset_peak_memory_stats()
        dilated_attention.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        pipeline._run_stage2_structuralize(wav)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = dilated_attention.launches
        spans = pipeline.timer.summary()
        say(f"  {run}: {wall:.3f} s wall, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"K2 launches {launches} (expected 9)")
        for name, seconds in spans.items():
            say(f"    {name:<26s} {1e3 * seconds:10.2f} ms")
        if launches != 9:
            raise RuntimeError(f"dilated_attention launched {launches} times in one "
                               "Beat-Transformer forward, expected 9")
        walls[run] = wall
    profile_structuralize(pipeline, wav, walls["warm"])
    work = pipeline.work_dir
    beats = json.loads((work / "beat_pred.json").read_text())
    tempo = json.loads((work / "tempo.json").read_text())
    if set(beats) != {"beat_pred", "downbeat_pred"} or not beats["beat_pred"]:
        raise RuntimeError(f"beat_pred.json malformed or empty: {str(beats)[:200]}")
    check_tempo(tempo, SONG_SECONDS)
    say(f"  beat_pred.json: {len(beats['beat_pred'])} beats, "
        f"{len(beats['downbeat_pred'])} downbeats; tempo.json: {len(tempo)} region(s), "
        f"{sum(len(r['downbeats']) for r in tempo)} downbeats, "
        f"first {tempo[0]['time_sig']}/4 at {tempo[0]['bpm']:.2f} BPM")
    return work, launches


def profile_structuralize(pipeline, wav: Path, warm_wall: float) -> None:
    """One more warm run under torch.profiler: the device's busy time
    against the unprofiled warm wall, and the kernels that take it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipeline._run_stage2_structuralize(wav)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        say("  profiler: no device time recorded; device busy share not measured")
        return
    say(f"  profiler: device busy {total_us / 1e3:.2f} ms against an unprofiled warm "
        f"wall of {1e3 * warm_wall:.2f} ms -> device idle share "
        f"{1 - total_us / 1e6 / warm_wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        say(f"    {e.self_device_time_total / total_us:6.1%} {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d} launches  {e.key[:80]}")


def stage2_parity(root: Path):
    """The card against the port's CPU f32 path on a 12 s click track, with
    the same seeded random weights, each check beside a control that it must
    catch:

    - separation features: the card's separator at f32 (TF32 is off) against
      the CPU's, within SEP_DB_ATOL; the control scales the first conv's
      weights by 1.01. The card's production bf16 features are reported, not
      held: with random weights the U-Net's bf16 masks differ from its f32
      masks by tens of dB in some bins, in the JAX package as in the port;
    - beat activations: the card's bf16 forward (the production path, K2 in
      every layer) against the CPU's f32 one on the CPU's features, within
      ACT_ATOL; the controls zero one layer's K2 output at a time."""
    import numpy as np
    import torch
    import etude_tpu_torch.models.beat_transformer as beat_transformer
    from etude_tpu_torch.config import BeatDetectorConfig
    from etude_tpu_torch.data.beat_detector import BeatDetector
    from etude_tpu_torch.data.separation import SourceSeparator

    wav = root / "click_12s.wav"
    write_click_wav(wav, 12.0, seed=1)
    feats_cpu = SourceSeparator(device="cpu", allow_random_weights=True
                                ).separate_features(wav)
    card = SourceSeparator(device="cuda", allow_random_weights=True)
    feats_bf16 = card.separate_features(wav)
    diff = np.abs(feats_bf16 - feats_cpu)
    loud = np.minimum(feats_bf16, feats_cpu) > -40.0
    say(f"  separation features (dB), card bf16 vs CPU f32 (reported only): "
        f"max|diff| {diff.max():.3g}, mean {diff.mean():.3g}; over the "
        f"{loud.mean():.1%} of bins above -40 dB in both: max {diff[loud].max():.3g}, "
        f"mean {diff[loud].mean():.3g}")
    card.compute_dtype = torch.float32
    feats_f32 = card.separate_features(wav)
    if feats_f32.shape != feats_cpu.shape or not np.isfinite(feats_f32).all():
        raise RuntimeError(f"card f32 features non-finite or of shape {feats_f32.shape}")
    gap = float(np.abs(feats_f32 - feats_cpu).max())
    card.model.enc[0]["down"].conv.weight.data.mul_(1.01)
    control = float(np.abs(card.separate_features(wav) - feats_cpu).max())
    say(f"  separation features {feats_cpu.shape}, card f32 vs CPU f32: max|diff| "
        f"{gap:.3g} dB (limit {SEP_DB_ATOL}); control, first conv x1.01: {control:.3g} dB")
    if gap > SEP_DB_ATOL:
        raise RuntimeError(f"card vs CPU f32 features differ by {gap:.3g} dB > {SEP_DB_ATOL}")
    if control <= SEP_DB_ATOL:
        raise RuntimeError(f"the feature check missed its control ({control:.3g} dB)")

    act = {device: BeatDetector(BeatDetectorConfig(), device=device,
                                allow_random_weights=True)
           for device in ("cuda", "cpu")}
    ref = act["cpu"].activations(feats_cpu)
    out = act["cuda"].activations(feats_cpu)
    if not np.isfinite(out).all() or out.shape != ref.shape:
        raise RuntimeError("card beat activations non-finite or of the wrong shape")
    err = float(np.abs(out - ref).max())
    real = beat_transformer.dilated_attention
    controls = []
    try:
        for layer in range(9):
            def zeroed(q, k, v, er, dilation, head7_bug=False, layer=layer):
                if dilation == 2 ** layer:
                    return torch.zeros_like(q)
                return real(q, k, v, er, dilation, head7_bug=head7_bug)
            beat_transformer.dilated_attention = zeroed
            controls.append(float(np.abs(act["cuda"].activations(feats_cpu) - ref).max()))
    finally:
        beat_transformer.dilated_attention = real
    say(f"  beat activations [{ref.shape[0]} frames, 2], card bf16 vs CPU f32: "
        f"max|diff| {err:.3g} (atol {ACT_ATOL}); controls, one layer's K2 output "
        f"zeroed: {' '.join(f'{c:.3g}' for c in controls)}")
    if err > ACT_ATOL:
        raise RuntimeError(f"card vs CPU beat activations differ by {err:.3g} > {ACT_ATOL}")
    if min(controls) <= ACT_ATOL:
        raise RuntimeError(f"the activation check missed a control ({min(controls):.3g})")


def write_work_dir(root: Path, repo: Path, tempo_json: Path) -> Path:
    """A decode-only work dir (the given tempo.json, notes, volume) and a
    settings file that points the CLI at it with the full-width decoder
    config. Bars are capped at 32 tokens: the tempo grid of a 240 s song
    holds over a hundred bars, and random weights rarely end a bar early."""
    work = root / "outputs" / "infer" / "temp"
    work.mkdir(parents=True)
    (work / "tempo.json").write_bytes(tempo_json.read_bytes())
    notes = [{"onset": 1.0 + 0.5 * i, "offset": 1.4 + 0.5 * i,
              "pitch": 48 + (7 * i) % 36, "velocity": 80} for i in range(40)]
    (work / "extract.json").write_text(json.dumps(notes))
    (work / "volume.json").write_text(json.dumps([0.5] * 4800))
    settings = root / "settings.json"
    settings.write_text(json.dumps({
        "paths": {
            "infer_output_dir": str(root / "outputs" / "infer"),
            "decoder_config": str(repo / "checkpoints/decoder/etude_decoder_config.json"),
            "decoder_vocab": str(repo / "checkpoints/decoder/vocab.json"),
            "decoder_model": str(root / "no_checkpoint.ckpt"),
        },
        "decoder": {"max_bar_token_limit": 32},
    }))
    return settings


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is False; this run needs a GPU")
        return 1
    if not (ROOT / "etude_tpu_torch" / "__init__.py").exists():
        say(f"chip_smoke: the package etude_tpu_torch is not beside {__file__}")
        return 1
    sys.path.insert(0, str(ROOT))

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = torch.cuda.get_device_name(0)
        say(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s): {kind}")
        say(f"  allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
            f"cudnn {torch.backends.cudnn.allow_tf32}")

    from etude_tpu_torch.ops import _build

    with phase("build"):
        for name, (seconds, log) in _build.build().items():
            compiler = "nvcc" if name in _build.CUDA_SOURCES else "g++"
            say(f"  {compiler} {_build.source_path(name).name}: {seconds:.2f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line or "smem" in line:
                    say(f"    {line.strip()}")
        again = _build.build()
        if again:
            raise RuntimeError(f"rebuild with unchanged sources compiled {list(again)}")
        say("  rebuild: cache hit")

    from etude_tpu_torch.data.vocab import Vocab
    from etude_tpu_torch.models.decoder import EtudeDecoderConfig
    from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    config = EtudeDecoderConfig.from_json_file(
        ROOT / "checkpoints/decoder/etude_decoder_config.json")
    vocab = Vocab.load(ROOT / "checkpoints/decoder/vocab.json")
    bars = corpus_bars(vocab, 24)
    engine = StreamingGenerationEngine(
        config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
        pad_id=vocab.pad_id, max_bar_token_limit=512,
    )
    attrs = [[{"polyphony_bin": s % 3, "rhythm_intensity_bin": (s // 3) % 3,
               "sustain_bin": (s // 9) % 3, "pitch_overlap_bin": 2}] * len(bars)
             for s in range(16)]
    main_C = engine.pack([bars] * 16, attrs)["cache_len"]

    with phase("kernels"):
        from etude_tpu_torch.ops.decode_attention import max_cache_len
        from etude_tpu_torch.utils.kernel_bench import L2Flush

        flush = L2Flush()
        shapes = [(B, C) for B in (1, 16, 27) for C in (769, 1353)] + [(16, main_C)]
        rows = [check_kernel(B, C, seed, flush) for seed, (B, C) in enumerate(shapes)]
        # The cluster's edges (4 chunks of ceil(C / 4) slots): C = 1 leaves
        # three blocks with no slot, C = 7 one short chunk, C = 9 one empty;
        # the serving C at B = 1 and 27; the largest C the wrapper accepts.
        edges = [(1, 1), (1, 7), (16, 9), (1, main_C), (27, main_C), (1, max_cache_len())]
        rows += [check_kernel(B, C, 50 + i, flush, timed=False)
                 for i, (B, C) in enumerate(edges)]
        # K2 at B = 5 stems: a 2048-frame bucket, a 240 s song's 10,336
        # frames (classes of two lengths at every dilation) and its
        # 12,288-frame bucket, whose 9 dilations are one Beat-Transformer
        # forward; T below the dilation; head7_bug at both ends.
        k2_cases = ([(2048, d) for d in (1, 256)] + [(10336, 2 ** i) for i in range(9)]
                    + [(12288, 2 ** i) for i in range(9)] + [(77, 128), (200, 256)])
        k2_rows = [check_dilated(5, T, dil, 100 + i, flush)
                   for i, (T, dil) in enumerate(k2_cases)]
        k2_rows += [check_dilated(5, 12288, dil, 200 + dil, flush, head7_bug=True)
                    for dil in (1, 8, 256)]
        k2_main = [r for r in k2_rows if r["T"] == 12288 and not r["head7_bug"]]
        say(f"  dilated_attention, one forward at T=12288 (9 launches): kernel "
            f"{sum(r['ms'] for r in k2_main):.4f} ms, plain "
            f"{sum(r['plain_ms'] for r in k2_main):.4f} ms, bound "
            f"{sum(r['bound_ms'] for r in k2_main):.4f} ms")
        del flush

    with phase("serving"):
        model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda")
        say(f"  decoder: {sum(p.numel() for p in model.parameters())} parameters, "
            f"{len(bars)} corpus bars, 16 streams, cache C = {main_C}")
        say(f"  host: {host_launch_us():.2f} us per eager launch (1-element add)")
        launches = 0
        for kw in ({"temperature": 0.0}, {"temperature": 1.0, "top_p": 0.9, "seed": 1234}):
            outs, n = serve(engine, model, bars, attrs, **kw)
            check_streams(outs, len(bars), vocab.bar_bos_id, vocab.bar_eos_id,
                          config.vocab_size, engine.max_bar_token_limit)
            launches += n
        profile_window(model, config, vocab, bars, attrs)
        chunk_parity(model, config, bars, {"pitch_overlap": 2, "polyphony": 1,
                                           "sustain": 1, "rhythm_intensity": 1})

    with tempfile.TemporaryDirectory() as tmp:
        with phase("structuralize"):
            work, k2_launches = structuralize(Path(tmp) / "stage2")
            stage2_parity(Path(tmp))

        with phase("cli"):
            from etude_tpu_torch import infer
            from etude_tpu_torch.utils.midi import read_midi_notes

            settings = write_work_dir(Path(tmp) / "cli", ROOT, work / "tempo.json")
            rc = infer.main(["--config", str(settings), "--decode-only",
                             "--allow-random-weights", "--output_name", "smoke",
                             "--seed", "7"])
            out = Path(tmp) / "cli" / "outputs" / "infer" / "smoke.mid"
            if rc != 0 or not out.exists():
                raise RuntimeError(f"infer exited {rc}; {out} exists: {out.exists()}")
            notes = read_midi_notes(out)
            say(f"  {out.name}: {out.stat().st_size} bytes, {len(notes)} notes")

    main_row = rows[len(shapes) - 1]
    say(json.dumps({"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "etude_tpu_torch/csrc/decode_attention.cu",
        "replaces": "etude_tpu/ops/decode_attention.py:56",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        # Per launch on the main path: the mean over the 9 dilations of one
        # forward at the 12,288-frame bucket of a 240 s song.
        "name": "dilated_attention",
        "route": "cuda",
        "source": "etude_tpu_torch/csrc/dilated_attention.cu",
        "replaces": "etude_tpu/ops/dilated_attention.py:276",
        "launches": k2_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": statistics.mean(r["ms"] for r in k2_main),
        "plain_ms": statistics.mean(r["plain_ms"] for r in k2_main),
        "bound_ms": statistics.mean(r["bound_ms"] for r in k2_main),
        "bound_by": k2_main[0]["bound_by"],
        "library_ms": None,
    }]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
