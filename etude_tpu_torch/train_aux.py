"""Train the auxiliary models on synthetic corpora with exact labels, or
fine-tune them on the rendered corpus, and write params-only exports (JAX
counterpart: scripts/train_aux_synthetic.py).

    python -m etude_tpu_torch.train_aux beat         → <out>/beat_detector/latest
    python -m etude_tpu_torch.train_aux beat-corpus  → <out>/beat_detector/latest
    python -m etude_tpu_torch.train_aux amt          → <out>/extractor/latest
    python -m etude_tpu_torch.train_aux amt-corpus   → <out>/extractor/latest
    python -m etude_tpu_torch.train_aux separator    → <out>/separator/latest
    python -m etude_tpu_torch.train_aux all          → beat, amt, separator

`<out>` is `outputs/train_aux` at the repository root unless `--output-dir`
names another directory. Each export is a directory in the port's
params-only format (`params.npz`, floats stored as f16) with the run's
`metadata.json` beside it; `paths.{beat_detector,extractor,separator}_model`
pointed at it serves it. Nothing is written under `checkpoints/` or
`checkpoints_torch/`: those are the JAX package's orbax files and the
port's exports of them. `--device cpu` runs on the CPU (bf16 compute
on the card, f32 on the CPU).

The JAX script's arithmetic is kept: the published widths
(`BeatTransformerConfig()`, `AMTConfig()`, `SeparatorConfig()`), the
defaults table (batch x peak rate: beat 8 x 5e-4, amt 4 x 4e-4, separator
4 x 1e-3), `--beat-frames 512`, `--sep-frames 256`, the optimizer
(`parallel/train_step.make_aux_optimizer`), the amt positive-weight anneal
and head scales, the separator's per-example RMS normalisation, three
batch-building threads for beat (one shared generator, so the order of its
batches is not reproducible) and one for the others, and each mode's
held-out evaluation, whose values go into `metadata.json` under the JAX
keys.

The corpus modes read the rendered corpus (data/corpus_render.py, at
`CORPUS_ROOT`), split by song so that the eval songs never train:

  * `amt-corpus` (4 x 1.5e-4): 70% of the rows are train-split windows
    rendered through the serving chain, the rest synthetic clips; batches
    from a generator seeded by (seed, step) on 3 threads; held out, the full
    extract path on the eval songs' rendered `human.mid` (`--eval-seconds`).
  * `beat-corpus` (8 x 1.5e-4): half the rows are windows of a feature
    cache, one snap-gated f16 npz per (song, version) under
    `<out>/beat_corpus_cache` (separator features of the render, the grid's
    beat and downbeat times, its bpm: the JAX cache's keys), the rest
    synthetic scenes; (seed, step) generators on 2 threads; `--corpus-limit`
    caps the songs; held out, scripts/validate_beat_corpus.py `validate` on
    the eval songs and the synthetic retention check.
  * `beat --scenes-dir DIR` mixes `--corpus-mix` of each batch from the
    shards of scripts/gen_beat_scenes.py or gen_pseudopop_scenes.py and adds
    the full-chain evaluation on the eval songs.
  * `separator --pseudopop-mix F` replaces that share of each batch with
    pseudo-pop rows: read from the shards of `--pseudopop-cache`
    (scripts/gen_pseudopop_sep_examples.py), or rendered on the fly from
    the train split's snap-gated grids.

Where the JAX script reads the committed orbax checkpoints, the port reads
its own exports under `<out>`: the separator of the feature cache and of
the evaluations is `<out>/separator/latest`, and the corpus modes warm-start
from `<out>/<model>/latest` unless `--init-from` names another export. A
missing export means random weights (the separator, as the JAX separator
does for a missing checkpoint) or training from scratch (the warm starts),
each with a warning; an orbax checkpoint raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .config import BeatDetectorConfig, ExtractorConfig
from .data import corpus_render as cr
from .data import synthetic as syn
from .data.beat_detector import BeatDetector
from .data.extractor import AMTAPC_Extractor
from .data.pseudopop import build_stems, separation_example_from_stems
from .data.separation import SourceSeparator
from .evaluation.metrics.onset_f1 import onset_f1
from .models import amt, beat_transformer as bt, separator as sep
from .ops.dbn import DBNBeatTracker
from .ops.mel import log_mel_spectrogram_host
from .ops.peakpick import activations_to_notes
from .parallel.prefetch import prefetch
from .parallel.train_step import make_aux_optimizer, make_aux_train_step
from .scripts import AUX_EXPORTS, refuse_checkpoints
from .scripts.gen_beat_scenes import snap_gated_pool
from .scripts.gen_pseudopop_scenes import sample_window
from .scripts.validate_beat_corpus import grid_beat_times, snap_gated_song, validate
from .utils.audio import save_wav
from .utils.device import compute_dtype_for, resolve_device
from .utils.logger import logger
from .utils.midi import read_midi_notes
from .utils.model_loader import load_params
from .utils.training import save_aux_params
from .weights import (
    amt_from_jax, amt_to_jax, beat_transformer_from_jax, beat_transformer_to_jax,
    init_amt_params_np, init_beat_params_np, init_separator_params_np,
    separator_from_jax, separator_to_jax,
)

DEFAULT_OUTPUT_DIR = AUX_EXPORTS
MODES = ("beat", "amt", "separator")
DEFAULTS = {"beat": (8, 5e-4), "beat-corpus": (8, 1.5e-4), "amt": (4, 4e-4),
            "amt-corpus": (4, 1.5e-4), "separator": (4, 1e-3)}
EXPORT_NAMES = {"beat": "beat_detector", "beat-corpus": "beat_detector", "amt": "extractor",
                "amt-corpus": "extractor", "separator": "separator"}
SNAP_GATE = 0.02
PSEUDOPOP_DRAWS = 1000


@dataclasses.dataclass
class AuxTask:
    """One mode's model and data, made by `TASKS[mode](args, device,
    config=None)` (the published widths unless `config` names others):
    `gen(i)` builds step i's host batch (numpy), `loss(model, batch)` is its
    objective, `evaluate(model)` its held-out metrics (a dict for
    metadata.json) and `to_jax(model)` its tree."""

    name: str
    model: nn.Module
    gen: Callable[[int], Dict[str, Any]]
    loss: Callable[[nn.Module, Dict[str, Any]], Any]
    evaluate: Callable[[nn.Module], Dict[str, Any]]
    to_jax: Callable[[nn.Module], Any]
    workers: int = 1


@dataclasses.dataclass
class AuxRun:
    """What one mode's run did: per step its loss, its time (on the card,
    between CUDA events recorded after each step, so a step's time includes
    any wait for its batch; on the CPU, host time) and the host's wait for
    its batch; the metadata written beside the export."""

    name: str
    export: Path
    losses: List[float]
    step_seconds: List[float]
    wait_seconds: List[float]
    stats: Dict[str, Any]


def host_tensors(batch: Dict[str, Any], pin: bool) -> Dict[str, Any]:
    """numpy arrays → CPU tensors (pinned for the card); dicts of scalars
    (amt's positive weights) → dicts of floats."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, dict):
            out[key] = {k: float(v) for k, v in value.items()}
        else:
            t = torch.from_numpy(np.ascontiguousarray(value))
            out[key] = t.pin_memory() if pin else t
    return out


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    return {k: v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def train_loop(name: str, model: nn.Module, loss, gen_fn, steps: int, lr: float,
               device, log_every: int = 50, workers: int = 1):
    """AdamW over host-built batches (JAX `train_loop` :69): one step per
    batch; the losses stay on the device and are read at the log points (the
    first step, every `log_every`, the last), each logged value the mean
    over its window. Returns (losses, step seconds, wait seconds, stats);
    the model is left in eval mode."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    tx = make_aux_optimizer(lr, steps)
    model.train().requires_grad_(True)
    opt_state = tx.init(list(model.parameters()))
    step = make_aux_train_step(tx, loss, device)
    batches = prefetch(lambda i: host_tensors(gen_fn(i), on_card), steps, workers=workers)

    def mark():
        if not on_card:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    t0 = time.time()
    marks, waits, losses, window = [mark()], [], [], []
    first_loss = last_loss = None
    for i in range(steps):
        t = time.perf_counter()
        batch = next(batches)
        waits.append(time.perf_counter() - t)
        metrics = step(model, opt_state, to_device(batch, device))
        marks.append(mark())
        losses.append(metrics["loss"])
        window.append(metrics["loss"])
        if i == 0 or (i + 1) % log_every == 0 or i == steps - 1:
            value = float(np.mean([float(x) for x in window]))
            window = []
            if first_loss is None:
                first_loss = value
            last_loss = value
            logger.info(f"[{name}] step {i + 1}/{steps} loss {value:.4f} "
                        f"({time.time() - t0:.0f}s)")
    if on_card:
        torch.cuda.synchronize(device)
        step_seconds = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
    else:
        step_seconds = [b - a for a, b in zip(marks, marks[1:])]
    model.eval().requires_grad_(False)
    stats = {"first_loss": first_loss, "final_loss": last_loss, "steps": steps,
             "seconds": round(time.time() - t0, 1)}
    return [float(x) for x in losses], step_seconds, waits, stats


def _initial_params(what: str, init_params, init_from: Optional[str]):
    if not init_from:
        return init_params()
    params = load_params(what, init_from, lambda seed: init_params())
    logger.info(f"warm start from {init_from}")
    return params


def output_dir_of(args) -> Path:
    return Path(getattr(args, "output_dir", None) or DEFAULT_OUTPUT_DIR)


def _corpus_warm_start(what: str, mode: str, args, init_params):
    """(params, the export they came from or None) for a corpus mode (JAX
    :405-415, :598-608): `--init-from`, else this run's own export of the
    model; where that is missing, the model trains from scratch."""
    init_from = args.init_from or str(output_dir_of(args) / EXPORT_NAMES[mode] / "latest")
    if Path(init_from).exists():
        return _initial_params(what, init_params, init_from), init_from
    logger.warn("no warm-start checkpoint found; training from scratch")
    return init_params(), None


def export_separator(args, device: torch.device) -> SourceSeparator:
    """The separator of the corpus feature paths: this run's export
    `<out>/separator/latest` (JAX: the committed checkpoint); random weights
    from seed 0, with a warning, where it is missing."""
    return SourceSeparator(model_path=output_dir_of(args) / "separator" / "latest",
                           device=device, allow_random_weights=True)


def corpus_validation(separator, model: nn.Module, eval_dirs, args, device) -> Dict[str, Any]:
    """Held-out corpus songs through the full chain (render → separator →
    the trained Beat-Transformer in the serving BeatDetector → DBN;
    scripts/validate_beat_corpus.py `validate`), under the JAX keys."""
    detector = BeatDetector(BeatDetectorConfig(), params=beat_transformer_to_jax(model),
                            device=device)
    summary = validate(separator, detector, eval_dirs, n_songs=len(eval_dirs),
                       seconds=args.eval_seconds, snap_gate=SNAP_GATE)
    logger.success(f"beat F (held-out corpus, full chain): {summary['mean_beat_f']} "
                   f"(octave-tolerant {summary['mean_beat_f_octave']})")
    return {
        "beat_f_corpus": summary["mean_beat_f"],
        "beat_f_corpus_octave": summary["mean_beat_f_octave"],
        "beat_f_per_song": {r["song"]: r["beat_f"] for r in summary["songs"]},
    }


# --------------------------------------------------------------------- beat
def synthetic_beat_f(model: nn.Module, args, device: torch.device) -> float:
    """Held-out synthetic scenes: sigmoid activations → DBN → F-measure."""
    dtype = compute_dtype_for(device)
    eval_rng = np.random.default_rng(args.seed + 10_000)
    tracker = DBNBeatTracker(min_bpm=70, max_bpm=250, fps=syn.BEAT_FPS)
    scores = []
    for _ in range(args.eval_clips):
        ex = syn.synth_beat_example(eval_rng, T=args.beat_frames)
        with torch.inference_mode():
            logits = model(torch.from_numpy(ex["x"][None]).to(device), dtype)[0]
        act = torch.sigmoid(logits)[0].float().cpu().numpy()
        scores.append(syn.beat_f_measure(tracker(act[:, 0]), ex["beat_times"]))
    return float(np.mean(scores))


def load_beat_scenes(scenes_dir) -> Optional[Dict[str, np.ndarray]]:
    """The `shard_*.npz` scenes under `scenes_dir` (x, activations, tempo),
    or None when there are none."""
    shards = sorted(Path(scenes_dir).glob("shard_*.npz"))
    if not shards:
        return None
    xs, acts, tempos = [], [], []
    for s in shards:
        with np.load(s) as z:
            xs.append(z["x"].astype(np.float32))
            acts.append(z["activations"].astype(np.float32))
            tempos.append(z["tempo"])
    return {"x": np.concatenate(xs), "activations": np.concatenate(acts),
            "tempo": np.concatenate(tempos).astype(np.int32), "shards": len(shards)}


def beat_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_beat` :119: procedural scenes, with `--scenes-dir` a
    `--corpus-mix` share of each batch from pre-rendered corpus scenes and
    the full-chain evaluation on the held-out corpus songs (:134-168,
    :193-226)."""
    config = config or bt.BeatTransformerConfig()
    params = _initial_params("beat model", lambda: init_beat_params_np(config, seed=args.seed),
                             args.init_from)
    model = beat_transformer_from_jax(params, config, device)
    logger.info(f"beat model: {bt.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)
    rng = np.random.default_rng(args.seed)
    T = args.beat_frames
    corpus_mix = getattr(args, "corpus_mix", 0.5)

    scenes = None
    if getattr(args, "scenes_dir", None):
        scenes = load_beat_scenes(args.scenes_dir)
        if scenes is None:
            logger.warn(f"no shards under {args.scenes_dir}; procedural only")
        else:
            logger.info(f"corpus scenes: {len(scenes['x'])} windows from "
                        f"{scenes['shards']} shards (mix {corpus_mix:.2f})")

    def gen(_i):
        batch = syn.beat_batch(rng, args.batch, T=T)
        if scenes is not None and corpus_mix > 0:
            n_c = int(round(args.batch * corpus_mix))
            if n_c:
                idx = rng.integers(len(scenes["x"]), size=n_c)
                batch["x"][:n_c] = scenes["x"][idx][:, :, :T]
                batch["activations"][:n_c] = scenes["activations"][idx][:, :T]
                batch["tempo"][:n_c] = scenes["tempo"][idx]
        return batch

    def evaluate(model):
        f_measure = synthetic_beat_f(model, args, device)
        logger.success(f"beat F-measure (held-out synthetic): {f_measure:.3f}")
        stats = {"beat_f_measure": f_measure,
                 "corpus": ("synthetic-scenes + corpus-piano-scenes" if scenes is not None
                            else "synthetic-scenes"),
                 "corpus_mix": corpus_mix if scenes is not None else 0.0,
                 "train_frames": T, "model": "BeatTransformerConfig()"}
        if scenes is not None:
            _, eval_dirs = cr.split_songs(cr.corpus_song_dirs())
            stats.update(corpus_validation(export_separator(args, device), model, eval_dirs,
                                           args, device))
            stats["eval_songs"] = [d.name for d in eval_dirs]
        return stats

    # Host scene synthesis dominates the step on one thread: stripe it.
    return AuxTask("beat", model, gen, lambda m, batch: bt.loss_fn(m, batch, dtype), evaluate,
                   beat_transformer_to_jax, workers=3)


# -------------------------------------------------------------- beat-corpus
def beat_act_from_times(times, down_times, start_frame, T, fps):
    """Beat/downbeat times (song-absolute seconds) → widened activation
    targets for a [start_frame, start_frame+T) feature window (the same
    madmom-style ±1-frame 0.5 widening as synth_beat_example; JAX
    `_beat_act_from_times` :501)."""
    act = np.zeros((T, 2), np.float32)
    down = set(np.round(np.asarray(down_times) * fps).astype(int).tolist())
    for t in np.asarray(times):
        frame = int(round(t * fps)) - start_frame
        is_down = int(round(t * fps)) in down
        for d, w in ((-1, 0.5), (0, 1.0), (1, 0.5)):
            f = frame + d
            if 0 <= f < T:
                act[f, 0] = max(act[f, 0], w)
                if is_down:
                    act[f, 1] = max(act[f, 1], w)
    return act


def prepare_beat_feature_cache(song_dirs, cache_dir: Path, seconds: float, snap_gate: float,
                               separator: Callable[[], SourceSeparator],
                               versions=("etude_d", "etude_d_d")) -> List[Path]:
    """The serving-chain feature cache for beat fine-tuning (JAX :519).

    Per (song, version) with a snap-gated grid: 44.1 kHz render → int16 WAV
    → the separator's serving features [5, T, 128] dB, stored as f16 npz
    with the grid's beat/downbeat times and bpm (the JAX cache's keys, so
    either package reads the other's files). `separator()` gives the
    separator; it is called at the first entry to compute. Entries already
    on disk are kept."""
    cache_dir.mkdir(parents=True, exist_ok=True)
    entries = []
    for d in song_dirs:
        for version in versions:
            out = cache_dir / f"{d.name}_{version}.npz"
            if out.exists():
                entries.append(out)
                continue
            gated = snap_gated_song(d / f"{version}.mid", seconds, snap_gate)
            if gated is None:
                continue
            notes, tempo, _snap = gated
            horizon = max(n["offset"] for n in notes)
            # A pre-rendered WAV beside the entry is reused (renders are the
            # slow part); it is removed once the npz is written.
            wav = cache_dir / f"{d.name}_{version}.wav"
            if not wav.exists():
                save_wav(wav, syn.render_piano(notes, horizon + 1.0, sr=44100), 44100)
            features = separator().separate_features(wav)
            beats = grid_beat_times(tempo, horizon)
            downs = np.asarray([t for r in tempo for t in r["downbeats"]], np.float32)
            np.savez_compressed(
                out, features=features.astype(np.float16),
                beat_times=beats.astype(np.float32), downbeat_times=downs,
                bpm=np.float32(tempo[0]["bpm"]),
            )
            entries.append(out)
            wav.unlink(missing_ok=True)
            logger.info(f"[beat-corpus cache] {out.name}: "
                        f"{features.shape[1]} frames, {len(beats)} beats")
    return entries


def beat_corpus_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_beat_corpus` :578: fine-tune the Beat-Transformer on rendered
    corpus covers through the serving feature chain, mixed half and half
    with synthetic scenes so the multi-stem skill is retained."""
    config = config or bt.BeatTransformerConfig()
    params, init_from = _corpus_warm_start(
        "beat model", "beat-corpus", args, lambda: init_beat_params_np(config, seed=args.seed))
    model = beat_transformer_from_jax(params, config, device)
    dtype = compute_dtype_for(device)

    train_dirs, eval_dirs = cr.split_songs(cr.corpus_song_dirs())
    if args.corpus_limit:
        train_dirs = train_dirs[:args.corpus_limit]
        eval_dirs = eval_dirs[:max(args.corpus_limit // 4, 1)]
    logger.info(f"corpus: {len(train_dirs)} train songs, {len(eval_dirs)} held-out "
                f"({', '.join(d.name for d in eval_dirs)})")
    # Built at the first cache entry to compute, as the JAX script does.
    separator = functools.cache(lambda: export_separator(args, device))
    entries = prepare_beat_feature_cache(
        train_dirs, output_dir_of(args) / "beat_corpus_cache",
        seconds=args.eval_seconds + 60.0, snap_gate=SNAP_GATE, separator=separator)
    if not entries:
        raise RuntimeError("no train song of the corpus passed the snap gate: the "
                           "beat-corpus feature cache is empty")
    logger.info(f"feature cache: {len(entries)} song-versions")
    # Read-only after this point: shared safely across prefetch workers.
    cache = {}
    for p in entries:
        with np.load(p) as z:
            cache[p.name] = {k: z[k] for k in z.files}
    names = sorted(cache)
    T = args.beat_frames
    corpus_frac = 0.5

    def corpus_example(r):
        e = cache[names[int(r.integers(len(names)))]]
        T_song = e["features"].shape[1]
        if T_song <= T + 2:
            return None
        s = int(r.integers(0, T_song - T))
        x = e["features"][:, s:s + T].astype(np.float32)
        act = beat_act_from_times(e["beat_times"], e["downbeat_times"], s, T, syn.BEAT_FPS)
        tempo = np.int32(np.clip(round(float(e["bpm"])), 0, 299))
        return {"x": x, "activations": act, "tempo": tempo}

    def gen(i):
        # Per-step generator: the two prefetch threads stripe the steps.
        r = np.random.default_rng((args.seed, i))
        xs, acts, tempos = [], [], []
        for _ in range(args.batch):
            ex = corpus_example(r) if r.random() < corpus_frac else None
            if ex is None:
                s = syn.synth_beat_example(r, T=T)
                ex = {"x": s["x"], "activations": s["activations"], "tempo": s["tempo"]}
            xs.append(ex["x"])
            acts.append(ex["activations"])
            tempos.append(ex["tempo"])
        return {"x": np.stack(xs), "activations": np.stack(acts), "tempo": np.stack(tempos)}

    def evaluate(model):
        stats = corpus_validation(separator(), model, eval_dirs, args, device)
        synth_f = synthetic_beat_f(model, args, device)
        logger.success(f"beat F (held-out synthetic, retention): {synth_f:.3f}")
        stats.update({
            "beat_f_synthetic": synth_f,
            "corpus": "rendered-corpus(serving-chain)+synthetic-scenes",
            "corpus_frac": corpus_frac,
            "train_song_versions": len(entries),
            "eval_songs": [d.name for d in eval_dirs],
            "warm_start": init_from,
            "train_frames": T,
            "model": "BeatTransformerConfig()",
        })
        return stats

    return AuxTask("beat-corpus", model, gen, lambda m, batch: bt.loss_fn(m, batch, dtype),
                   evaluate, beat_transformer_to_jax, workers=2)


# ---------------------------------------------------------------------- amt
def amt_spec_from_wave(wave: np.ndarray, fc_margin: int, n_frame: int) -> np.ndarray:
    """Rendered wave → margin-padded [n_bin, margin + T + margin] log-mel on
    the host (JAX `_amt_spec_from_wave` :238)."""
    logmel = log_mel_spectrogram_host(
        wave, sr=syn.AMT_SR, n_fft=2048, hop=syn.AMT_HOP, win_length=2048,
        n_mels=256, log_offset=1e-8,
    )  # [T', 256]
    T = logmel.shape[0]
    if T < n_frame:
        logmel = np.pad(logmel, ((0, n_frame - T), (0, 0)), constant_values=-18.0)
    spec = np.full((256, n_frame + 2 * fc_margin), -18.0, np.float32)
    spec[:, fc_margin:fc_margin + n_frame] = logmel[:n_frame].T
    return spec


# Gradient balance on the shared trunk: velocity CE (~ln 128 per branch)
# would otherwise starve the converging onset/offset BCEs (JAX :321-326).
AMT_HEAD_SCALES = {"onset": 5.0, "offset": 5.0, "mpe": 1.0, "velocity": 0.1}


def amt_weights_at(i: int, steps: int, warm_start: bool) -> Dict[str, np.float32]:
    """The positive-class weights at step i (JAX `weights_at` :291):
    annealed linearly from (120, 120, 3) to 1 over the first 30% of the
    steps; a warm start stays at 1."""
    w0_onset, w0_mpe = (1.0, 1.0) if warm_start else (120.0, 3.0)
    t = min(i / max(steps * 0.3, 1), 1.0)
    return {
        "onset": np.float32(1.0 + (w0_onset - 1.0) * (1.0 - t)),
        "offset": np.float32(1.0 + (w0_onset - 1.0) * (1.0 - t)),
        "mpe": np.float32(1.0 + (w0_mpe - 1.0) * (1.0 - t)),
    }


def amt_loss(model: nn.Module, batch: Dict[str, Any], dtype: torch.dtype):
    """The hFT objective as the script trains it: remat on, the batch's
    positive weights, velocity CE on sounding cells only, the head scales."""
    pos_weights = dict(batch["pos_w"])
    pos_weights.update({"velocity": 1.0, "velocity_silent": 0.0})
    return amt.loss_fn(model, batch, dtype, remat=True, pos_weights=pos_weights,
                       head_scales=AMT_HEAD_SCALES)


def amt_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_amt` :258."""
    config = config or amt.AMTConfig()
    params = _initial_params("extractor", lambda: init_amt_params_np(config, seed=args.seed),
                             args.init_from)
    model = amt_from_jax(params, config, device)
    logger.info(f"amt model: {amt.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)
    rng = np.random.default_rng(args.seed)
    fps = syn.AMT_SR / syn.AMT_HOP
    dur = config.n_frame / fps + 0.3

    def make_example(r, density=None):
        # Training sweeps 2-10 notes/s; the held-out clips keep 3/s.
        nps = density if density is not None else float(r.uniform(2.0, 10.0))
        notes = syn.synth_piano_notes(r, dur, notes_per_sec=nps)
        wave = syn.render_piano(notes, dur)
        spec = amt_spec_from_wave(wave, config.n_margin, config.n_frame)
        return spec, syn.amt_targets(notes, config.n_frame, fps=fps), notes

    def gen(i):
        specs, tg = [], {"onset": [], "offset": [], "mpe": [], "velocity": []}
        for _ in range(args.batch):
            spec, targets, _notes = make_example(rng)
            specs.append(spec)
            for k in tg:
                tg[k].append(targets[k])
        batch = {k: np.stack(v) for k, v in tg.items()}
        batch["spec"] = np.stack(specs)
        batch["pos_w"] = amt_weights_at(i, args.steps, bool(args.init_from))
        return batch

    def evaluate(model):
        eval_rng = np.random.default_rng(args.seed + 10_000)
        f1s = []
        for _ in range(args.eval_clips):
            spec, _targets, notes = make_example(eval_rng, density=3.0)
            with torch.inference_mode():
                out = model(torch.from_numpy(spec[None]).to(device), dtype)
            est = activations_to_notes(
                out["onset_time"][0].float().cpu().numpy(),
                out["offset_time"][0].float().cpu().numpy(),
                out["mpe_time"][0].float().cpu().numpy(),
                out["velocity_time"][0].argmax(-1).to(torch.int32).cpu().numpy(),
                hop_sec=syn.AMT_HOP / syn.AMT_SR,
            )
            f1s.append(onset_f1(notes, est)["f1"])
        f1 = float(np.mean(f1s))
        logger.success(f"amt onset F1 (held-out synthetic): {f1:.3f}")
        return {"onset_f1": f1, "corpus": "synthetic-additive-piano", "model": "AMTConfig()"}

    return AuxTask("amt", model, gen, lambda m, batch: amt_loss(m, batch, dtype),
                   evaluate, amt_to_jax)


# --------------------------------------------------------------- amt-corpus
def eval_extract_corpus(extractor: AMTAPC_Extractor, eval_dirs, seconds: float = 120.0):
    """Held-out full-path fidelity (JAX :364): each eval song's human.mid
    rendered at 44.1 kHz into a WAV, the complete extract path (decode →
    resample → device mel → segmented forward → peak picking), onset F1
    against the song's own notes. The renders go to a temporary directory.
    Returns (mean F1, {song: F1})."""
    per_song = {}
    with tempfile.TemporaryDirectory() as tmp:
        for d in eval_dirs:
            ref = [n for n in read_midi_notes(d / "human.mid") if n["onset"] < seconds - 2]
            if not ref:
                continue
            wav = Path(tmp) / f"{d.name}.wav"
            save_wav(wav, syn.render_piano(ref, seconds, sr=44100), 44100)
            est = extractor.extract(wav, Path(tmp) / f"{d.name}.json")
            est = [n for n in est if n["onset"] < seconds - 2]
            per_song[d.name] = round(onset_f1(ref, est)["f1"], 4)
            logger.info(f"[amt-corpus eval] {d.name}: onset F1 {per_song[d.name]:.3f}")
    mean_f1 = float(np.mean(list(per_song.values()))) if per_song else 0.0
    return mean_f1, per_song


def amt_corpus_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_amt_corpus` :395: fine-tune the extractor on rendered-corpus
    windows through the serving signal chain, mixed with synthetic clips so
    the random-note skill is retained."""
    config = config or amt.AMTConfig()
    params, init_from = _corpus_warm_start(
        "extractor", "amt-corpus", args, lambda: init_amt_params_np(config, seed=args.seed))
    model = amt_from_jax(params, config, device)
    logger.info(f"amt model: {amt.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)

    train_dirs, eval_dirs = cr.split_songs(cr.corpus_song_dirs())
    logger.info(f"corpus: {len(train_dirs)} train songs, {len(eval_dirs)} held-out eval "
                f"songs ({', '.join(d.name for d in eval_dirs)})")
    pool = cr.CorpusNotePool(train_dirs)
    fps = syn.AMT_SR / syn.AMT_HOP
    dur = config.n_frame / fps + 0.3
    corpus_frac = 0.7

    def gen(i):
        # Per-step generator: the three prefetch threads stripe the steps.
        r = np.random.default_rng((args.seed, i))
        specs, tg = [], {"onset": [], "offset": [], "mpe": [], "velocity": []}
        for _ in range(args.batch):
            notes = pool.sample_window(r, dur) if r.random() < corpus_frac else []
            if not notes:
                nps = float(r.uniform(2.0, 10.0))
                notes = syn.synth_piano_notes(r, dur, notes_per_sec=nps)
            wave = cr.render_serving(notes, dur)
            specs.append(amt_spec_from_wave(wave, config.n_margin, config.n_frame))
            targets = syn.amt_targets(notes, config.n_frame, fps=fps)
            for k in tg:
                tg[k].append(targets[k])
        batch = {k: np.stack(v) for k, v in tg.items()}
        batch["spec"] = np.stack(specs)
        batch["pos_w"] = amt_weights_at(i, args.steps, init_from is not None)
        return batch

    def evaluate(model):
        extractor = AMTAPC_Extractor(ExtractorConfig(), params=amt_to_jax(model), device=device)
        mean_f1, per_song = eval_extract_corpus(extractor, eval_dirs, seconds=args.eval_seconds)
        logger.success(f"amt-corpus onset F1 (held-out corpus, full path): {mean_f1:.3f}")
        return {
            "onset_f1_corpus": mean_f1,
            "onset_f1_per_song": per_song,
            "eval_seconds": args.eval_seconds,
            "corpus": "rendered-corpus(serving-chain)+synthetic",
            "corpus_frac": corpus_frac,
            "train_songs": len(train_dirs),
            "eval_songs": [d.name for d in eval_dirs],
            "warm_start": init_from,
            "model": "AMTConfig()",
        }

    return AuxTask("amt-corpus", model, gen, lambda m, batch: amt_loss(m, batch, dtype),
                   evaluate, amt_to_jax, workers=3)


# ---------------------------------------------------------------- separator
def load_pseudopop_cache(cache_dir) -> Optional[Dict[str, np.ndarray]]:
    """The `shard_*.npz` rows under `cache_dir` (mix_mag, stem_mags), or
    None when there are none."""
    shards = sorted(Path(cache_dir).glob("shard_*.npz"))
    if not shards:
        return None
    ms, ss = [], []
    for s in shards:
        with np.load(s) as z:
            ms.append(z["mix_mag"].astype(np.float32))
            ss.append(z["stem_mags"].astype(np.float32))
    return {"mix_mag": np.concatenate(ms), "stem_mags": np.concatenate(ss),
            "shards": len(shards)}


def separator_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_separator` :715: synthetic stems, with `--pseudopop-mix` a
    share of each batch from pseudo-pop audio stems through the serving
    STFT, read from `--pseudopop-cache` or rendered on the fly from the
    train split's snap-gated grids (:730-801)."""
    config = config or sep.SeparatorConfig()
    params = _initial_params("separator",
                             lambda: init_separator_params_np(config, seed=args.seed),
                             args.init_from)
    model = separator_from_jax(params, config, device)
    logger.info(f"separator: {sep.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)
    rng = np.random.default_rng(args.seed)
    T = args.sep_frames

    pp_mix = float(getattr(args, "pseudopop_mix", 0.0))
    cache_dir = getattr(args, "pseudopop_cache", None)
    pp_cache = pp_pool = None
    if pp_mix > 0 and cache_dir:
        pp_cache = load_pseudopop_cache(cache_dir)
        if pp_cache is None:
            logger.warn(f"no shards under {cache_dir}; rendering on the fly")
        else:
            logger.info(f"pseudo-pop cache: {len(pp_cache['mix_mag'])} pre-rendered "
                        f"examples from {pp_cache['shards']} shards")
    if pp_mix > 0 and pp_cache is None:
        train_dirs, _ = cr.split_songs(cr.corpus_song_dirs())
        pp_pool = snap_gated_pool(train_dirs, SNAP_GATE)
        if not pp_pool:
            raise RuntimeError("--pseudopop-mix: no train song of the corpus passed the "
                               "snap gate, so there is nothing to render")
        logger.info(f"pseudo-pop pool: {len(pp_pool)} grids (mix {pp_mix:.2f})")

    def pseudopop_example():
        dur = (T * 1024) / 44100.0 + 0.05
        for _ in range(PSEUDOPOP_DRAWS):
            spec = sample_window(rng, pp_pool, dur)
            if spec is None:
                continue
            aug, b_in, d_in, gains, drum_jitter, _act, _bpm = spec
            mix, stems, _ = build_stems(aug, b_in, d_in, dur, sr=44100,
                                        seed=int(rng.integers(2 ** 31)), gains=gains,
                                        drum_jitter=drum_jitter, rng=rng)
            if float(np.abs(mix).max()) < 1e-4:
                continue
            return separation_example_from_stems(mix, stems, T=T)
        # The JAX script draws without end: a window too short to hold ten
        # beats (sample_window's floor) never passes.
        raise RuntimeError(f"no usable pseudo-pop window of {T} frames in "
                           f"{PSEUDOPOP_DRAWS} draws")

    def gen(_i):
        batch = syn.separation_batch(rng, args.batch, T=T)
        n_pp = int(round(args.batch * pp_mix))
        if pp_cache is not None and n_pp:
            idx = rng.integers(len(pp_cache["mix_mag"]), size=n_pp)
            Tc = min(pp_cache["mix_mag"].shape[1], T)
            batch["mix_mag"][:n_pp, :Tc] = pp_cache["mix_mag"][idx][:, :Tc]
            batch["stem_mags"][:n_pp, :, :Tc] = pp_cache["stem_mags"][idx][:, :, :Tc]
        elif pp_pool:
            for b in range(n_pp):
                ex = pseudopop_example()
                batch["mix_mag"][b] = ex["mix_mag"]
                batch["stem_mags"][b] = ex["stem_mags"]
        # Per-example loudness normalisation: the L1 would otherwise weight
        # loud mixes more.
        rms = np.sqrt((batch["mix_mag"] ** 2).mean(axis=(1, 2), keepdims=True))
        rms = np.maximum(rms, 1e-6)
        batch["mix_mag"] /= rms
        batch["stem_mags"] /= rms[:, None]
        return batch

    def evaluate(model):
        # Magnitude SDR of the masked mixture against the uniform-mask baseline.
        eval_rng = np.random.default_rng(args.seed + 10_000)
        sdrs, base_sdrs = [], []
        for _ in range(args.eval_clips):
            ex = syn.synth_separation_example(eval_rng, T=T)
            rms = max(float(np.sqrt((ex["mix_mag"] ** 2).mean())), 1e-6)
            ex = {k: v / rms for k, v in ex.items()}
            mix = torch.from_numpy(ex["mix_mag"][None]).to(device)
            with torch.inference_mode():
                masks = model(torch.log1p(mix), dtype)[0].float().cpu().numpy()
            sdrs.append(syn.stem_sdr(masks * ex["mix_mag"][None], ex["stem_mags"]).mean())
            base = np.repeat(ex["mix_mag"][None] / 5.0, 5, axis=0)
            base_sdrs.append(syn.stem_sdr(base, ex["stem_mags"]).mean())
        sdr, base = float(np.mean(sdrs)), float(np.mean(base_sdrs))
        logger.success(f"separator stem SDR (held-out synthetic): {sdr:.2f} dB "
                       f"(uniform-mask baseline {base:.2f} dB)")
        # The JAX script names the pseudo-pop rows only when it rendered them.
        corpus = (f"synthetic-stems + pseudo-pop audio stems (mix {pp_mix:.2f})" if pp_pool
                  else "synthetic-stems")
        return {"stem_sdr_db": sdr, "baseline_sdr_db": base, "corpus": corpus,
                "train_frames": T, "model": "SeparatorConfig()"}

    return AuxTask("separator", model, gen, lambda m, batch: sep.loss_fn(m, batch, dtype),
                   evaluate, separator_to_jax)


TASKS = {"beat": beat_task, "beat-corpus": beat_corpus_task, "amt": amt_task,
         "amt-corpus": amt_corpus_task, "separator": separator_task}


def run_mode(name: str, args, device: torch.device, output_dir: Path) -> AuxRun:
    """Train one mode, evaluate it, export it under `output_dir`."""
    logger.stage(f"Training {name}")
    task = TASKS[name](args, device)
    losses, step_seconds, waits, stats = train_loop(
        name, task.model, task.loss, task.gen, args.steps, args.lr, device,
        workers=task.workers)
    stats.update(task.evaluate(task.model))
    out = output_dir / EXPORT_NAMES[name] / "latest"
    save_aux_params(out, task.to_jax(task.model), metadata=stats)
    logger.success(f"saved {out}")
    return AuxRun(name, out, losses, step_seconds, waits, stats)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Train the auxiliary models on synthetic corpora or the rendered "
                    "corpus (PyTorch port)")
    parser.add_argument("model", choices=["beat", "beat-corpus", "amt", "amt-corpus",
                                          "separator", "all"])
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--batch", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--eval-clips", type=int, default=8)
    parser.add_argument("--beat-frames", type=int, default=512)
    parser.add_argument("--sep-frames", type=int, default=256)
    parser.add_argument("--init-from", type=str, default=None,
                        help="warm start from a params-only export of the port (the "
                             "corpus modes default to <output-dir>/<model>/latest)")
    parser.add_argument("--eval-seconds", type=float, default=120.0,
                        help="corpus modes: per-song audio horizon of the held-out "
                             "evaluation")
    parser.add_argument("--corpus-limit", type=int, default=0,
                        help="beat-corpus: cap the train songs (and the eval songs "
                             "at a quarter of it)")
    parser.add_argument("--scenes-dir", type=str, default=None,
                        help="beat: mix in pre-rendered corpus scenes "
                             "(scripts/gen_beat_scenes.py shards)")
    parser.add_argument("--corpus-mix", type=float, default=0.5,
                        help="beat: fraction of each batch drawn from --scenes-dir")
    parser.add_argument("--pseudopop-cache", type=str, default=None,
                        help="separator: dir of pre-rendered pseudo-pop example shards "
                             "(scripts/gen_pseudopop_sep_examples.py)")
    parser.add_argument("--pseudopop-mix", type=float, default=0.0,
                        help="separator: fraction of each batch from pseudo-pop audio "
                             "stems through the serving STFT (train-split corpus grids)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--output-dir", type=str, default=None,
                        help=f"where the exports go (default {DEFAULT_OUTPUT_DIR})")
    return parser.parse_args(argv)


def run(argv=None) -> List[AuxRun]:
    """The CLI's work: one `AuxRun` per mode trained."""
    args = parse_args(argv)
    output_dir = refuse_checkpoints(args.output_dir or DEFAULT_OUTPUT_DIR, "--output-dir")
    args.output_dir = output_dir
    device = resolve_device(args.device)
    runs = []
    for name in (MODES if args.model == "all" else (args.model,)):
        batch, lr = DEFAULTS[name]
        sub = argparse.Namespace(**vars(args))
        sub.batch = args.batch or batch
        sub.lr = args.lr or lr
        runs.append(run_mode(name, sub, device, output_dir))
    return runs


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
