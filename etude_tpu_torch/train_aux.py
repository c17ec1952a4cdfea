"""Train the auxiliary models on synthetic corpora with exact labels and write
params-only exports (JAX counterpart: scripts/train_aux_synthetic.py).

    python -m etude_tpu_torch.train_aux beat       → <out>/beat_detector/latest
    python -m etude_tpu_torch.train_aux amt        → <out>/extractor/latest
    python -m etude_tpu_torch.train_aux separator  → <out>/separator/latest
    python -m etude_tpu_torch.train_aux all        → all three, in that order

`<out>` is `outputs/train_aux` at the repository root unless `--output-dir`
names another directory. Each export is a directory in the port's
params-only format (`params.npz`, floats stored as f16) with the run's
`metadata.json` beside it; `paths.{beat_detector,extractor,separator}_model`
pointed at it serves it. Nothing is written under `checkpoints/`: those are
the JAX package's orbax files. `--device cpu` runs on the CPU (bf16 compute
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
keys. The corpus modes (`beat-corpus`, `amt-corpus`), `--scenes-dir` and the
pseudo-pop options read the reference corpus of
etude_tpu/data/corpus_render.py, or shards rendered from it, which the
repository does not hold; they raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from .data import synthetic as syn
from .evaluation.metrics.onset_f1 import onset_f1
from .models import amt, beat_transformer as bt, separator as sep
from .ops.dbn import DBNBeatTracker
from .ops.mel import log_mel_spectrogram_host
from .ops.peakpick import activations_to_notes
from .parallel.prefetch import prefetch
from .parallel.train_step import make_aux_optimizer, make_aux_train_step
from .utils.device import compute_dtype_for, resolve_device
from .utils.logger import logger
from .utils.model_loader import load_params
from .utils.training import save_aux_params
from .weights import (
    amt_from_jax, amt_to_jax, beat_transformer_from_jax, beat_transformer_to_jax,
    init_amt_params_np, init_beat_params_np, init_separator_params_np,
    separator_from_jax, separator_to_jax,
)

REPO = Path(__file__).resolve().parent.parent
DEFAULT_OUTPUT_DIR = REPO / "outputs" / "train_aux"
MODES = ("beat", "amt", "separator")
DEFAULTS = {"beat": (8, 5e-4), "amt": (4, 4e-4), "separator": (4, 1e-3)}
EXPORT_NAMES = {"beat": "beat_detector", "amt": "extractor", "separator": "separator"}
NOT_PORTED = ("needs the reference corpus (etude_tpu/data/corpus_render.py) or shards "
              "rendered from it, which this repository does not hold; it waits in "
              "ROADMAP.md Queue 1 item 7 (aux training: the corpus modes)")


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


# --------------------------------------------------------------------- beat
def beat_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_beat` :119 (procedural scenes only)."""
    config = config or bt.BeatTransformerConfig()
    params = _initial_params("beat model", lambda: init_beat_params_np(config, seed=args.seed),
                             args.init_from)
    model = beat_transformer_from_jax(params, config, device)
    logger.info(f"beat model: {bt.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)
    rng = np.random.default_rng(args.seed)
    T = args.beat_frames

    def evaluate(model):
        eval_rng = np.random.default_rng(args.seed + 10_000)
        tracker = DBNBeatTracker(min_bpm=70, max_bpm=250, fps=syn.BEAT_FPS)
        scores = []
        for _ in range(args.eval_clips):
            ex = syn.synth_beat_example(eval_rng, T=T)
            with torch.inference_mode():
                logits = model(torch.from_numpy(ex["x"][None]).to(device), dtype)[0]
            act = torch.sigmoid(logits)[0].float().cpu().numpy()
            scores.append(syn.beat_f_measure(tracker(act[:, 0]), ex["beat_times"]))
        f_measure = float(np.mean(scores))
        logger.success(f"beat F-measure (held-out synthetic): {f_measure:.3f}")
        return {"beat_f_measure": f_measure, "corpus": "synthetic-scenes", "corpus_mix": 0.0,
                "train_frames": T, "model": "BeatTransformerConfig()"}

    # Host scene synthesis dominates the step on one thread: stripe it.
    return AuxTask("beat", model, lambda _i: syn.beat_batch(rng, args.batch, T=T),
                   lambda m, batch: bt.loss_fn(m, batch, dtype), evaluate,
                   beat_transformer_to_jax, workers=3)


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


# ---------------------------------------------------------------- separator
def separator_task(args, device: torch.device, config=None) -> AuxTask:
    """JAX `run_separator` :715 (synthetic stems only)."""
    config = config or sep.SeparatorConfig()
    params = _initial_params("separator",
                             lambda: init_separator_params_np(config, seed=args.seed),
                             args.init_from)
    model = separator_from_jax(params, config, device)
    logger.info(f"separator: {sep.param_count(model) / 1e6:.2f}M params")
    dtype = compute_dtype_for(device)
    rng = np.random.default_rng(args.seed)
    T = args.sep_frames

    def gen(_i):
        batch = syn.separation_batch(rng, args.batch, T=T)
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
        return {"stem_sdr_db": sdr, "baseline_sdr_db": base, "corpus": "synthetic-stems",
                "train_frames": T, "model": "SeparatorConfig()"}

    return AuxTask("separator", model, gen, lambda m, batch: sep.loss_fn(m, batch, dtype),
                   evaluate, separator_to_jax)


TASKS = {"beat": beat_task, "amt": amt_task, "separator": separator_task}


def run_mode(name: str, args, device: torch.device, output_dir: Path) -> AuxRun:
    """Train one mode, evaluate it, export it under `output_dir`."""
    logger.stage(f"Training {name} (synthetic corpus)")
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
        description="Train the auxiliary models on synthetic corpora (PyTorch port)")
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
                        help="warm start from a params-only export of the port")
    parser.add_argument("--scenes-dir", type=str, default=None,
                        help="beat: pre-rendered corpus-piano scenes (not ported)")
    parser.add_argument("--pseudopop-cache", type=str, default=None,
                        help="separator: pre-rendered pseudo-pop examples (not ported)")
    parser.add_argument("--pseudopop-mix", type=float, default=0.0,
                        help="separator: the share of pseudo-pop rows (not ported)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--output-dir", type=str, default=None,
                        help=f"where the exports go (default {DEFAULT_OUTPUT_DIR})")
    return parser.parse_args(argv)


def run(argv=None) -> List[AuxRun]:
    """The CLI's work: one `AuxRun` per mode trained."""
    args = parse_args(argv)
    if args.model.endswith("-corpus"):
        raise NotImplementedError(f"mode {args.model} {NOT_PORTED}")
    if args.scenes_dir:
        raise NotImplementedError(f"--scenes-dir {NOT_PORTED}")
    if args.pseudopop_cache or args.pseudopop_mix > 0:
        raise NotImplementedError(f"--pseudopop-cache/--pseudopop-mix {NOT_PORTED}")
    output_dir = Path(args.output_dir or DEFAULT_OUTPUT_DIR).resolve()
    if output_dir.is_relative_to((REPO / "checkpoints").resolve()):
        raise ValueError(f"{output_dir} is under checkpoints/, which holds the JAX "
                         "package's checkpoints; pick another --output-dir")
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
