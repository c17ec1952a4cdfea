"""Train the EtudeDecoder on one GPU (JAX counterpart: the root train.py).

    python -m etude_tpu_torch.train --config distill.json [--device cpu]

The same flags, settings and arithmetic as the JAX package's CLI
(steps_per_epoch, warmup and total steps; `init_from` warm start; one
`metrics.jsonl` line per epoch with the same keys; `--save-every-steps`
checkpoints inside an epoch, and a resume restarts the interrupted epoch
with the step count and schedule carried over), on one device: fixed-shape
batches from `data/dataset.py`, built and copied to the card ahead of use
(`parallel/prefetch.py`), one accumulating AdamW step
(`parallel/train_step.py`) whose losses stay on the card until the epoch
ends, checkpoints in the port's own format (`utils/training.py`). The run
ends with a params-only export, `model/`, beside `vocab.json` and the config:
what `python -m etude_tpu_torch.infer` loads through `paths.decoder_model`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .config import load_config
from .data.dataset import EtudeDataset
from .data.vocab import Vocab
from .models.decoder import EtudeDecoderConfig, param_count
from .parallel.prefetch import prefetch_to_device
from .parallel.train_step import init_train_state, make_optimizer, make_train_step
from .utils.device import resolve_device
from .utils.logger import logger
from .utils.training import (
    load_checkpoint, load_params_only, save_checkpoint, save_params_only, set_seed,
)
from .weights import decoder_from_jax, decoder_to_jax, init_decoder_params_np


def build_model_config(cfg, vocab_size: int) -> EtudeDecoderConfig:
    d = cfg.decoder
    return EtudeDecoderConfig(
        vocab_size=vocab_size,
        hidden_size=d.hidden_size,
        num_hidden_layers=d.num_hidden_layers,
        num_attention_heads=d.num_attention_heads,
        intermediate_size=d.intermediate_size,
        max_position_embeddings=d.max_position_embeddings,
        num_classes=d.num_classes,
        pad_class_id=d.pad_class_id,
        attribute_pad_id=d.attribute_pad_id,
        context_num_past_xy_pairs=d.context_num_past_xy_pairs,
        num_attribute_bins=d.num_attribute_bins,
        attribute_emb_dim=d.attribute_emb_dim,
    )


def check_single_device(mesh) -> None:
    """The port trains on one device: a mesh the JAX package would spread
    over several raises rather than being ignored."""
    if mesh.fsdp or mesh.data_parallel > 1 or mesh.model_parallel > 1:
        raise NotImplementedError(
            f"mesh settings {mesh} ask for multi-device training (data "
            "parallelism or FSDP), which etude_tpu_torch has not ported yet "
            "(ROADMAP.md, Queue 1 item 5: multi-GPU training); the port "
            "trains on one device (data_parallel -1 or 1, fsdp false)")


@contextlib.contextmanager
def _sync_debug(mode: Optional[str]):
    """`torch.cuda.set_sync_debug_mode(mode)` inside, restored after."""
    if mode is None:
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@dataclasses.dataclass
class TrainRun:
    """What a run did: its output dir, the dataset's load time, per
    optimizer step its loss and its time (on the card, between the CUDA
    events recorded after each step, so the first step's time includes the
    wait for its batch; on the CPU, host time), the label tokens it trained
    on, and the chunks its batches drew and how many of them had a model
    rollout's bars as history (`train.dagger_history`)."""

    ckpt_dir: Path
    load_seconds: float
    losses: List[float]
    step_seconds: List[float]
    label_tokens: int
    chunks: int
    rollout_chunks: int


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Train the EtudeDecoder (PyTorch port)")
    parser.add_argument("--config", type=str, default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--run-id", type=str, default=None)
    parser.add_argument("--resume", type=str, default=None,
                        help="checkpoint dir to resume from")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None,
                        help="hard step cap (smoke runs)")
    parser.add_argument("--save-every-steps", type=int, default=None,
                        help="also checkpoint `latest` every N optimizer "
                             "steps (resume restarts the interrupted epoch "
                             "but the step count and the LR schedule carry "
                             "over; pair with --max-steps to stop at the "
                             "planned total)")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--strict-sync", action="store_true",
                        help="raise if a step other than the run's first "
                             "synchronizes the host with the card "
                             "(torch.cuda.set_sync_debug_mode('error'))")
    return parser.parse_args(argv)


def run(argv=None) -> Optional[TrainRun]:
    """The CLI's work; returns None where the JAX CLI exits 1."""
    args = parse_args(argv)
    cfg = load_config(args.config)
    tc = cfg.train
    if args.epochs is not None:
        tc.num_epochs = args.epochs
    if args.batch_size is not None:
        tc.batch_size = args.batch_size
    if args.resume is not None:
        tc.resume_from_checkpoint = args.resume
    run_id = args.run_id or tc.run_id or time.strftime("%Y%m%d_%H%M%S")
    check_single_device(cfg.mesh)
    device = resolve_device(args.device)

    set_seed(cfg.env.seed)
    logger.stage("Setup")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name})")

    vocab = Vocab.load(cfg.paths.dataset_vocab)
    logger.info(f"vocab: {len(vocab)} tokens")
    t_load = time.perf_counter()
    dataset = EtudeDataset(
        cfg.paths.tokenized_dir,
        vocab,
        max_seq_len=tc.max_seq_len,
        hist_suffix="_hist.npy" if tc.dagger_history else None,
        data_format=tc.data_format,
        num_attribute_bins=cfg.decoder.num_attribute_bins,
        context_num_past_xy_pairs=cfg.decoder.context_num_past_xy_pairs,
        attr_dropout=tc.attr_dropout,
        dagger_history_prob=tc.dagger_history_prob,
    )
    load_seconds = time.perf_counter() - t_load
    if tc.attr_dropout > 0:
        logger.info(f"attribute dropout: {tc.attr_dropout:.2f} "
                    "(neutral-bin conditioning for default serving)")
    if tc.dagger_history:
        n_hist = sum(dataset.has_rollouts)
        logger.info(f"DAgger history: {n_hist}/{len(dataset.songs)} songs have "
                    f"model rollouts, p(use rollout)={tc.dagger_history_prob:.2f}")
    if len(dataset) == 0:
        logger.error("dataset is empty — run prepare.py first")
        return None
    logger.info(f"dataset: {len(dataset.songs)} songs, {len(dataset)} chunks "
                f"({load_seconds:.1f} s)")

    model_config = build_model_config(cfg, len(vocab))
    params = init_decoder_params_np(model_config, seed=cfg.env.seed)
    if tc.init_from:
        params = load_params_only(Path(tc.init_from))
        logger.success(f"warm-started params from {tc.init_from} "
                       "(fresh optimizer/schedule)")
    model = decoder_from_jax(params, model_config, device)
    logger.info(f"model: {param_count(model) / 1e6:.2f}M params")

    accum = tc.gradient_accumulation_steps
    global_batch = tc.batch_size * accum
    steps_per_epoch = max(len(dataset) // global_batch, 1)
    total_steps = steps_per_epoch * tc.num_epochs
    warmup_steps = int(steps_per_epoch * tc.warmup_epochs)
    tx, schedule = make_optimizer(
        learning_rate=tc.learning_rate,
        warmup_steps=warmup_steps,
        total_steps=total_steps,
        weight_decay=tc.weight_decay,
        beta1=tc.adam_beta1,
        beta2=tc.adam_beta2,
        clip_grad_norm=tc.clip_grad_norm,
    )
    compute_dtype = torch.bfloat16 if cfg.env.compute_dtype == "bfloat16" else torch.float32
    state = init_train_state(model, tx)
    train_step = make_train_step(model_config, tx, compute_dtype=compute_dtype)

    ckpt_dir = Path(cfg.paths.train_output_dir) / run_id
    start_epoch = 0
    if tc.resume_from_checkpoint:
        state, meta = load_checkpoint(tc.resume_from_checkpoint, state)
        start_epoch = meta.get("epoch", 0)
        logger.success(f"resumed from epoch {start_epoch}, step {int(state.step)}")

    logger.stage("Training")
    logger.info(
        f"{tc.num_epochs} epochs x {steps_per_epoch} steps, "
        f"global batch {global_batch} (micro {tc.batch_size} x accum {accum})"
    )
    on_card = device.type == "cuda"
    strict = "error" if args.strict_sync and on_card else None

    def mark():
        if not on_card:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def seconds(a, b) -> float:
        return a.elapsed_time(b) / 1e3 if on_card else b - a

    all_losses: List[float] = []
    step_seconds: List[float] = []
    label_tokens = torch.zeros((), dtype=torch.int64, device=device)
    done = False
    for epoch in range(start_epoch, tc.num_epochs):
        t_epoch = time.time()
        losses = []
        marks = [mark()]
        batches = prefetch_to_device(
            dataset.batches(batch_size=global_batch, shuffle=True,
                            seed=cfg.env.seed + epoch),
            device, accum,
        )
        # Losses stay on the device inside the loop; a per-step float()
        # would stall the launch queue on the host↔device round trip. Steps
        # are counted on the host (state.step grows by exactly 1 per step,
        # skipped updates included).
        host_step = int(state.step)
        try:
            for batch in batches:
                with _sync_debug(strict if step_seconds or len(marks) > 1 else None):
                    metrics = train_step(state, batch)
                    losses.append(metrics["loss"])
                    label_tokens += metrics["n_tokens"]
                    marks.append(mark())
                host_step += 1
                if args.save_every_steps and host_step % args.save_every_steps == 0:
                    # Mid-epoch safety checkpoint (syncs the device once).
                    save_checkpoint(ckpt_dir, state, epoch=epoch, global_step=host_step,
                                    model_config=model_config)
                    logger.info(f"  step {host_step}: checkpointed "
                                f"(loss {float(losses[-1]):.4f})")
                if args.max_steps and host_step >= args.max_steps:
                    done = True
                    break
        finally:
            batches.close()
        if not losses:
            logger.error(
                f"epoch produced no batches: dataset has {len(dataset)} chunks "
                f"but the global batch is {global_batch}; reduce batch_size or "
                "gradient_accumulation_steps"
            )
            return None
        losses = [float(x) for x in losses]  # one sync point per epoch
        dt = time.time() - t_epoch
        step_seconds += [seconds(a, b) for a, b in zip(marks, marks[1:])]
        all_losses += losses
        lr = float(schedule(int(state.step)))
        logger.info(
            f"epoch {epoch + 1}/{tc.num_epochs}: loss {np.mean(losses):.4f} "
            f"lr {lr:.2e} skipped {int(state.skipped)} ({dt:.1f}s, median step "
            f"{1e3 * statistics.median(step_seconds[-len(losses):]):.1f} ms)"
        )
        counts = dataset.history_counts
        logger.info(f"history: {counts['rollout']}/{counts['chunks']} chunks drawn so far "
                    "had model-rollout bars")
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        with open(ckpt_dir / "metrics.jsonl", "a", encoding="utf-8") as f:
            f.write(json.dumps({
                "epoch": epoch + 1,
                "step": int(state.step),
                "loss": float(np.mean(losses)),
                "lr": lr,
                "skipped_updates": int(state.skipped),
                "seconds": dt,
                "tokens_per_sec": (
                    len(losses) * global_batch * tc.max_seq_len / dt
                    if dt > 0 else 0.0
                ),
            }) + "\n")
        save_checkpoint(
            ckpt_dir, state, epoch=epoch + 1, global_step=int(state.step),
            model_config=model_config,
            is_save_epoch=((epoch + 1) % tc.save_every_n_epochs == 0),
        )
        if done:
            break

    # Export inference weights (params-only) + vocab + config: the layout
    # infer.py's model loader consumes (paths.decoder_model/_config/_vocab).
    save_params_only(ckpt_dir / "model", decoder_to_jax(state.model), model_config)
    vocab.save(ckpt_dir / "vocab.json")
    logger.success(f"training complete → {ckpt_dir}")
    logger.info(f"inference weights: {ckpt_dir / 'model'} "
                "(point paths.decoder_model here)")
    counts = dataset.history_counts
    return TrainRun(ckpt_dir=ckpt_dir, load_seconds=load_seconds, losses=all_losses,
                    step_seconds=step_seconds, label_tokens=int(label_tokens),
                    chunks=counts["chunks"], rollout_chunks=counts["rollout"])


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
