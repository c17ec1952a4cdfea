"""Train the EtudeDecoder on one GPU or several (JAX counterpart: the root
train.py).

    python -m etude_tpu_torch.train --config distill.json [--device cpu]
    python -m torch.distributed.run --nproc-per-node 4 -m etude_tpu_torch.train ...

The same flags, settings and arithmetic as the JAX package's CLI
(steps_per_epoch, warmup and total steps; `init_from` warm start; one
`metrics.jsonl` line per epoch with the same keys; `--save-every-steps`
checkpoints inside an epoch, and a resume restarts the interrupted epoch
with the step count and schedule carried over): fixed-shape batches from
`data/dataset.py`, built and copied to the card ahead of use
(`parallel/prefetch.py`), one accumulating AdamW step
(`parallel/train_step.py`) whose losses stay on the card until the epoch
ends, checkpoints in the port's own format (`utils/training.py`). The run
ends with a params-only export, `model/`, beside `vocab.json` and the config:
what `python -m etude_tpu_torch.infer` loads through `paths.decoder_model`.

Several cards: the `mesh` settings size the data axis as the JAX CLI does
(`data_parallel_size`). When that asks for more than one rank and the
process is in no group, the CLI starts one process per rank itself (rank r
on card r; gloo processes with --device cpu) and waits for them; under
`torch.distributed.run` each process joins the group that exists, which
also spans hosts. Each rank keeps its rows of every batch; `mesh.fsdp`
shards the parameters and Adam moments. Rank 0 alone logs, writes
`metrics.jsonl` and checkpoints, and exports. Fewer cards than ranks raises.
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
import torch.distributed as dist

from .config import load_config
from .data.dataset import EtudeDataset
from .data.vocab import Vocab
from .models.decoder import EtudeDecoderConfig, param_count
from .parallel.mesh import initialize_multihost, make_mesh, spawn_ranks
from .parallel.prefetch import prefetch_to_device, prefetch_to_mesh
from .parallel.train_step import (
    full_params, init_sharded_state, init_train_state, make_optimizer, make_train_step,
)
from .utils.device import resolve_device
from .utils.logger import logger
from .utils.training import (
    is_writer, load_checkpoint, load_params_only, save_checkpoint, save_params_only,
    set_seed,
)
from .weights import decoder_from_jax, decoder_state_to_jax, init_decoder_params_np


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


def data_parallel_size(data_parallel: int, model_parallel: int, n_devices: int,
                       batch_size: int) -> int:
    """The data axis's size by the JAX CLI's rule (train.py:146-152): as set,
    or for -1 the devices that model_parallel leaves, at most the
    micro-batch, lowered until it divides the micro-batch."""
    if data_parallel != -1:
        return data_parallel
    dp = min(n_devices // max(model_parallel, 1), batch_size)
    while dp > 1 and batch_size % dp:
        dp -= 1
    return max(dp, 1)


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
    device = resolve_device(args.device)
    initialize_multihost(device=device)   # joins torch.distributed.run's group
    grouped = dist.is_initialized()
    n_devices = (dist.get_world_size() if grouped
                 else torch.cuda.device_count() if device.type == "cuda" else 1)
    model_parallel = max(cfg.mesh.model_parallel, 1)
    dp = data_parallel_size(cfg.mesh.data_parallel, model_parallel, n_devices,
                            tc.batch_size)
    if not grouped and dp * model_parallel > 1:
        return _spawn_ranks(argv, dp * model_parallel, device)
    mesh = None
    if grouped or cfg.mesh.fsdp:
        mesh = make_mesh(dp, model_parallel, devices=None if grouped else [device])
        device = mesh.device
    if grouped:
        ids = [run_id]
        dist.broadcast_object_list(ids, src=0)   # one run dir for every rank
        run_id = ids[0]
        if not is_writer():
            logger.level = max(logger.level, 30)   # rank 0 alone logs

    set_seed(cfg.env.seed)
    logger.stage("Setup")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name})")
    if mesh is not None:
        logger.info(f"mesh: {mesh.data_parallel} data x {mesh.model_parallel} model "
                    f"rank(s){', FSDP' if cfg.mesh.fsdp else ''}")

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
    if mesh is None:
        state = init_train_state(model, tx)
    else:
        state = init_sharded_state(model, tx, mesh, fsdp=cfg.mesh.fsdp)
    train_step = make_train_step(model_config, tx, compute_dtype=compute_dtype, mesh=mesh)

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
        host_batches = dataset.batches(batch_size=global_batch, shuffle=True,
                                       seed=cfg.env.seed + epoch)
        if mesh is None:
            batches = prefetch_to_device(host_batches, device, accum)
        else:
            batches = prefetch_to_mesh(host_batches, mesh, accum)
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
        if is_writer():
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
    params = full_params(state)
    if is_writer():
        save_params_only(ckpt_dir / "model", decoder_state_to_jax(params, model_config),
                         model_config)
        vocab.save(ckpt_dir / "vocab.json")
    logger.success(f"training complete → {ckpt_dir}")
    logger.info(f"inference weights: {ckpt_dir / 'model'} "
                "(point paths.decoder_model here)")
    counts = dataset.history_counts
    return TrainRun(ckpt_dir=ckpt_dir, load_seconds=load_seconds, losses=all_losses,
                    step_seconds=step_seconds, label_tokens=int(label_tokens),
                    chunks=counts["chunks"], rollout_chunks=counts["rollout"])


def _rank_main(rank: int, world: int, address: str, out: str, device: str,
               argv: List[str]) -> None:
    """One rank of `_spawn_ranks`: join the group, run the CLI, and on rank 0
    write the TrainRun to `out` as JSON."""
    if device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    initialize_multihost(address, world, rank, device=device)
    try:
        result = run(argv)
        if rank == 0 and result is not None:
            Path(out).write_text(json.dumps(
                {**dataclasses.asdict(result), "ckpt_dir": str(result.ckpt_dir)}))
    finally:
        dist.destroy_process_group()


def _spawn_ranks(argv, world: int, device: torch.device) -> Optional[TrainRun]:
    """Run the CLI in `world` processes, rank r on card r (gloo processes on
    the CPU), and return rank 0's TrainRun. A rank that fails ends the
    others and raises here."""
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"the mesh settings ask for {world} ranks, one per card, but "
                           f"{torch.cuda.device_count()} card(s) are visible")
    argv = list(sys.argv[1:] if argv is None else argv)
    logger.info(f"starting {world} ranks ({'NCCL' if device.type == 'cuda' else 'gloo'})")
    fields = spawn_ranks(_rank_main, world, device.type, argv)
    if fields is None:
        return None
    return TrainRun(**{**fields, "ckpt_dir": Path(fields["ckpt_dir"])})


def main(argv=None) -> int:
    return 0 if run(argv) is not None else 1


if __name__ == "__main__":
    sys.exit(main())
