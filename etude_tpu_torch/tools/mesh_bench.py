"""The decoder's training step over N cards: step time, tokens/s, the
collectives' share of device time and peak memory per card.

    python -m etude_tpu_torch.tools.mesh_bench --ranks 4 [--fsdp] [--steps 10]

Starts one rank per card (NCCL, rendezvous through a file store), builds
the decoder at the published widths (`configs/distill.yaml`'s vocabulary,
random weights from seed 0) and runs the mesh step (parallel/train_step.py)
on `dataset_distill/tokenized` batches of configs/distill.yaml's shape:
8 rows x 4 micro-batches x 1,024 positions per optimizer step, each rank
holding 8 / N rows of each micro-batch. After 2 warm-up steps, `--steps`
steps are timed between CUDA events on rank 0 (median and range), then 3
more run under torch.profiler on every rank: device time by kernel, of
which NCCL's kernels are the collectives. Peak device memory is read on
every rank after the warm-up began. Rank 0 prints one JSON object.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import time
from pathlib import Path

import torch
import torch.distributed as dist

from ..data.dataset import EtudeDataset
from ..data.vocab import Vocab
from ..models.decoder import EtudeDecoderConfig
from ..parallel.mesh import initialize_multihost, make_mesh, shard_batch, spawn_ranks
from ..parallel.train_step import (
    init_sharded_state, make_optimizer, make_train_step, reshape_for_accum,
)
from ..weights import decoder_from_jax, init_decoder_params_np

ROOT = Path(__file__).resolve().parents[2]
ROWS, ACCUM, T = 8, 4, 1024
WARMUP, PROFILED = 2, 3


def _rank(rank: int, world: int, address: str, out: str, fsdp: bool, steps: int) -> None:
    initialize_multihost(address, world, rank, device="cuda")
    try:
        mesh = make_mesh(data_parallel=world)
        vocab = Vocab.load(ROOT / "dataset_distill/vocab.json")
        config = EtudeDecoderConfig(vocab_size=len(vocab))
        model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, mesh.device)
        tx, _ = make_optimizer(total_steps=1000)
        state = init_sharded_state(model, tx, mesh, fsdp=fsdp)
        step = make_train_step(config, tx, mesh=mesh)
        dataset = EtudeDataset(ROOT / "dataset_distill/tokenized", vocab, max_seq_len=T)
        hosts = itertools.islice(dataset.batches(ROWS * ACCUM, shuffle=True, seed=1234),
                                 WARMUP + steps + PROFILED)
        batches = [{k: torch.from_numpy(v).to(mesh.device)
                    for k, v in shard_batch(reshape_for_accum(h, ACCUM), mesh).items()}
                   for h in hosts]
        torch.cuda.reset_peak_memory_stats()
        events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
        losses = []
        for i, batch in enumerate(batches[:WARMUP + steps]):
            if i >= WARMUP:
                events[i - WARMUP].record()
            losses.append(step(state, batch)["loss"])
        events[-1].record()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        peak = torch.cuda.max_memory_allocated()

        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for batch in batches[WARMUP + steps:]:
                step(state, batch)
            torch.cuda.synchronize()
        device_us = nccl_us = 0.0
        for e in prof.key_averages():
            t = e.self_device_time_total
            device_us += t
            if "nccl" in e.key.lower():
                nccl_us += t
        local = {"peak_gib": peak / 2**30, "device_ms_per_step": device_us / 1e3 / PROFILED,
                 "nccl_ms_per_step": nccl_us / 1e3 / PROFILED}
        every = [None] * world
        dist.all_gather_object(every, local)
        if rank == 0:
            median = statistics.median(ms)
            Path(out).write_text(json.dumps({
                "ranks": world, "fsdp": fsdp, "device": torch.cuda.get_device_name(mesh.device),
                "rows_x_accum_x_T": [ROWS, ACCUM, T], "steps": steps,
                "step_ms_median": median, "step_ms_min": min(ms), "step_ms_max": max(ms),
                "tokens_per_s": ROWS * ACCUM * T / (median / 1e3),
                "losses": [float(x) for x in losses],
                "collective_share": [r["nccl_ms_per_step"] / r["device_ms_per_step"]
                                     if r["device_ms_per_step"] else None for r in every],
                "per_rank": every}))
    finally:
        dist.destroy_process_group()


def run(ranks: int, fsdp: bool = False, steps: int = 10) -> dict:
    """The measurement over `ranks` cards (raises with fewer); rank 0's
    record."""
    if torch.cuda.device_count() < ranks:
        raise RuntimeError(f"{ranks} ranks need {ranks} cards, "
                           f"{torch.cuda.device_count()} visible")
    t = time.perf_counter()
    record = spawn_ranks(_rank, ranks, fsdp, steps)
    record["wall_s"] = time.perf_counter() - t
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=torch.cuda.device_count())
    parser.add_argument("--fsdp", action="store_true")
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.ranks, args.fsdp, args.steps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
