"""One-card entry point (JAX counterpart: the root `__graft_entry__.py`):
`entry()` returns `(fn, example_args)` for a forward of the flagship model,
the EtudeDecoder at its default configuration (vocab 3000, 512 wide, 8
layers), with weights from seed 0 through the weight bridge.

    from etude_tpu_torch.entry import entry
    fn, args = entry()            # on the card, bf16
    logits = fn(*args)            # f32 [2, 64, 3000]

`dryrun_multichip(n)` runs the JAX module's multi-device checks (:125-254)
over n cards (n gloo processes with device="cpu"): a data-parallel step, an
FSDP step, an FSDP checkpoint's bitwise resume, and the sweep spread over n
devices against one.

    from etude_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4)           # needs 4 cards; raises with fewer
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from .parallel.mesh import spawn_ranks
from .utils.device import compute_dtype_for, resolve_device
from .weights import decoder_from_jax, init_decoder_params_np

# The JAX dryrun's widths (__graft_entry__.py:145-153).
DRYRUN_CONFIG = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=64, attribute_emb_dim=16)


def example_batch(config: EtudeDecoderConfig, B: int = 2, T: int = 64,
                  seed: int = 0) -> Dict[str, np.ndarray]:
    """A [B, T] training batch of random tokens, drawn as the JAX module's
    `_example_batch` draws it (:15)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, config.vocab_size, (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    labels[:, -1] = -100
    batch = {
        "input_ids": ids,
        "class_ids": rng.integers(1, 3, (B, T)).astype(np.int32),
        "labels": labels,
        "attention_mask": np.ones((B, T), np.int32),
    }
    for name in ATTRIBUTE_ORDER:
        batch[f"{name}_bin_ids"] = rng.integers(0, 3, (B, T)).astype(np.int32)
    return batch


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """(fn, example_args): `fn(model, input_ids, class_ids, attention_mask,
    *attribute_bins)` → f32 logits, computed in bf16 on the card (f32 on the
    CPU), the arguments as the JAX `entry()` orders them (:33-62), with the
    model in place of the parameter tree."""
    device = resolve_device(device)
    dtype = compute_dtype_for(device)
    config = EtudeDecoderConfig()
    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, device)
    batch = example_batch(config)

    @torch.no_grad()
    def fn(model, input_ids, class_ids, attention_mask, *attr_arrays):
        attr_ids = dict(zip(ATTRIBUTE_ORDER, attr_arrays))
        return model(input_ids, class_ids, attr_ids, attention_mask, compute_dtype=dtype)

    def t(a):
        return torch.from_numpy(a).long().to(device)

    example_args = (model, t(batch["input_ids"]), t(batch["class_ids"]),
                    t(batch["attention_mask"]),
                    *(t(batch[f"{name}_bin_ids"]) for name in ATTRIBUTE_ORDER))
    return fn, example_args


def _dryrun_rank(rank: int, n: int, address: str, out: str, device: str) -> None:
    """Checks 1-3 of `dryrun_multichip` on one rank of n; rank 0 writes the
    losses to `out` as JSON."""
    from .parallel.mesh import initialize_multihost, make_mesh, shard_batch
    from .parallel.train_step import (
        init_sharded_state, make_optimizer, make_train_step, reshape_for_accum,
    )
    from .utils.training import load_checkpoint, save_checkpoint

    if device == "cpu":   # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    initialize_multihost(address, n, rank, device=device)
    try:
        mesh = make_mesh(data_parallel=n)
        config = EtudeDecoderConfig(**DRYRUN_CONFIG)
        tx, _ = make_optimizer(total_steps=10)
        accum = 2
        host = reshape_for_accum(example_batch(config, B=2 * n * accum, T=32), accum)
        batch = {k: torch.from_numpy(v).to(mesh.device)
                 for k, v in shard_batch(host, mesh).items()}
        step = make_train_step(config, tx, compute_dtype=torch.float32, mesh=mesh)

        def state(fsdp, seed=0):
            model = decoder_from_jax(init_decoder_params_np(config, seed=seed), config,
                                     mesh.device)
            return init_sharded_state(model, tx, mesh, fsdp=fsdp)

        # 1. Data parallelism: replicated parameters, rows over the ranks.
        dp = state(False)
        loss_dp = float(step(dp, batch)["loss"])
        if not math.isfinite(loss_dp) or int(dp.step) != 1:
            raise RuntimeError(f"data-parallel step: loss {loss_dp}, step {int(dp.step)}")

        # 2. FSDP: each rank holds its shard of the parameters and moments.
        fsdp = state(True)
        total = sum(p.numel() for p in fsdp.params())
        if n > 1 and not fsdp.shard.numel() < total:
            raise RuntimeError("FSDP produced no sharded parameters")
        loss_fsdp = float(step(fsdp, batch)["loss"])
        if not abs(loss_fsdp - loss_dp) < 1e-3:
            raise RuntimeError(f"FSDP loss {loss_fsdp} vs data-parallel {loss_dp}")

        # 3. The FSDP checkpoint restored onto the sharded layout of a state
        # from other weights; a step from each must give the same loss bits.
        ckpt = Path(out).parent / "ckpt"
        save_checkpoint(ckpt, fsdp, epoch=0, global_step=int(fsdp.step), model_config=config)
        restored, _ = load_checkpoint(ckpt, state(True, seed=1))
        same = [torch.equal(a, b) for a, b in (
            (fsdp.shard, restored.shard), (fsdp.opt_state.mu[0], restored.opt_state.mu[0]),
            (fsdp.opt_state.nu[0], restored.opt_state.nu[0]))]
        if not all(same) or int(restored.step) != int(fsdp.step):
            raise RuntimeError(f"restored shards equal: {same}, step {int(restored.step)}")
        loss_direct = float(step(fsdp, batch)["loss"])
        loss_resumed = float(step(restored, batch)["loss"])
        if loss_direct != loss_resumed:
            raise RuntimeError(f"resumed loss {loss_resumed!r} vs direct {loss_direct!r}")
        if rank == 0:
            Path(out).write_text(json.dumps({
                "loss_dp": loss_dp, "loss_fsdp": loss_fsdp, "loss_resumed": loss_resumed,
                "shard": fsdp.shard.numel(), "params": total}))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n: int, device="cuda") -> Dict[str, float]:
    """The JAX dryrun's four checks (__graft_entry__.py:125-254) over n
    devices at its tiny widths, f32: in n ranks (one per card over NCCL, or
    n gloo processes with device="cpu"), (1) a data-parallel step with a
    finite loss and step 1, (2) an FSDP step with sharded parameters within
    1e-3 of its loss, (3) an FSDP checkpoint restored onto a fresh sharded
    state and a step from it equal to the direct state's in every bit; then
    (4) in this process, the streaming sweep of n streams spread over the n
    devices, equal token for token to the run on one device (at one
    attention head of 64: the card's decode kernel takes only that width).
    Unlike JAX, which makes virtual devices when there are too few, it
    raises with fewer than n cards. Returns the losses."""
    from .models.generate import ATTR_KEYS
    from .models.generate_stream import StreamingGenerationEngine

    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"dryrun_multichip({n}) needs {n} cards, "
                           f"{torch.cuda.device_count()} visible")
    result = spawn_ranks(_dryrun_rank, n, device.type)

    config = EtudeDecoderConfig(**{**DRYRUN_CONFIG, "num_attention_heads": 1})
    devices = ([torch.device("cuda", i) for i in range(n)] if device.type == "cuda"
               else [device] * n)
    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config, devices[0])
    engine = StreamingGenerationEngine(config, bar_bos_id=4, bar_eos_id=5, pad_id=0,
                                       max_bar_token_limit=16, x_len_buckets=(16,),
                                       bars_bucket=4)
    rng = np.random.default_rng(0)
    bars = [[4] + rng.integers(6, 128, 3).tolist() + [5] for _ in range(3)]
    attrs = [[{k: (s + j) % 3 for k in ATTR_KEYS} for j in range(3)] for s in range(n)]
    ref = engine.generate_batch(model, [bars] * n, attrs, temperature=0.0, seed=0)
    spread = engine.generate_batch(model, [bars] * n, attrs, temperature=0.0, seed=0,
                                   devices=devices)
    if spread != ref:
        raise RuntimeError("the sweep spread over devices diverged from one device's")
    print(f"dryrun_multichip({n}) on {device.type}: ok, dp loss={result['loss_dp']:.4f}, "
          f"fsdp loss={result['loss_fsdp']:.4f} ({result['shard']} of {result['params']} "
          f"parameter elements per rank), spread-sweep tokens match, FSDP checkpoint "
          f"resume bitwise (loss {result['loss_resumed']:.6f})")
    return result
