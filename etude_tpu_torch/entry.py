"""One-card entry point (JAX counterpart: the root `__graft_entry__.py`):
`entry()` returns `(fn, example_args)` for a forward of the flagship model,
the EtudeDecoder at its default configuration (vocab 3000, 512 wide, 8
layers), with weights from seed 0 through the weight bridge.

    from etude_tpu_torch.entry import entry
    fn, args = entry()            # on the card, bf16
    logits = fn(*args)            # f32 [2, 64, 3000]

The JAX module's `dryrun_multichip(n)` (one data-parallel training step
over an n-device mesh) has no counterpart yet: multi-GPU training is
ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from .models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from .utils.device import compute_dtype_for, resolve_device
from .weights import decoder_from_jax, init_decoder_params_np


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
