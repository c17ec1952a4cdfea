"""Bar-by-bar generation that rebuilds every bar's prompt, in PyTorch (JAX
counterpart: etude_tpu/models/generate.py): `--engine rebuild`.

Every bar prefills its whole prompt (the 4 most recent history pairs, the
current condition bar with the target attributes, a Bar_BOS opener) into a
fresh KV cache sized to the prompt's bucket plus the generation window, then
decodes single tokens until every stream has emitted its Bar_EOS. That is
the reference's exact semantics (`PARITY.md:160-163`): each history token is
recomputed under the bar's own window, where the streaming engine
(models/generate_stream.py) keeps the K/V a token was generated under.

Where JAX runs one jitted `while_loop` per bar, the port runs the step loop
on the host with the done flags on the device and one host read of "all
done" per step, as the streaming engine does. Each S = 1 step runs the
decode-attention kernel on every layer (`decoder.forward_with_cache`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
from ..ops.decode_attention import max_cache_len
from ..ops.sampling import sample_token
from ..utils.logger import logger
from .decoder import (ATTRIBUTE_ORDER, EtudeDecoder, EtudeDecoderConfig, forward_with_cache,
                      init_cache)

# Host-side attribute key spelling used by callers (reference CLI surface).
ATTR_KEYS = ("pitch_overlap_bin", "polyphony_bin", "rhythm_intensity_bin", "sustain_bin")
_ATTR_KEY_TO_NAME = {
    "pitch_overlap_bin": "pitch_overlap",
    "polyphony_bin": "polyphony",
    "sustain_bin": "sustain",
    "rhythm_intensity_bin": "rhythm_intensity",
}


def _round_up_to_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return max(buckets)


@torch.no_grad()
def generate_bar(
    model: EtudeDecoder,
    prompt_ids: torch.Tensor,            # [B, P] long, LEFT-padded
    class_ids: torch.Tensor,             # [B, P]
    attr_ids: Dict[str, torch.Tensor],   # each [B, P]
    visible_from: torch.Tensor,          # [B] first real slot per stream
    cur_attrs: Dict[str, torch.Tensor],  # each [B]: the target bar's attrs
    generator: Optional[torch.Generator],
    temperature: float,
    top_p: float,
    *,
    max_new_tokens: int,
    bar_eos_id: int,
    pad_id: int,
    layer_weights: Optional[List[Dict[str, torch.Tensor]]] = None,
    stats: Optional[Dict[str, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Up to max_new_tokens target tokens after the prompt, whose last token
    is the Bar_BOS of the target bar (JAX `generate_bar` :58).

    Returns (tokens [B, max_new_tokens] with pad after Bar_EOS, counts [B]).
    `stats["single_token_steps"]`, when given, counts the S = 1 forwards
    (each launches the decode-attention kernel once per layer on a card)."""
    config = model.config
    B, P = prompt_ids.shape
    device = prompt_ids.device
    # The bucket's window: P prompt slots and the generation budget.
    cache_len = min(P + max_new_tokens, config.max_position_embeddings)
    if cache_len > max_cache_len():
        raise ValueError(f"a cache of {cache_len} slots exceeds the decode-attention "
                         f"kernel's {max_cache_len()}")
    if layer_weights is None:
        layer_weights = [layer.cast(torch.bfloat16) for layer in model.layers]
    cache = init_cache(config, B, length=cache_len, device=device)
    positions = (torch.arange(P, device=device)[None] - visible_from[:, None]).clamp_min(0)
    logits, _ = forward_with_cache(model, cache, prompt_ids, class_ids, attr_ids,
                                   0, positions, visible_from, layer_weights)
    last = logits[:, -1]  # prompts are right-aligned at slot P - 1

    tgt_class = torch.full((B, 1), TGT_CLASS_ID, dtype=torch.long, device=device)
    step_attrs = {name: cur_attrs[name][:, None] for name in ATTRIBUTE_ORDER}
    tokens = torch.full((B, max_new_tokens), pad_id, dtype=torch.long, device=device)
    done = torch.zeros((B,), dtype=torch.bool, device=device)
    counts = torch.zeros((B,), dtype=torch.long, device=device)
    step = 0
    while step < max_new_tokens and not bool(done.all()):
        tok = sample_token(last, generator, temperature, top_p)
        tok = torch.where(done, pad_id, tok)
        tokens[:, step] = tok
        counts += (~done).long()
        done = done | (tok == bar_eos_id)
        write_pos = P + step
        logits, _ = forward_with_cache(model, cache, tok[:, None], tgt_class, step_attrs,
                                       write_pos, (write_pos - visible_from)[:, None],
                                       visible_from, layer_weights)
        last = logits[:, 0]
        step += 1
    if stats is not None:
        stats["single_token_steps"] = stats.get("single_token_steps", 0) + step
    return tokens, counts


class GenerationEngine:
    """Host orchestration of bar-by-bar song generation (JAX
    `GenerationEngine` :140).

    The reference prompt contract: the 4 most recent (X, Y) history pairs
    (empty [BOS, EOS] bars with neutral attributes where history is short),
    then the current condition bar X_i with the *target* attributes, then a
    Bar_BOS opener, truncated to the last max_pos * 0.5 tokens (the JAX
    engine's default overlap ratio) when the prompt would crowd the
    generation window.
    `stats["single_token_steps"]` accumulates the S = 1 steps of every call.
    """

    def __init__(
        self,
        config: EtudeDecoderConfig,
        bar_bos_id: int,
        bar_eos_id: int,
        pad_id: int = 0,
        prompt_buckets: Sequence[int] = (128, 256, 384, 512),
        max_bar_token_limit: int = 512,
    ):
        self.config = config
        self.bar_bos_id = bar_bos_id
        self.bar_eos_id = bar_eos_id
        self.pad_id = pad_id
        self.max_bar_token_limit = min(max_bar_token_limit, config.max_position_embeddings)
        # Leave a full generation window inside max_pos; past the cap keep
        # the last half of the positions, leaving room for the Bar_BOS
        # opener within the cap (and thus within the largest bucket).
        self.prompt_cap = max(config.max_position_embeddings - self.max_bar_token_limit, 1)
        keep = config.max_position_embeddings // 2 - 1
        self.prompt_keep = max(min(keep, self.prompt_cap - 1), 1)
        # Buckets below the cap, plus the cap itself so every legal prompt
        # fits some bucket.
        self.prompt_buckets = sorted(
            {b for b in prompt_buckets if b < self.prompt_cap} | {self.prompt_cap})
        self.stats = {"single_token_steps": 0}

    # ---- prompt assembly (host) ---------------------------------------
    def build_prompt(
        self,
        history: List[Tuple[List[int], List[int], Dict[str, int]]],
        current_x: List[int],
        current_attrs: Dict[str, int],
    ) -> Tuple[List[int], List[int], Dict[str, List[int]]]:
        """Token, class and attribute streams of one bar's prompt, Bar_BOS
        included (JAX :183)."""
        n_ctx = self.config.context_num_past_xy_pairs
        empty_bar = [self.bar_bos_id, self.bar_eos_id]
        tokens: List[int] = []
        classes: List[int] = []
        attrs: Dict[str, List[int]] = {k: [] for k in ATTR_KEYS}

        def extend(ids, class_id, bins):
            tokens.extend(ids)
            classes.extend([class_id] * len(ids))
            for k in ATTR_KEYS:
                attrs[k].extend([bins[k]] * len(ids))

        used = history[-n_ctx:]
        neutral = {k: 1 for k in ATTR_KEYS}
        for _ in range(n_ctx - len(used)):
            extend(empty_bar, SRC_CLASS_ID, neutral)
            extend(empty_bar, TGT_CLASS_ID, neutral)
        for x_ids, y_ids, h_attrs in used:
            extend(x_ids, SRC_CLASS_ID, h_attrs)
            extend(y_ids, TGT_CLASS_ID, h_attrs)
        extend(current_x, SRC_CLASS_ID, current_attrs)

        if len(tokens) > self.prompt_cap - 1:
            keep = self.prompt_keep
            tokens, classes = tokens[-keep:], classes[-keep:]
            attrs = {k: v[-keep:] for k, v in attrs.items()}

        extend([self.bar_bos_id], TGT_CLASS_ID, current_attrs)
        return tokens, classes, attrs

    def _pack_prompts(self, prompts):
        """Left-pad a list of (tokens, classes, attrs) to a common bucket
        (JAX :236): (ids, classes, attrs, visible_from, P) as numpy."""
        P = _round_up_to_bucket(max(len(p[0]) for p in prompts), self.prompt_buckets)
        B = len(prompts)
        ids = np.full((B, P), self.pad_id, np.int64)
        classes = np.zeros((B, P), np.int64)
        attrs = {k: np.zeros((B, P), np.int64) for k in ATTR_KEYS}
        visible_from = np.zeros((B,), np.int64)
        for b, (toks, cls, att) in enumerate(prompts):
            n = len(toks)
            ids[b, P - n:] = toks
            classes[b, P - n:] = cls
            for k in ATTR_KEYS:
                attrs[k][b, P - n:] = att[k]
            visible_from[b] = P - n
        return ids, classes, attrs, visible_from, P

    # ---- song generation ----------------------------------------------
    def generate(self, model: EtudeDecoder, all_x_bars: List[List[int]],
                 target_attributes_per_bar: List[Dict[str, int]], **kw) -> List[List[int]]:
        """The target bars of one song ([Bar_BOS, ..., Bar_EOS] each)."""
        return self.generate_batch(model, [all_x_bars], [target_attributes_per_bar], **kw)[0]

    @torch.no_grad()
    def generate_batch(
        self,
        model: EtudeDecoder,
        x_bars_per_stream: List[List[List[int]]],
        attrs_per_stream: List[List[Dict[str, int]]],
        *,
        temperature: float = 0.0,
        top_p: float = 0.9,
        max_output_tokens: int = 25600,
        seed: int = 0,
        progress: bool = False,
    ) -> List[List[List[int]]]:
        """N independent streams in lockstep, on the model's device (JAX
        :283). Streams may have different bar counts; an exhausted stream
        decodes an empty condition bar and its output is discarded."""
        B = len(x_bars_per_stream)
        if B == 0:
            return []
        device = next(model.parameters()).device
        num_bars = max(len(s) for s in x_bars_per_stream)
        histories: List[List[Tuple]] = [[] for _ in range(B)]
        outputs: List[List[List[int]]] = [[] for _ in range(B)]
        totals = np.zeros(B, np.int64)
        empty_bar = [self.bar_bos_id, self.bar_eos_id]
        neutral = {k: 1 for k in ATTR_KEYS}
        weights = [layer.cast(torch.bfloat16) for layer in model.layers]
        generator = torch.Generator(device=device).manual_seed(seed)
        if progress:
            logger.info(f"rebuild generation: {num_bars} bars, {B} stream(s) on {device}")

        def on_device(a):
            return torch.from_numpy(a).to(device)

        for bar_idx in range(num_bars):
            prompts = []
            cur = {name: np.zeros(B, np.int64) for name in ATTRIBUTE_ORDER}
            for b in range(B):
                stream = x_bars_per_stream[b]
                if bar_idx < len(stream):
                    x_ids, attrs = stream[bar_idx], attrs_per_stream[b][bar_idx]
                else:
                    x_ids, attrs = empty_bar, neutral
                prompts.append(self.build_prompt(histories[b], x_ids, attrs))
                for key in ATTR_KEYS:
                    cur[_ATTR_KEY_TO_NAME[key]][b] = attrs[key]

            ids, classes, attrs_np, visible_from, _ = self._pack_prompts(prompts)
            tokens, counts = generate_bar(
                model, on_device(ids), on_device(classes),
                {_ATTR_KEY_TO_NAME[k]: on_device(v) for k, v in attrs_np.items()},
                on_device(visible_from), {k: on_device(v) for k, v in cur.items()},
                generator, float(temperature), float(top_p),
                max_new_tokens=self.max_bar_token_limit, bar_eos_id=self.bar_eos_id,
                pad_id=self.pad_id, layer_weights=weights, stats=self.stats,
            )
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()

            for b in range(B):
                stream = x_bars_per_stream[b]
                if bar_idx >= len(stream) or totals[b] >= max_output_tokens:
                    continue
                generated = [self.bar_bos_id] + tokens[b, :counts[b]].tolist()
                totals[b] += counts[b]
                histories[b].append((stream[bar_idx], generated, attrs_per_stream[b][bar_idx]))
                if len(histories[b]) > self.config.context_num_past_xy_pairs:
                    histories[b].pop(0)
                outputs[b].append(generated)

            if all(totals[b] >= max_output_tokens for b in range(B)):
                logger.warn("max_output_tokens reached on all streams; stopping.")
                break
        return outputs
