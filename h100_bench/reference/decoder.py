"""Plain float32 reference of the Etude decoder under the stream engine's
bar rules, teacher-forced on served tokens.

The model (GPT-NeoX style, parallel attention and MLP residual, rotary on
the first quarter of each head, exact GELU, untied LM head) is read from
the exported parameters (`params.npz`, JAX layout: a linear's `w` is
[in, out]) and computed in float32 with TF32 off, with no cache kernel, no
batching across streams and no bf16.

The bar rules are worked out again here from the traffic and the served
tokens, not read from the program:
  * the stream starts with `n_ctx` empty (X, Y) pairs [Bar_BOS, Bar_EOS] x 2
    (classes source, source, target, target; every attribute bin 1);
  * bar i's condition tokens (class source) are followed by the Bar_BOS
    opener and the served tokens (class target), all at consecutive global
    positions of the stream, with the bar's attribute bins;
  * a query sees the keys at positions from its bar's window start up to
    its own position; the window starts at the first of the last `n_ctx`
    pairs, unless the prompt (window plus condition) passes `cap - 1`
    positions, when it starts `keep` positions before the opener; a
    position once left out of a window is gone for good;
  * each token's keys and values are computed once, when it is fed, under
    its own bar's window (the stream keeps them; they are not recomputed).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


ATTRIBUTES = ("pitch_overlap", "polyphony", "sustain", "rhythm_intensity")
ATTRIBUTE_KEYS = {"pitch_overlap": "pitch_overlap_bin", "polyphony": "polyphony_bin",
                  "sustain": "sustain_bin", "rhythm_intensity": "rhythm_intensity_bin"}
SOURCE, TARGET = 1, 2


def window_rules(config: dict) -> Dict[str, int]:
    """n_ctx, the prompt cap and the kept tail, from the configuration: the
    prompt fills what a bar's tokens leave of the position budget, and past
    it keeps the last half of the positions."""
    positions = config["max_position_embeddings"]
    bar_cap = min(config["max_bar_token_limit"], positions)
    cap = max(positions - bar_cap, 1)
    keep = max(min(positions // 2 - 1, cap - 1), 1)
    return {"n_ctx": config["context_num_past_xy_pairs"], "cap": cap, "keep": keep}


def visible_history(x_lens: Sequence[int], y_lens: Sequence[int],
                    rules: Dict[str, int]) -> List[int]:
    """For each bar of one stream, how many earlier positions its queries
    see (the history window after the rules above)."""
    n_ctx = rules["n_ctx"]
    total = 4 * n_ctx + sum(x + 1 + y for x, y in zip(x_lens, y_lens))
    alive = np.zeros(total, dtype=bool)
    alive[:4 * n_ctx] = True
    pair_starts = [4 * j for j in range(n_ctx + 1)]
    cur = 4 * n_ctx
    out = []
    for x_len, y_len in zip(x_lens, y_lens):
        x_end = cur + x_len
        start = pair_starts[0]
        if x_end - start > rules["cap"] - 1:
            start = x_end - rules["keep"]
        alive[:start] = False
        out.append(int(alive[:cur].sum()))
        nxt = x_end + 1 + y_len
        alive[cur:nxt] = True
        cur = nxt
        pair_starts = pair_starts[1:] + [cur]
    return out


class Decoder:
    """The decoder's forward in float32 (or through `cast`, a function
    applied to every matmul operand: the precision control)."""

    def __init__(self, params_path, config: dict, device,
                 cast: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        with np.load(params_path) as z:
            self.p = {k: torch.from_numpy(z[k].astype(np.float32)).to(device)
                      for k in z.files}
        self.config = config
        self.device = device
        self.cast = cast or (lambda t: t)
        self.heads = config["num_attention_heads"]
        self.head_dim = config["hidden_size"] // self.heads
        self.rot = int(self.head_dim * config["rotary_pct"])
        self.eps = config["layer_norm_eps"]
        inv = 1.0 / (config["rotary_base"]
                     ** (np.arange(0, self.rot, 2, dtype=np.float64) / self.rot))
        self.inv_freq = torch.from_numpy(inv).to(device)

    def _mm(self, x, w, b=None):
        y = self.cast(x) @ self.cast(w)
        return y if b is None else y + b

    def _ln(self, x, name, l=None):
        scale, bias = self.p[f"{name}/scale"], self.p[f"{name}/bias"]
        if l is not None:
            scale, bias = scale[l], bias[l]
        return F.layer_norm(x, (x.shape[-1],), scale, bias, self.eps)

    def embed(self, ids, classes, bins: Dict[str, int]):
        p = self.p
        attrs = torch.cat([p[f"attr_emb/{n}"][bins[n]].expand(len(ids), -1)
                           for n in ATTRIBUTES], dim=-1)
        return (p["word_emb"][ids] + p["class_emb"][classes]
                + self._mm(attrs, p["attr_proj/w"], p["attr_proj/b"]))

    def _rotary(self, x, positions):
        phase = positions.double()[:, None] * self.inv_freq[None]
        phase = torch.cat([phase, phase], dim=-1)
        cos, sin = torch.cos(phase).float()[:, None], torch.sin(phase).float()[:, None]
        x_rot, x_pass = x[..., :self.rot], x[..., self.rot:]
        half = self.rot // 2
        rotated = torch.cat([-x_rot[..., half:], x_rot[..., :half]], dim=-1)
        return torch.cat([x_rot * cos + rotated * sin, x_pass], dim=-1)

    def chunk(self, h, positions, history):
        """S tokens at `positions` against `history` (per layer (k, v) of the
        earlier visible positions, [P, H, D]); causal inside the chunk.
        Returns (logits [S, V], the chunk's (k, v) per layer)."""
        p, H, D = self.p, self.heads, self.head_dim
        S = h.shape[0]
        new = []
        causal = torch.ones(S, S, dtype=torch.bool, device=self.device).tril()
        for l in range(self.config["num_hidden_layers"]):
            a = self._ln(h, "layers/ln1", l)
            qkv = self._mm(a, p["layers/qkv/w"][l], p["layers/qkv/b"][l]).view(S, H, 3 * D)
            q, k, v = qkv.split(D, dim=-1)
            q, k = self._rotary(q, positions), self._rotary(k, positions)
            k_hist, v_hist = history[l]
            keys, values = torch.cat([k_hist, k]), torch.cat([v_hist, v])
            P = k_hist.shape[0]
            visible = torch.cat([torch.ones(S, P, dtype=torch.bool, device=self.device),
                                 causal], dim=1)
            scores = torch.einsum("shd,phd->hsp", self.cast(q), self.cast(keys)) / math.sqrt(D)
            probs = torch.softmax(scores.masked_fill(~visible, float("-inf")), dim=-1)
            ctx = torch.einsum("hsp,phd->shd", self.cast(probs), self.cast(values))
            attn = self._mm(ctx.reshape(S, H * D), p["layers/attn_out/w"][l],
                            p["layers/attn_out/b"][l])
            m = F.gelu(self._mm(self._ln(h, "layers/ln2", l), p["layers/mlp_in/w"][l],
                                p["layers/mlp_in/b"][l]), approximate="none")
            h = h + attn + self._mm(m, p["layers/mlp_out/w"][l], p["layers/mlp_out/b"][l])
            new.append((k, v))
        logits = self._mm(self._ln(h, "final_ln"), p["lm_head"])
        return logits, new

    @torch.no_grad()
    def stream_logits(self, x_bars: List[List[int]], bins: List[Dict[str, int]],
                      served: List[List[int]], ids: Dict[str, int],
                      rules: Dict[str, int]) -> List[torch.Tensor]:
        """Teacher-forced logits [len(served[i]), V] that predict each served
        token of each bar, in the stream's order."""
        dev, n_ctx = self.device, rules["n_ctx"]
        L = self.config["num_hidden_layers"]
        empty = torch.zeros(0, self.heads, self.head_dim, device=dev)
        history = [(empty, empty) for _ in range(L)]
        hist_pos = torch.zeros(0, dtype=torch.long, device=dev)

        def feed(tokens, classes, bins_, positions):
            nonlocal history, hist_pos
            t = lambda a: torch.tensor(a, dtype=torch.long, device=dev)  # noqa: E731
            h = self.embed(t(tokens), t(classes), bins_)
            logits, new = self.chunk(h, positions, history)
            history = [(torch.cat([k0, k1]), torch.cat([v0, v1]))
                       for (k0, v0), (k1, v1) in zip(history, new)]
            hist_pos = torch.cat([hist_pos, positions])
            return logits

        bos, eos = ids["bar_bos"], ids["bar_eos"]
        seed_len = 4 * n_ctx
        feed([bos, eos] * (2 * n_ctx), [SOURCE, SOURCE, TARGET, TARGET] * n_ctx,
             {n: 1 for n in ATTRIBUTES}, torch.arange(seed_len, device=dev))
        pair_starts = [4 * j for j in range(n_ctx + 1)]
        cur = seed_len
        out = []
        for x, bar_bins, y in zip(x_bars, bins, served):
            x = x[-rules["cap"]:]
            x_end = cur + len(x)
            start = pair_starts[0]
            if x_end - start > rules["cap"] - 1:
                start = x_end - rules["keep"]
            keep = hist_pos >= start
            history = [(k[keep], v[keep]) for k, v in history]
            hist_pos = hist_pos[keep]
            n = len(y)
            positions = torch.arange(cur, x_end + 1 + n, device=dev)
            logits = feed(list(x) + [bos] + list(y),
                          [SOURCE] * len(x) + [TARGET] * (1 + n),
                          {a: bar_bins[ATTRIBUTE_KEYS[a]] for a in ATTRIBUTES},
                          positions)
            out.append(logits[len(x):len(x) + n])
            cur = x_end + 1 + n
            pair_starts = pair_starts[1:] + [cur]
        return out


def served_gaps(logits: Sequence[torch.Tensor], served: Sequence[Sequence[int]]) -> np.ndarray:
    """For every served token, how far its logit lies below the best one."""
    gaps = []
    for lg, y in zip(logits, served):
        idx = torch.tensor(list(y), dtype=torch.long, device=lg.device)
        gaps.append((lg.max(dim=-1).values - lg.gather(1, idx[:, None])[:, 0]).cpu())
    return torch.cat(gaps).numpy() if gaps else np.zeros(0, np.float32)
