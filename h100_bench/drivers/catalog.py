"""Catalog renders: one client asks for every style of many songs at once.

Each request is one `StreamingGenerationEngine.generate_batch` of the port
over `songs_per_request` x (the style grid) streams. The catalog is a fixed
job: the traffic's own seed draws its requests' songs from the distilled
corpus (each song once) and for each song an 8-bar section from a bar it
draws; every stream of a song gets the section under one combination of
the style bins. The run's seed orders the catalog's requests and each
request's streams, and draws the streams the check samples, so every seed
does the same work (with seed-drawn songs the rate moved 12-13% from seed
to seed against 0.3-2.7% between two runs of one seed). Decoding is as the
traffic file says (greedy, as the CLI). A new request starts when the last
one has ended (a closed loop with one client).

Correctness: after the window, a sample of the finished streams drawn from
the seed, with the one that served the most tokens in it, is run through
the plain float32 reference (`reference/decoder.py`), teacher-forced on the
served tokens. The gap by which each served token's logit lies below the
reference's best is taken, and its 99.9th percentile over the sample must
stay under the traffic's limit (the widest gap alone is set by one near-tie
in some thousands of tokens and does not separate the int8 control from
sound runs); every stream must be well formed (every bar ends at Bar_EOS or
at the bar cap).
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict, List

import numpy as np

from h100_bench.frozen import corpus as corpus_mod
from h100_bench.frozen.counts import decoder_token_flops
from h100_bench.harness import Check, note, synchronize
from h100_bench.reference import decoder as ref_mod
from h100_bench.reference.precision import exact_float32


def seed_sequence(seed: int, *words: int) -> np.random.SeedSequence:
    """A generator seed from any whole number (negative ones too) and the
    words that name what it draws."""
    return np.random.SeedSequence([abs(seed), int(seed < 0), *words])


def x_bucket(max_len: int, buckets: List[int], cap: int) -> int:
    """The condition bucket the engine pads a request's bars to (its rule:
    the smallest bucket that holds the longest bar, else a multiple of 64;
    bars past the prompt cap keep their tail)."""
    max_len = min(max_len, cap)
    return next((b for b in sorted(buckets) if max_len <= b), -(-max_len // 64) * 64)


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.config
        self.traffic = ctx.traffic
        self.rules = ref_mod.window_rules(self.cfg)
        self.model = self.engine = None

    # ---- inputs ---------------------------------------------------------
    def styles(self) -> List[Dict[str, int]]:
        grid = self.traffic["styles"]
        keys = sorted(grid)
        return [dict(zip(keys, values))
                for values in itertools.product(*(grid[k] for k in keys))]

    def make_request(self, index: int):
        """(condition bars per stream, style bins per stream per bar, songs)
        of the run's request `index`: one of the catalog's requests, in the
        run's order, its streams in an order of the run's own."""
        k = self.traffic["bars_per_section"]
        sections = self.catalog[self.request_order[index % len(self.catalog)]]
        pairs = [(section, style) for _, section in sections for style in self.styles()]
        rng = np.random.default_rng(seed_sequence(self.ctx.seed, 1, index))
        order = rng.permutation(len(pairs))
        return ([pairs[i][0] for i in order], [[pairs[i][1]] * k for i in order],
                [sid for sid, _ in sections])

    # ---- the driver's interface -------------------------------------------
    def prepare_traffic(self) -> None:
        """Read the corpus; draw the catalog (by the traffic's own seed, so
        every run serves the same songs and sections) and the run's order
        of its requests (by the run's seed)."""
        root, cfg, t = self.ctx.root, self.cfg, self.traffic
        self.ids = corpus_mod.vocab_ids(root / cfg["vocab"])
        self.corpus = corpus_mod.load_corpus(root / t["corpus"],
                                             self.ids["bar_bos"], self.ids["bar_eos"])
        k, n = t["bars_per_section"], t["songs_per_request"]
        eligible = sorted(sid for sid, bars in self.corpus.items() if len(bars) >= k)
        pool = np.random.default_rng(seed_sequence(t["catalog"]["seed"]))
        songs = [eligible[i] for i in pool.permutation(len(eligible))]
        self.catalog = []
        for r in range(t["catalog"]["requests"]):
            sections = []
            for sid in songs[r * n:(r + 1) * n]:
                start = int(pool.integers(0, len(self.corpus[sid]) - k + 1))
                sections.append((sid, self.corpus[sid][start:start + k]))
            self.catalog.append(sections)
        rng = np.random.default_rng(seed_sequence(self.ctx.seed, 0))
        self.request_order = rng.permutation(len(self.catalog)).tolist()

    def setup(self) -> None:
        from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
        from etude_tpu_torch.utils.model_loader import load_etude_decoder

        root, cfg = self.ctx.root, self.cfg
        self.prepare_traffic()
        self.model, model_config = load_etude_decoder(
            root / cfg["program_config"], root / cfg["weights_dir"], device=self.ctx.device)
        for key in ("hidden_size", "num_hidden_layers", "num_attention_heads",
                    "intermediate_size", "vocab_size", "max_position_embeddings",
                    "context_num_past_xy_pairs"):
            if getattr(model_config, key) != cfg[key]:
                raise ValueError(f"the program's decoder has {key} = "
                                 f"{getattr(model_config, key)}, the configuration {cfg[key]}")
        self.engine = StreamingGenerationEngine(
            model_config, bar_bos_id=self.ids["bar_bos"], bar_eos_id=self.ids["bar_eos"],
            pad_id=self.ids["pad"], max_bar_token_limit=cfg["max_bar_token_limit"],
            x_len_buckets=tuple(cfg["x_len_buckets"]), kv_quant=cfg["kv_cache"] == "int8")
        # Warm-up: one bar of the first request (its streams and shapes).
        streams, bins, _ = self.make_request(0)
        t0 = time.perf_counter()
        self.engine.generate_batch(self.model, [s[:1] for s in streams],
                                   [b[:1] for b in bins], **self._generate_kw(0))
        synchronize(self.ctx.device)
        note(f"warm-up bar: {time.perf_counter() - t0:.3f} s, {len(streams)} streams")

    def _generate_kw(self, index: int) -> dict:
        t = self.traffic
        return {"temperature": t["temperature"], "top_p": t["top_p"],
                "max_output_tokens": t["max_output_tokens"],
                "seed": int(seed_sequence(self.ctx.seed, 3, index).generate_state(1)[0])}

    def request(self, index: int) -> dict:
        from torch.profiler import record_function

        streams, bins, songs = self.make_request(index)
        chunks0 = self.engine.stats["single_token_chunks"]
        t0 = time.perf_counter()
        with record_function("bench.generate_batch"):
            out = self.engine.generate_batch(self.model, streams, bins,
                                             **self._generate_kw(index))
        seconds = time.perf_counter() - t0
        served = [[bar[1:] for bar in stream] for stream in out]
        chunks = self.engine.stats["single_token_chunks"] - chunks0
        tokens = sum(len(y) for stream in served for y in stream)
        return {
            "summary": f"{tokens} cover tokens, {chunks} S = 1 steps, longest condition bar "
                       f"{max(len(b) for s in streams for b in s)}",
            "attempted": len(streams),
            "failed": sum(not self._well_formed(s, o) for s, o in zip(streams, out)),
            "seconds": seconds,
            "single_token_chunks": chunks,
            "cover_tokens": tokens,
            "streams": streams, "bins": bins, "served": served, "songs": songs,
        }

    def _well_formed(self, x_bars, out) -> bool:
        """Every bar opened by Bar_BOS and closed by its first Bar_EOS, or cut
        at the bar cap without one."""
        cap, bos, eos = self.cfg["max_bar_token_limit"], self.ids["bar_bos"], self.ids["bar_eos"]
        if len(out) != len(x_bars):
            return False
        for bar in out:
            y = bar[1:]
            if not bar or bar[0] != bos or not 1 <= len(y) <= cap:
                return False
            if eos in y[:-1] or (len(y) < cap and y[-1] != eos):
                return False
        return True

    def release(self) -> None:
        self.model = self.engine = None
        gc.collect()

    # ---- what the metrics read ----------------------------------------------
    def cache_slots(self, record: dict) -> int:
        """C, the slots of every stream's cache in this request: the history
        window, the condition bucket, the opener and the bar cap."""
        cap = self.rules["cap"]
        X = x_bucket(max(len(b) for s in record["streams"] for b in s),
                     self.cfg["x_len_buckets"], cap)
        return max(cap, 4 * self.rules["n_ctx"]) + X + 1 + self.cfg["max_bar_token_limit"]

    def cover_flops(self, record: dict) -> int:
        """FLOPs of the request's cover tokens, each at its visible context."""
        base = decoder_token_flops(self.cfg, 0)
        per_key = decoder_token_flops(self.cfg, 1) - base   # FLOPs are linear in the keys
        tokens = keys = 0
        for x_bars, served in zip(record["streams"], record["served"]):
            x_lens = [len(b[-self.rules["cap"]:]) for b in x_bars]
            y_lens = [len(y) for y in served]
            for x_len, n, hist in zip(x_lens, y_lens,
                                      ref_mod.visible_history(x_lens, y_lens, self.rules)):
                # token j is predicted from the input at the opener + j, which
                # sees the history, the condition and j + 1 bar tokens
                first = hist + x_len + 1
                tokens += n
                keys += n * first + n * (n - 1) // 2
        return tokens * base + keys * per_key

    # ---- correctness ------------------------------------------------------------
    def check(self, records: List[dict]) -> List[Check]:
        import torch

        spec = self.traffic["check"]
        pool = [(r, s) for r, rec in enumerate(records) for s in range(rec["attempted"])]
        served_len = [sum(len(y) for y in records[r]["served"][s]) for r, s in pool]
        longest = int(np.argmax(served_len))
        rng = np.random.default_rng(seed_sequence(self.ctx.seed, 2))
        others = [i for i in range(len(pool)) if i != longest]
        k = min(spec["sample_streams"] - 1, len(others))
        picked = [longest] + [others[i] for i in rng.choice(len(others), k, replace=False)]

        t0 = time.perf_counter()
        ref = ref_mod.Decoder(self.ctx.root / self.cfg["weights_dir"] / "params.npz",
                              self.cfg, self.ctx.device)
        gaps = []
        with exact_float32():
            for i in picked:
                r, s = pool[i]
                rec = records[r]
                logits = ref.stream_logits(rec["streams"][s], rec["bins"][s],
                                           rec["served"][s], self.ids, self.rules)
                gaps.append(ref_mod.served_gaps(logits, rec["served"][s]))
        gaps = np.concatenate(gaps)
        self.diagnostics = {"max": float(gaps.max()), "q999": float(np.quantile(gaps, 0.999)),
                            "mean": float(gaps.mean()), "tokens": int(len(gaps))}
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        note(f"reference: {len(picked)} streams, {len(gaps)} served tokens, widest gap "
             f"{gaps.max():.4f}, {time.perf_counter() - t0:.3f} s")
        return [Check("served_gap_q999", self.diagnostics["q999"], spec["served_gap_q999"])]
