"""Training dataset: paired (condition, target) bar sequences with relative
musical attributes.

The port's own copy of etude_tpu/data/dataset.py (numpy only), kept so that
etude_tpu_torch imports nothing of the JAX package. The same songs, bin
edges, sample map and, for the same seed, the same batches bit for bit: the
three numpy streams of `batches` (shuffle `seed`, attribute dropout
`seed + 1`, DAgger history `seed + 2`) are drawn in the same order.

Semantics mirror the reference dataset (etude/data/dataset.py): per bar pair
four relative attributes are computed (polyphony / rhythmic intensity / note
sustain / pitch-class overlap), binned against dataset-global mean±k·std
edges, and each training sample packs 4 past (X, Y) bar pairs of context
(empty [BOS, EOS] bars with neutral bin 1 when history is short), the current
X, and the current Y, with labels masked to the current Y's next-token
targets. Batches are padded to a fixed max_seq_len, so every training step
has one shape, and the iterator yields plain numpy dicts.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from .vocab import Vocab
from ..utils.logger import logger

SRC_CLASS_ID = 1
TGT_CLASS_ID = 2
PAD_CLASS_ID = 0
ATTRIBUTE_PAD_ID = 0
LABEL_IGNORE_ID = -100

# Full attribute names (binning statistics) → batch-key short names.
MODEL_ATTRIBUTES = (
    "relative_polyphony",
    "relative_rhythmic_intensity",
    "relative_note_sustain",
    "pitch_overlap_ratio",
)
ATTRIBUTE_SHORT_NAMES = {
    "relative_polyphony": "polyphony",
    "relative_rhythmic_intensity": "rhythm_intensity",
    "relative_note_sustain": "sustain",
    "pitch_overlap_ratio": "pitch_overlap",
}
# Std multipliers defining the 3-bin edges per attribute.
BIN_STD_MULTIPLIERS = {
    "relative_rhythmic_intensity": (-0.2, 0.2),
    "relative_polyphony": (-0.5, 0.5),
    "relative_note_sustain": (-0.7, 0.7),
    "pitch_overlap_ratio": (-0.7, 0.7),
}


def split_ids_into_bars(ids: Sequence[int], bos_id: int, eos_id: int) -> List[List[int]]:
    """Split a token-id stream into [BOS ... EOS] bars, closing unterminated
    bars and dropping bars with no payload.

    Intentionally NOT the same as tokenizer.split_sequence_into_bars: the
    reference's dataset splitter closes a bar interrupted by a new BOS
    (etude/data/dataset.py:177-202) while its inference splitter drops it —
    both behaviors are preserved for parity."""
    bars: List[List[int]] = []
    current: List[int] = []
    in_bar = False
    for tok in ids:
        if tok == bos_id:
            if in_bar and current:
                current.append(eos_id)
                bars.append(current)
            current = [tok]
            in_bar = True
        elif tok == eos_id:
            if in_bar:
                current.append(tok)
                bars.append(current)
                current = []
                in_bar = False
        elif in_bar:
            current.append(tok)
    if in_bar and current:
        current.append(eos_id)
        bars.append(current)
    return [b for b in bars if len(b) > 2]


def extract_bar_features(bar_ids: Sequence[int], vocab: Vocab) -> Dict[str, Any]:
    """Count notes/positions/durations and group pitches by position."""
    note_count = 0
    pos_count = 0
    total_dur = 0
    notes_by_pos: Dict[int, List[int]] = defaultdict(list)
    current_pos = -1
    for event in vocab.decode_sequence_to_events(bar_ids):
        if event.type_ == "Pos" and isinstance(event.value, int):
            pos_count += 1
            current_pos = event.value
        elif event.type_ == "Note" and isinstance(event.value, int) and current_pos != -1:
            note_count += 1
            notes_by_pos[current_pos].append(event.value)
        elif event.type_ == "Duration" and isinstance(event.value, int):
            total_dur += event.value
    return {
        "note_count": note_count,
        "pos_event_count": pos_count,
        "notes_by_position": notes_by_pos,
        "total_duration_in_16ths": total_dur,
    }


def compute_relative_attributes(src: Dict[str, Any], tgt: Dict[str, Any]) -> Dict[str, float]:
    """Four relative attributes of a (condition, target) bar pair."""

    def ratio(n, d, default=0.0):
        return n / d if d else default

    src_npp = ratio(src["note_count"], src["pos_event_count"])
    tgt_npp = ratio(tgt["note_count"], tgt["pos_event_count"])
    src_dur = ratio(src["total_duration_in_16ths"], src["note_count"])
    tgt_dur = ratio(tgt["total_duration_in_16ths"], tgt["note_count"])

    attrs = {
        "relative_polyphony": ratio(tgt_npp, src_npp, default=1.0),
        "relative_rhythmic_intensity": ratio(
            tgt["pos_event_count"], src["pos_event_count"], default=1.0
        ),
        "relative_note_sustain": ratio(tgt_dur, src_dur, default=1.0),
    }

    src_by_pos, tgt_by_pos = src["notes_by_position"], tgt["notes_by_position"]
    all_pos = set(src_by_pos) | set(tgt_by_pos)
    if not all_pos:
        attrs["pitch_overlap_ratio"] = 0.0
    else:
        ratios = []
        for p in all_pos:
            if p in tgt_by_pos:
                src_classes = {pitch % 12 for pitch in src_by_pos.get(p, [])}
                hit = sum(1 for t in tgt_by_pos[p] if t % 12 in src_classes)
                ratios.append(ratio(hit, len(tgt_by_pos[p])))
            else:
                ratios.append(0.0 if p in src_by_pos else 1.0)
        attrs["pitch_overlap_ratio"] = float(np.mean(ratios)) if ratios else 0.0
    return attrs


def calculate_bin_edges(all_attrs: List[Dict[str, float]]) -> Dict[str, np.ndarray]:
    """Dataset-global 3-bin edges per attribute: mean + k·std."""
    edges_map: Dict[str, np.ndarray] = {}
    for name in MODEL_ATTRIBUTES:
        multipliers = BIN_STD_MULTIPLIERS.get(name, (-1.0, 1.0))
        values = np.array(
            [a[name] for a in all_attrs if name in a and np.isfinite(a[name])]
        )
        if len(values) < 2:
            edges = np.array([-0.5, 0.5])
        else:
            mean, std = float(np.mean(values)), float(np.std(values))
            if std < 1e-6:
                eps = 1e-3 * (abs(mean) if abs(mean) > 1e-6 else 1.0)
                edges = np.array([mean - eps, mean + eps])
            else:
                edges = np.array([mean + m * std for m in multipliers])
        edges_map[name] = np.sort(np.unique(edges))
    return edges_map


def bin_attribute(value: float, edges: Optional[np.ndarray]) -> int:
    if edges is None or len(edges) == 0:
        return 1
    return int(np.digitize(value, edges))


class EtudeDataset:
    """Loads tokenized song pairs and serves fixed-shape training chunks."""

    def __init__(
        self,
        dataset_dir: Union[str, Path],
        vocab: Vocab,
        max_seq_len: int = 1024,
        src_suffix: str = "_src.npy",
        tgt_suffix: str = "_tgt.npy",
        hist_suffix: Optional[str] = None,
        data_format: str = "npy",
        num_attribute_bins: int = 3,
        context_num_past_xy_pairs: int = 4,
        attr_dropout: float = 0.0,
        dagger_history_prob: float = 1.0,
    ):
        self.dataset_dir = Path(dataset_dir)
        self.vocab = vocab
        self.max_seq_len = max_seq_len
        self.src_suffix = src_suffix
        self.tgt_suffix = tgt_suffix
        # DAgger-style exposure-bias training: when NNNN_hist.npy exists
        # (the model's OWN free-running rollout, scripts/dagger_rollouts.py),
        # history Y bars come from it while the current-bar target (labels)
        # stays the teacher's — training sees the same self-generated
        # history distribution that inference produces. History attribute
        # bins stay the TEACHER pair's (the engine conditions history on the
        # requested bins, not recomputed ones). hist_suffix=None disables.
        self.hist_suffix = hist_suffix
        self.data_format = data_format
        self.num_attribute_bins = num_attribute_bins
        self.context_pairs = context_num_past_xy_pairs
        # Sample-level attribute dropout: with this probability a training
        # chunk's four bin-ID streams are all replaced by the neutral bin 1
        # (the same value empty-history bars use). Default serving passes
        # constant neutral bins for every bar (no oracle access), so
        # dropout-trained models see that exact conditioning during
        # training instead of only oracle bins.
        self.attr_dropout = float(attr_dropout)
        # Per-chunk probability of using the rollout history when
        # hist_suffix is set; the rest of the chunks keep the TEACHER
        # history. Mixing preserves the teacher-forced conditional (whose
        # accuracy pure-rollout DAgger passes erode) while still training
        # on the self-generated history distribution inference produces.
        self.dagger_history_prob = float(dagger_history_prob)

        self.pad_id = vocab.pad_id
        self.bar_bos_id = vocab.bar_bos_id
        self.bar_eos_id = vocab.bar_eos_id
        if self.pad_id < 0 or self.bar_bos_id < 0 or self.bar_eos_id < 0:
            raise ValueError("vocab must define <PAD>, Bar_BOS and Bar_EOS")

        self.songs = self._load_songs()
        # Chunks `batches` has served, and those whose history holds a
        # model rollout's bars (a bar past the first of a song with a
        # `_hist` file, drawn with the rollout history); per song, whether
        # its history bars come from such a file.
        self.history_counts = {"chunks": 0, "rollout": 0}
        self.has_rollouts = [
            any(b["hist_bar_ids"] is not b["tgt_bar_ids"] for b in song["bars"])
            for song in self.songs]
        all_attrs = [bar["attributes"] for song in self.songs for bar in song["bars"]]
        self.attribute_bin_edges = calculate_bin_edges(all_attrs)
        self.sample_map = self._build_sample_map()
        logger.debug(
            f"EtudeDataset: {len(self.songs)} songs, {len(self.sample_map)} chunks"
        )

    # ---- loading -------------------------------------------------------
    def _load_ids(self, path: Path) -> List[int]:
        try:
            if self.data_format == "npy":
                return np.load(path, allow_pickle=True).astype(np.int64).tolist()
            if self.data_format == "json":
                with open(path, "r", encoding="utf-8") as f:
                    return json.load(f)
            raise ValueError(f"unsupported data format: {self.data_format}")
        except Exception as exc:
            logger.warn(f"failed to load {path}: {exc}")
            return []

    def _load_songs(self) -> List[Dict[str, Any]]:
        songs = []
        if not self.dataset_dir.exists():
            logger.warn(f"dataset dir {self.dataset_dir} does not exist")
            return songs
        for subdir in sorted(self.dataset_dir.iterdir()):
            if not (subdir.is_dir() and subdir.name.isdigit()):
                continue
            src_f = subdir / f"{subdir.name}{self.src_suffix}"
            tgt_f = subdir / f"{subdir.name}{self.tgt_suffix}"
            if not (src_f.exists() and tgt_f.exists()):
                continue
            src_ids, tgt_ids = self._load_ids(src_f), self._load_ids(tgt_f)
            if not src_ids or not tgt_ids:
                continue
            src_bars = split_ids_into_bars(src_ids, self.bar_bos_id, self.bar_eos_id)
            tgt_bars = split_ids_into_bars(tgt_ids, self.bar_bos_id, self.bar_eos_id)
            hist_bars = None
            if self.hist_suffix:
                hist_f = subdir / f"{subdir.name}{self.hist_suffix}"
                if hist_f.exists():
                    hist_ids = self._load_ids(hist_f)
                    cand = split_ids_into_bars(
                        hist_ids, self.bar_bos_id, self.bar_eos_id
                    )
                    # Rollouts must align 1:1 with the teacher bars.
                    if len(cand) == min(len(src_bars), len(tgt_bars)):
                        hist_bars = cand
                    else:
                        logger.warn(
                            f"{hist_f.name}: {len(cand)} bars vs "
                            f"{len(tgt_bars)} teacher bars — ignored"
                        )
            bars = []
            for i, (sb, tb) in enumerate(zip(src_bars, tgt_bars)):
                attrs = compute_relative_attributes(
                    extract_bar_features(sb, self.vocab),
                    extract_bar_features(tb, self.vocab),
                )
                bars.append({
                    "attributes": attrs, "src_bar_ids": sb, "tgt_bar_ids": tb,
                    "hist_bar_ids": hist_bars[i] if hist_bars else tb,
                })
            if bars:
                songs.append({"song_name": subdir.name, "bars": bars})
        return songs

    # ---- sample construction ------------------------------------------
    def _bar_attr_bins(self, bar: Dict[str, Any]) -> Dict[str, int]:
        return {
            ATTRIBUTE_SHORT_NAMES[name]: bin_attribute(
                bar["attributes"][name], self.attribute_bin_edges.get(name)
            )
            for name in MODEL_ATTRIBUTES
        }

    def _full_sample(
        self, song_idx: int, bar_idx: int, use_hist: bool = True
    ) -> Dict[str, List[int]]:
        bars = self.songs[song_idx]["bars"]
        empty_bar = [self.bar_bos_id, self.bar_eos_id]
        shorts = [ATTRIBUTE_SHORT_NAMES[n] for n in MODEL_ATTRIBUTES]

        tokens: List[int] = []
        classes: List[int] = []
        attrs: Dict[str, List[int]] = {f"{s}_bin_ids": [] for s in shorts}

        def extend(ids, class_id, bin_map):
            tokens.extend(ids)
            classes.extend([class_id] * len(ids))
            for s in shorts:
                attrs[f"{s}_bin_ids"].extend([bin_map[s]] * len(ids))

        for k in range(self.context_pairs):
            hist_idx = bar_idx - (self.context_pairs - k)
            if hist_idx >= 0:
                past = bars[hist_idx]
                bin_map = self._bar_attr_bins(past)
                extend(past["src_bar_ids"], SRC_CLASS_ID, bin_map)
                extend(past.get("hist_bar_ids", past["tgt_bar_ids"])
                       if use_hist else past["tgt_bar_ids"],
                       TGT_CLASS_ID, bin_map)
            else:
                neutral = {s: 1 for s in shorts}
                extend(empty_bar, SRC_CLASS_ID, neutral)
                extend(empty_bar, TGT_CLASS_ID, neutral)

        context_len = len(tokens)
        current = bars[bar_idx]
        bin_map = self._bar_attr_bins(current)
        cur_x, cur_y = current["src_bar_ids"], current["tgt_bar_ids"]
        extend(cur_x, SRC_CLASS_ID, bin_map)
        extend(cur_y, TGT_CLASS_ID, bin_map)

        labels = (
            [LABEL_IGNORE_ID] * (context_len + len(cur_x))
            + cur_y[1:]
            + [LABEL_IGNORE_ID]
        )
        sample = {"input_ids": tokens, "class_ids": classes, "labels": labels}
        sample.update(attrs)
        return sample

    def _build_sample_map(self) -> List[Tuple[int, int, int, int]]:
        """(song_idx, bar_idx, chunk_start, chunk_end) per training chunk."""
        sample_map = []
        empty_len = 2
        for song_idx, song in enumerate(self.songs):
            bars = song["bars"]
            for bar_idx in range(len(bars)):
                ctx = 0
                for k in range(self.context_pairs):
                    hist_idx = bar_idx - (self.context_pairs - k)
                    if hist_idx >= 0:
                        past = bars[hist_idx]
                        ctx += len(past["src_bar_ids"]) + len(
                            past.get("hist_bar_ids", past["tgt_bar_ids"])
                        )
                    else:
                        ctx += 2 * empty_len
                total = ctx + len(bars[bar_idx]["src_bar_ids"]) + len(
                    bars[bar_idx]["tgt_bar_ids"]
                )
                for start in range(0, total, self.max_seq_len):
                    end = min(start + self.max_seq_len, total)
                    if end - start >= 2:
                        sample_map.append((song_idx, bar_idx, start, end))
        return sample_map

    def __len__(self) -> int:
        return len(self.sample_map)

    def __getitem__(self, idx: int) -> Dict[str, List[int]]:
        return self._chunk(idx, use_hist=True)

    def _chunk(self, idx: int, use_hist: bool) -> Dict[str, List[int]]:
        song_idx, bar_idx, start, end = self.sample_map[idx]
        full = self._full_sample(song_idx, bar_idx, use_hist=use_hist)
        # Chunk starts were computed on the hist-based stream; the teacher
        # stream may be shorter/longer, so slice a full window from `start`
        # rather than trusting the precomputed end (which would truncate a
        # longer-history variant). Python slicing clips at the stream end;
        # the slight boundary drift only affects multi-chunk (>max_seq_len
        # token) bars.
        return {k: v[start:start + self.max_seq_len] for k, v in full.items()}

    # ---- batching ------------------------------------------------------
    def collate(self, items: List[Dict[str, List[int]]]) -> Dict[str, np.ndarray]:
        """Pad a list of chunks to the dataset's fixed max_seq_len.

        Static output shape [B, max_seq_len] for every batch.
        """
        T = self.max_seq_len
        B = len(items)
        shorts = [ATTRIBUTE_SHORT_NAMES[n] for n in MODEL_ATTRIBUTES]
        out = {
            "input_ids": np.full((B, T), self.pad_id, np.int32),
            "class_ids": np.full((B, T), PAD_CLASS_ID, np.int32),
            "labels": np.full((B, T), LABEL_IGNORE_ID, np.int32),
            "attention_mask": np.zeros((B, T), np.int32),
        }
        for s in shorts:
            out[f"{s}_bin_ids"] = np.full((B, T), ATTRIBUTE_PAD_ID, np.int32)
        for b, item in enumerate(items):
            n = len(item["input_ids"])
            out["input_ids"][b, :n] = item["input_ids"]
            out["class_ids"][b, :n] = item["class_ids"]
            out["labels"][b, :n] = item["labels"]
            out["attention_mask"][b, :n] = 1
            for s in shorts:
                key = f"{s}_bin_ids"
                out[key][b, :n] = item[key]
        return out

    def batches(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield fixed-shape numpy batches; incomplete batches are padded up
        (with fully-masked rows) rather than dropped when drop_last=False."""
        order = np.arange(len(self.sample_map))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        drop_rng = np.random.default_rng(seed + 1)
        hist_rng = np.random.default_rng(seed + 2)

        def fetch(j):
            use_hist = self.hist_suffix is not None and (
                self.dagger_history_prob >= 1.0
                or hist_rng.random() < self.dagger_history_prob
            )
            song_idx, bar_idx = self.sample_map[j][:2]
            self.history_counts["chunks"] += 1
            self.history_counts["rollout"] += int(
                use_hist and bar_idx > 0 and self.has_rollouts[song_idx])
            return self._chunk(j, use_hist=use_hist)

        def maybe_drop_attrs(item):
            if self.attr_dropout <= 0.0 or not item["input_ids"]:
                return item
            if drop_rng.random() >= self.attr_dropout:
                return item
            n = len(item["input_ids"])
            for key in item:
                if key.endswith("_bin_ids"):
                    item[key] = [1] * n
            return item

        for i in range(0, len(order), batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:
                if drop_last:
                    return
                pad_rows = batch_size - len(idx)
                items = [maybe_drop_attrs(fetch(j)) for j in idx] + [
                    {k: [] for k in self[0].keys()} for _ in range(pad_rows)
                ]
                yield self.collate(items)
                return
            yield self.collate([maybe_drop_attrs(fetch(j)) for j in idx])
