"""A trained decoder's covers of corpus songs, scored (JAX counterpart:
scripts/eval_distilled.py).

    python -m etude_tpu_torch.scripts.eval_distilled --run outputs/train_distill/<id> \\
        --vocab dataset_distill/vocab.json [--songs 10] [--corpus DIR] \\
        [--dataset-dir dataset_distill] [--oracle-attrs | --predicted-attrs] \\
        [--engine rebuild|stream] [--kv-quant] [--teacher-forced-history] \\
        [--temperature 0] [--out DIR] [--device cpu]

For each song: the condition is `etude_e.mid` on the song's beat grid (the
cached tracker grid of `distill_dataset` in `<dataset-dir>/tempo/` when
there is one, arbitrated against the RGC estimate, else the RGC estimate:
the grid the training corpus used), the decoder generates, the tokens are
decoded to `<out>/<SONG>_ours.mid`, and the cover is scored: RGC, IPE and
onset F1 against the distillation target (`etude_d.mid`). One JSON line of
means goes to stdout.

Attributes: by default the fixed bins 1/1/1 with overlap 2 (the reference
CLI's defaults); `--oracle-attrs` bins each bar's attributes computed from
the (etude_e, etude_d) pair under the training corpus's global edges
(`EtudeDataset(<dataset-dir>/tokenized).attribute_bin_edges`; without that
corpus, edges over the evaluated songs); `--predicted-attrs` takes them from
the attribute predictor (`--attr-prior-path`, default the committed
`checkpoints/attr_prior`, numpy). Greedy by default (temperature 0).

`--run` is a training run of the port (`model/params.npz`) or a published
export (`latest.ckpt`, `publish_decoder`), with `etude_decoder_config.json`
beside it; an orbax checkpoint raises. The rebuild engine (default) runs with
a 512-token prompt bucket and 64-token bars; the stream engine with a
512-token prompt cap (and `--kv-quant`, its int8 cache). With
`--teacher-forced-history` (rebuild only) the history takes the true
etude_d bars instead of the generated ones. Every S = 1 step runs the
decode-attention kernel on each layer on a card. The JAX script's `/tmp`
default output becomes `etude_torch_distill_eval` in the temporary
directory; `dataset_distill/`, `validation/` and `checkpoints/` are refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from . import REPO, refuse_committed
from .distill_dataset import arbitrate_grid, estimate_tempo_grid, grid_fit_score
from ..data.corpus_render import CORPUS_ROOT
from ..data.dataset import (
    bin_attribute, calculate_bin_edges, compute_relative_attributes, extract_bar_features,
)
from ..data.tokenizer import TinyREMITokenizer, split_sequence_into_bars
from ..data.vocab import Vocab
from ..evaluation.metrics import IPECalculator, RGCCalculator, onset_f1
from ..models.attr_prior import NAME_TO_KEY
from ..utils.device import resolve_device
from ..utils.logger import logger
from ..utils.midi import read_midi_notes, write_midi

_ATTR_NAMES = tuple(NAME_TO_KEY)
DEFAULT_OUT = Path(tempfile.gettempdir()) / "etude_torch_distill_eval"


@dataclasses.dataclass
class EvalRun:
    """What a run did: the printed aggregate; per song the condition bars,
    their attribute dicts, the target bars (with --oracle-attrs or
    --teacher-forced-history) and the generated bars; the engine's step
    counts (`stats`)."""

    agg: Dict
    songs: List[Dict]
    engine_stats: Dict[str, int]


def song_grid(name: str, tgt_notes, dataset_dir: Path):
    """The grid the training corpus used: the cached tracker grid if present
    (distill_dataset --grid tracker), else the RGC-period estimate."""
    cache = dataset_dir / "tempo" / f"{name}.json"
    rgc_tempo = estimate_tempo_grid(tgt_notes)
    if cache.exists():
        data = json.loads(cache.read_text())
        tempo = data.get("tempo")
        if tempo:
            rgc_score = _snap_score(tgt_notes, rgc_tempo)
            chosen, _ = arbitrate_grid(tempo, data.get("score"), rgc_tempo, rgc_score)
            return chosen
    return rgc_tempo


def _snap_score(notes, tempo):
    return grid_fit_score(notes, tempo) if tempo else np.inf


def load_decoder(run: Path, device):
    """(model, config) of a training run (`model/`) or a published export
    (`latest.ckpt`)."""
    from ..utils.model_loader import load_etude_decoder

    params_dir = run / "model" if (run / "model").exists() else run / "latest.ckpt"
    return load_etude_decoder(run / "etude_decoder_config.json", params_dir, device)


def run(argv=None) -> Optional[EvalRun]:
    """The CLI's work; None where the JAX script exits 1."""
    parser = argparse.ArgumentParser(description="Score a trained decoder's covers")
    parser.add_argument("--run", required=True, help="training run dir")
    parser.add_argument("--vocab", required=True)
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--dataset-dir", default="dataset_distill")
    parser.add_argument("--songs", type=int, default=10)
    parser.add_argument("--out", default=str(DEFAULT_OUT))
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--oracle-attrs", action="store_true")
    parser.add_argument("--predicted-attrs", action="store_true",
                        help="per-bar bins from the trained attribute predictor "
                             "(--attr-prior-path, scripts/train_attr_prior.py): the "
                             "default-serving mode without oracle access")
    parser.add_argument("--attr-temperature", type=float, default=0.0,
                        help="sampling temperature for --predicted-attrs (0 = argmax)")
    parser.add_argument("--attr-prior-path", default=None)
    parser.add_argument("--engine", choices=["rebuild", "stream"], default="rebuild")
    parser.add_argument("--kv-quant", action="store_true",
                        help="stream engine int8 KV cache (quality gate for enabling "
                             "it in serving/bench)")
    parser.add_argument("--teacher-forced-history", action="store_true",
                        help="history receives the true etude_d bars instead of "
                             "generated ones: per-bar cloning fidelity without "
                             "free-running drift (rebuild engine only)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    out_dir = refuse_committed(args.out, "--out")
    device = resolve_device(args.device)
    vocab = Vocab.load(args.vocab)
    model, config = load_decoder(Path(args.run), device)

    if args.teacher_forced_history and args.engine != "rebuild":
        logger.error("--teacher-forced-history requires --engine rebuild")
        return None
    if args.engine == "stream":
        from ..models.generate_stream import StreamingGenerationEngine

        # prompt_cap 512 = the reference's effective window (max_pos 1024 −
        # its default bar limit 512); without it the engine derives
        # 1024 − 64 = 960 from the 64-token bar limit. 512 also matches the
        # rebuild engine's 512-token prompt bucket below.
        engine = StreamingGenerationEngine(
            config, vocab.bar_bos_id, vocab.bar_eos_id, pad_id=vocab.pad_id,
            max_bar_token_limit=64, prompt_cap=512, kv_quant=args.kv_quant,
        )
    else:
        from ..models.generate import GenerationEngine

        engine = GenerationEngine(
            config, vocab.bar_bos_id, vocab.bar_eos_id, pad_id=vocab.pad_id,
            prompt_buckets=(512,), max_bar_token_limit=64,
        )
    attrs_default = {"polyphony_bin": 1, "rhythm_intensity_bin": 1,
                     "sustain_bin": 1, "pitch_overlap_bin": 2}

    corpus = Path(args.corpus)
    dataset_dir = Path(args.dataset_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(corpus / "metadata.json", "r", encoding="utf-8") as f:
        songs = json.load(f)[: args.songs]

    # Pass 1: tokenize every song; collect the per-bar attributes.
    prepared = []
    all_attrs = []
    for meta in songs:
        name = meta["dir_name"]
        song_dir = corpus / name
        try:
            src_notes = read_midi_notes(song_dir / "etude_e.mid")
            tgt_notes = read_midi_notes(song_dir / "etude_d.mid")
        except Exception:
            continue
        tempo = song_grid(name, tgt_notes, dataset_dir)
        if tempo is None or not tempo:
            continue
        tok = TinyREMITokenizer(tempo_data=tempo)
        src_ids = vocab.encode_sequence(tok.encode(src_notes, with_grace_note=True))
        src_bars = split_sequence_into_bars(src_ids, vocab.bar_bos_id, vocab.bar_eos_id)
        if not src_bars:
            continue
        entry = {"name": name, "tempo": tempo, "src_bars": src_bars, "tgt_notes": tgt_notes}
        if args.oracle_attrs or args.teacher_forced_history:
            tgt_ids = vocab.encode_sequence(
                TinyREMITokenizer(tempo_data=tempo).encode(tgt_notes, with_grace_note=True))
            entry["tgt_bars"] = split_sequence_into_bars(tgt_ids, vocab.bar_bos_id,
                                                         vocab.bar_eos_id)
        if args.oracle_attrs:
            tgt_bars = entry["tgt_bars"]
            n = min(len(src_bars), len(tgt_bars))
            attrs = [
                compute_relative_attributes(extract_bar_features(src_bars[i], vocab),
                                            extract_bar_features(tgt_bars[i], vocab))
                for i in range(n)
            ]
            entry["attrs_raw"] = attrs
            all_attrs.extend(attrs)
        prepared.append(entry)

    # Oracle bins use the edges the distillation training fit (the
    # dataset-global mean ± k·std edges over the full tokenized corpus), not
    # edges refit on the evaluated subset, which shift with --songs.
    edges = None
    if args.oracle_attrs:
        tokenized = dataset_dir / "tokenized"
        if tokenized.exists():
            from ..data.dataset import EtudeDataset

            edges = EtudeDataset(tokenized, vocab, max_seq_len=1024).attribute_bin_edges
        else:
            logger.warn(f"{tokenized} missing; oracle bin edges fall back to the "
                        f"{len(songs)}-song eval subset")
            edges = calculate_bin_edges(all_attrs) if all_attrs else None

    prior = None
    if args.predicted_attrs:
        from ..models.attr_prior import AttrPrior

        prior_path = args.attr_prior_path or (REPO / "checkpoints" / "attr_prior")
        prior = AttrPrior.load(prior_path)
        logger.info(f"attribute predictor loaded from {prior_path}")

    rgc, ipe = RGCCalculator(top_k=8), IPECalculator(n_gram=8, n_clusters=16)
    rows = []
    for entry in prepared:
        name, tempo = entry["name"], entry["tempo"]
        bars = entry["src_bars"]
        if prior is not None:
            per_bar = prior.predict_bins(bars, vocab, temperature=args.attr_temperature,
                                         seed=args.seed)
        elif args.oracle_attrs:
            per_bar = []
            for i in range(len(bars)):
                if i < len(entry["attrs_raw"]):
                    raw = entry["attrs_raw"][i]
                    per_bar.append({NAME_TO_KEY[nm]: bin_attribute(raw[nm], edges.get(nm))
                                    for nm in _ATTR_NAMES})
                else:
                    per_bar.append(dict(attrs_default))
        else:
            per_bar = [attrs_default] * len(bars)

        if args.teacher_forced_history:
            generated = engine.generate_batch(
                model, [bars], [per_bar], temperature=args.temperature, top_p=0.9,
                seed=args.seed, forced_history_y=[entry["tgt_bars"]],
            )[0]
        else:
            generated = engine.generate(model, bars, per_bar, temperature=args.temperature,
                                        top_p=0.9, seed=args.seed)
        entry["per_bar"], entry["generated"] = per_bar, generated
        gen_events = [e for bar in generated for e in vocab.decode_sequence_to_events(bar)]
        notes = TinyREMITokenizer(tempo_data=tempo).decode_to_notes(gen_events)
        midi_path = out_dir / f"{name}_ours.mid"
        write_midi(notes, midi_path)

        row = {"song": name, "n_notes": len(notes)}
        row["rgc"] = rgc.calculate(midi_path).get("rgc_score")
        row["ipe"] = ipe.calculate(midi_path).get("ipe_score")
        row["onset_f1_vs_target"] = onset_f1(entry["tgt_notes"], notes, tolerance=0.1)["f1"]
        rows.append(row)
        logger.info(f"{name}: notes={row['n_notes']} rgc={row['rgc']} "
                    f"ipe={row['ipe']} f1={row['onset_f1_vs_target']:.3f}")

    if not rows:
        return None

    def mean_of(key):
        vals = [r[key] for r in rows if r.get(key) is not None]
        return float(np.mean(vals)) if vals else None

    agg = {
        "songs": len(rows),
        "mean_rgc": mean_of("rgc"),
        "mean_ipe": mean_of("ipe"),
        "mean_onset_f1_vs_target": mean_of("onset_f1_vs_target"),
        "mean_notes": mean_of("n_notes"),
        "oracle_attrs": bool(args.oracle_attrs),
        "predicted_attrs": bool(args.predicted_attrs),
        "temperature": args.temperature,
        "engine": args.engine,
    }
    return EvalRun(agg=agg, songs=prepared, engine_stats=dict(engine.stats))


def main(argv=None) -> int:
    result = run(argv)
    if result is None:
        return 1
    print(json.dumps(result.agg))
    return 0


if __name__ == "__main__":
    sys.exit(main())
