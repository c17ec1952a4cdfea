"""RGC and IPE of the full pipeline's covers over sampling configs (JAX
counterpart: scripts/sweep_sampling.py, whose docstring gives the why: a
serving default chosen on data).

    python -m etude_tpu_torch.scripts.sweep_sampling [--songs 10] [--seconds 180] \\
        [--temps 0 0.5 0.7 0.9] [--top-ps 0.9] [--seeds 1] [--attrs-prior] \\
        [--corpus DIR] [--cache DIR] [--out outputs/sampling_sweep.json] \\
        [--config settings.json] [--allow-random-weights] [--device cpu]

Per song, the first `--seconds` of the corpus `human.mid` are rendered to a
44.1 kHz piano WAV and the pipeline's stages 1 and 2 run once
(`InferencePipeline._prepare_audio`, `_run_stage1_extract`, `_run_volume`,
`_run_stage2_structuralize`) into `<cache>/<SONG>/work`, which later runs
reuse. Then each (temperature, top-p, seed) config decodes every song in
one batched stream-engine call (`generate_batch`), writes
`<cache>/<SONG>/T<t>_p<p>_s<seed>.mid` and scores RGC and IPE; the corpus's
`human` and `etude_d` versions are scored beside them. Per-bar attributes
are the neutral combo, or with `--attrs-prior` the predictor's in
`<paths.checkpoints_dir>/attr_prior`. The JSON payload goes to `--out` and
its `results` to stdout.

The weights come from the settings file (`--config`, as `infer` reads it);
a missing checkpoint is an error unless `--allow-random-weights`, an orbax
one raises. The stream engine runs the decode-attention kernel on every
S = 1 chunk and stage 2 the dilated-attention kernel on a card. The JAX
script writes `validation/sampling_sweep.json` and caches in `/tmp`; the
port writes under `outputs/`, caches as `etude_torch_sweep_cache` in the
temporary directory, and refuses `dataset_distill/`, `validation/` and
`checkpoints/`. Running the sweep for quality is not this script's job.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from . import OUTPUTS, refuse_committed
from ..data.corpus_render import CORPUS_ROOT
from ..utils.device import resolve_device

DEFAULT_CACHE = Path(tempfile.gettempdir()) / "etude_torch_sweep_cache"


def stage_songs(songs, seconds: float, cache: Path, corpus: Path, config_path=None,
                device=None, allow_random_weights: bool = False):
    """Render and run stages 1 and 2 once per song; returns the per-song
    work dirs (a song whose three intermediates exist is not staged again)."""
    from ..config import load_config
    from ..data.synthetic import render_piano
    from ..infer import InferencePipeline
    from ..utils.audio import decode_audio, save_wav
    from ..utils.logger import logger
    from ..utils.midi import read_midi_notes

    dirs = {}
    for song in songs:
        work = cache / song
        out = work / "out"
        need = [work / "work" / n for n in ("extract.json", "tempo.json", "volume.json")]
        if all(p.exists() for p in need):
            dirs[song] = work / "work"
            continue
        work.mkdir(parents=True, exist_ok=True)
        notes = [n for n in read_midi_notes(corpus / song / "human.mid")
                 if n["onset"] < seconds - 2]
        wav = work / "song.wav"
        save_wav(wav, render_piano(notes, seconds, sr=44100), 44100)
        cfg = load_config(config_path, overrides={"paths": {"infer_output_dir": str(out)}})
        pipeline = InferencePipeline(cfg, device=device,
                                     allow_random_weights=allow_random_weights)
        pipeline._require_weights("extract", "structuralize")
        # The pipeline's intermediates go to a per-song dir that is kept.
        pipeline.work_dir = work / "work"
        pipeline.work_dir.mkdir(parents=True, exist_ok=True)
        audio = pipeline._prepare_audio(str(wav))
        wave_sr = decode_audio(audio, target_sr=None, mono=True)
        pipeline._run_stage1_extract(audio, wave_sr)
        pipeline._run_volume(audio, wave_sr)
        pipeline._run_stage2_structuralize(audio, wave_sr)
        dirs[song] = pipeline.work_dir
        logger.info(f"staged {song}")
    return dirs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Sampling-config sweep of RGC and IPE")
    parser.add_argument("--songs", type=int, default=10)
    parser.add_argument("--seconds", type=float, default=180.0)
    parser.add_argument("--temps", type=float, nargs="+", default=[0.0, 0.5, 0.7, 0.9])
    parser.add_argument("--top-ps", type=float, nargs="+", default=[0.9])
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--cache", default=str(DEFAULT_CACHE))
    parser.add_argument("--out", default=str(OUTPUTS / "sampling_sweep.json"))
    parser.add_argument("--attrs-prior", action="store_true",
                        help="per-bar attributes from the trained predictor instead of "
                             "the constant neutral combo")
    parser.add_argument("--corpus", default=str(CORPUS_ROOT))
    parser.add_argument("--config", default=None,
                        help="settings file (.json, or YAML with PyYAML)")
    parser.add_argument("--allow-random-weights", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from ..config import load_config
    from ..data.tokenizer import TinyREMITokenizer, split_sequence_into_bars
    from ..data.vocab import Vocab
    from ..evaluation.metrics import IPECalculator, RGCCalculator
    from ..models.generate_stream import StreamingGenerationEngine
    from ..utils.logger import logger
    from ..utils.model_loader import load_etude_decoder

    out_path = refuse_committed(args.out, "--out")
    cache = refuse_committed(args.cache, "--cache")
    device = resolve_device(args.device)
    corpus = Path(args.corpus)
    songs = sorted(d.name for d in corpus.iterdir()
                   if d.is_dir() and (d / "human.mid").exists())[: args.songs]
    dirs = stage_songs(songs, args.seconds, cache, corpus, args.config, device,
                       args.allow_random_weights)

    cfg = load_config(args.config)
    vocab = Vocab.load(cfg.paths.decoder_vocab)
    model, model_config = load_etude_decoder(cfg.paths.decoder_config, cfg.paths.decoder_model,
                                             device, args.allow_random_weights)
    d = cfg.decoder
    engine = StreamingGenerationEngine(
        model_config, bar_bos_id=vocab.bar_bos_id, bar_eos_id=vocab.bar_eos_id,
        pad_id=vocab.pad_id, max_bar_token_limit=d.max_bar_token_limit,
    )

    neutral = {"polyphony_bin": 1, "rhythm_intensity_bin": 1,
               "sustain_bin": 1, "pitch_overlap_bin": 2}
    conditions, tokenizers, per_bar_attrs = {}, {}, {}
    prior = None
    if args.attrs_prior:
        from ..models.attr_prior import AttrPrior

        prior = AttrPrior.load(Path(cfg.paths.checkpoints_dir) / "attr_prior")
    for song in songs:
        work = dirs[song]
        tok = TinyREMITokenizer(tempo_path=work / "tempo.json")
        ids = vocab.encode_sequence(tok.encode(work / "extract.json"))
        bars = split_sequence_into_bars(ids, vocab.bar_bos_id, vocab.bar_eos_id)
        conditions[song] = bars
        tokenizers[song] = (tok, work / "volume.json")
        per_bar_attrs[song] = (prior.predict_bins(bars, vocab, seed=0) if prior
                               else [neutral] * len(bars))

    rgc = RGCCalculator(top_k=8)
    ipe = IPECalculator(n_gram=8, n_clusters=16)
    ref_stats = {}
    for v in ("human", "etude_d"):
        r = [rgc.calculate(corpus / s / f"{v}.mid").get("rgc_score")
             for s in songs if (corpus / s / f"{v}.mid").exists()]
        i = [ipe.calculate(corpus / s / f"{v}.mid").get("ipe_score")
             for s in songs if (corpus / s / f"{v}.mid").exists()]
        ref_stats[v] = {
            "rgc": round(float(np.mean([x for x in r if x is not None])), 4),
            "ipe": round(float(np.mean([x for x in i if x is not None])), 3),
        }

    results = []
    for temp in args.temps:
        for top_p in args.top_ps:
            per_seed = []
            for seed in range(args.seeds):
                t0 = time.perf_counter()
                streams = engine.generate_batch(
                    model, [conditions[s] for s in songs], [per_bar_attrs[s] for s in songs],
                    temperature=temp, top_p=top_p, max_output_tokens=d.max_output_tokens,
                    seed=seed,
                )
                wall = time.perf_counter() - t0
                rgcs, ipes = [], []
                for song, bars in zip(songs, streams):
                    events = [e for bar in bars for e in vocab.decode_sequence_to_events(bar)]
                    tok, volume = tokenizers[song]
                    notes = tok.decode_to_notes(events, volume)
                    mid = cache / song / f"T{temp}_p{top_p}_s{seed}.mid"
                    TinyREMITokenizer.note_to_midi(notes, mid)
                    r = rgc.calculate(mid).get("rgc_score")
                    i = ipe.calculate(mid).get("ipe_score")
                    if r is not None:
                        rgcs.append(r)
                    if i is not None:
                        ipes.append(i)
                per_seed.append({
                    "rgc": round(float(np.mean(rgcs)), 4) if rgcs else None,
                    "ipe": round(float(np.mean(ipes)), 3) if ipes else None,
                    "wall_s": round(wall, 1),
                })
            seed_rgcs = [s["rgc"] for s in per_seed if s["rgc"] is not None]
            seed_ipes = [s["ipe"] for s in per_seed if s["ipe"] is not None]
            row = {
                "temperature": temp, "top_p": top_p,
                "rgc": round(float(np.mean(seed_rgcs)), 4) if seed_rgcs else None,
                "ipe": round(float(np.mean(seed_ipes)), 3) if seed_ipes else None,
                "seeds": per_seed,
            }
            results.append(row)
            logger.success(
                f"T={temp} top_p={top_p}: RGC {row['rgc']} IPE {row['ipe']} "
                f"(human RGC {ref_stats['human']['rgc']} IPE {ref_stats['human']['ipe']})"
            )

    payload = {
        "songs": songs, "seconds": args.seconds,
        "attrs": "prior" if args.attrs_prior else "neutral",
        "refs": ref_stats, "results": results,
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
    print(json.dumps(payload["results"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
