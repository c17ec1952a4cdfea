"""Readings that a cell's limits are set from: the program on many seeds and
the precision control on a few, at the cell's own size, in one process.

    python3 h100_bench/control.py --workload <name> --seeds 1,2,3 \
        --control-seeds 1,2,3 --seconds 1 --json out.json

For every seed it runs the cell as `run.py` does (set-up, a window of at
least one whole request, the comparison with the reference) and records
each number compared. For a control seed it also reads the same numbers
with the control in the program's place, the nearest precision below the
configuration's:
  * the decoder (bf16): the engine's own int8 path (`kv_quant`: an int8
    cache with int8 queries and probabilities), teacher-forced on the same
    prompts and served tokens; at each position the token that the int8
    path puts first is judged by the float32 reference, as the served token
    is; the reference run in float8 is read beside it;
  * the analysis models (bf16, no lower path of their own): the reference
    with every matmul and convolution operand rounded to float8 e4m3.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _int8_tokens(model, model_config, rec, s, ids, rules, cfg, device):
    """Per bar, the tokens the engine's int8 path puts first at each served
    position of stream `s`, teacher-forced on its prompts and served tokens."""
    import functools

    import torch

    from etude_tpu_torch.models.generate_stream import (compact_window, init_stream_cache,
                                                        stream_chunk)
    from h100_bench.drivers.catalog import x_bucket
    from h100_bench.reference.decoder import ATTRIBUTE_KEYS, ATTRIBUTES, SOURCE, TARGET

    x_bars, bins, served = rec["streams"][s], rec["bins"][s], rec["served"][s]
    n_ctx, cap = rules["n_ctx"], rules["cap"]
    bar_cap = cfg["max_bar_token_limit"]
    X = x_bucket(max(len(b) for st in rec["streams"] for b in st), cfg["x_len_buckets"], cap)
    hist = max(cap, 4 * n_ctx)
    n_bars_bucket = -(-len(x_bars) // 32) * 32
    max_hi = (4 * n_ctx + n_bars_bucket * (X + 1 + bar_cap)) // 4096 + 2
    cache = init_stream_cache(model_config, 1, hist + X + 1 + bar_cap, device=device, quant=True)
    weights = [layer.cast(torch.bfloat16) for layer in model.layers]
    chunk = functools.partial(stream_chunk, model, cache, max_hi=max_hi, layer_weights=weights)

    def t(values):          # [1, S]
        return torch.tensor([values], dtype=torch.long, device=device)

    def one(value):         # [1]
        return torch.tensor([value], dtype=torch.long, device=device)

    def attrs(bar_bins, n):
        return {a: t([bar_bins[ATTRIBUTE_KEYS[a]]] * n) for a in ATTRIBUTES}

    bos = ids["bar_bos"]
    chunk(t([bos, ids["bar_eos"]] * (2 * n_ctx)), t([SOURCE, SOURCE, TARGET, TARGET] * n_ctx),
          {a: t([1] * 4 * n_ctx) for a in ATTRIBUTES}, start_pos=one(0), win_start=one(0),
          slot_offset=0)
    pair_starts = [4 * j for j in range(n_ctx + 1)]
    cur = 4 * n_ctx
    out = []
    for x, bar_bins, y in zip(x_bars, bins, served):
        x = x[-cap:]
        x_end = cur + len(x)
        start = pair_starts[0]
        if x_end - start > cap - 1:
            start = x_end - rules["keep"]
        compact_window(cache, one(start), one(cur), hist)
        padded = list(x) + [ids["pad"]] * (X - len(x))
        chunk(t(padded), t([SOURCE] * X), attrs(bar_bins, X), start_pos=one(cur),
              win_start=one(start), slot_offset=hist, valid_len=one(len(x)))
        toks = [bos] + list(y)
        logits, _ = chunk(t(toks), t([TARGET] * len(toks)), attrs(bar_bins, len(toks)),
                          start_pos=one(x_end), win_start=one(start), slot_offset=hist + X)
        out.append(logits[0, :len(y)].argmax(-1).tolist())
        cur = x_end + 1 + len(y)
        pair_starts = pair_starts[1:] + [cur]
    return out


def decoder_readings(driver, records, control: bool) -> dict:
    """The widest served-token gap of the cell's own check, and with
    `control` the same reading of the int8 path's and the float8
    reference's first tokens, on the same sample of streams."""
    import numpy as np
    import torch

    from h100_bench.drivers.catalog import seed_sequence
    from h100_bench.reference import decoder as ref_mod
    from h100_bench.reference.precision import exact_float32, fp8_round

    readings = {c.name: c.value for c in driver.check(records)}
    readings["program"] = driver.diagnostics
    if not control:
        return readings
    from etude_tpu_torch.utils.model_loader import load_etude_decoder

    ctx, cfg = driver.ctx, driver.cfg
    pool = [(r, s) for r, rec in enumerate(records) for s in range(rec["attempted"])]
    served_len = [sum(len(y) for y in records[r]["served"][s]) for r, s in pool]
    longest = int(np.argmax(served_len))
    rng = np.random.default_rng(seed_sequence(ctx.seed, 2))
    others = [i for i in range(len(pool)) if i != longest]
    k = min(driver.traffic["check"]["sample_streams"] - 1, len(others))
    picked = [longest] + [others[i] for i in rng.choice(len(others), k, replace=False)]

    model, model_config = load_etude_decoder(ctx.root / cfg["program_config"],
                                             ctx.root / cfg["weights_dir"], device=ctx.device)
    params = ctx.root / cfg["weights_dir"] / "params.npz"
    exact = ref_mod.Decoder(params, cfg, ctx.device)
    low = ref_mod.Decoder(params, cfg, ctx.device, cast=fp8_round)
    int8_gaps, fp8_gaps = [], []
    with exact_float32(), torch.no_grad():
        for i in picked:
            r, s = pool[i]
            rec = records[r]
            args = (rec["streams"][s], rec["bins"][s], rec["served"][s], driver.ids,
                    driver.rules)
            ref_logits = exact.stream_logits(*args)
            int8 = _int8_tokens(model, model_config, rec, s, driver.ids, driver.rules, cfg,
                                ctx.device)
            int8_gaps.append(ref_mod.served_gaps(ref_logits, int8))
            fp8 = [lg.argmax(-1).tolist() for lg in low.stream_logits(*args)]
            fp8_gaps.append(ref_mod.served_gaps(ref_logits, fp8))

    def stats(gaps):
        g = np.concatenate(gaps)
        return {"max": float(g.max()), "q999": float(np.quantile(g, 0.999)),
                "mean": float(g.mean()), "tokens": int(len(g))}

    readings["control_int8"] = stats(int8_gaps)
    readings["control_fp8_reference"] = stats(fp8_gaps)
    return readings


def analysis_readings(driver, records, control: bool) -> dict:
    """The cell's own numbers, and with `control` the float8 reference's
    maps and activations against the float32 reference's."""
    import numpy as np
    import scipy.signal
    import torch

    from h100_bench.reference import analysis as ref
    from h100_bench.reference.precision import exact_float32, fp8_round

    songs = sorted({r["song"] for r in records})
    pcm = {s: driver.songs[s]["pcm"] for s in songs}
    readings = {c.name: c.value for c in driver.check(records)}
    readings["program"] = driver.diagnostics
    if not control:
        return readings
    from h100_bench.drivers.song_analysis import abs_diff, diff_stats

    cfg, dev, root = driver.cfg, driver.ctx.device, driver.ctx.root
    hft_s, sep_s, beat_s = ref.settings(cfg)
    maps_diffs, act_diffs = [], []
    with exact_float32(), torch.no_grad():
        for s in songs:
            wave = pcm[s].astype(np.float64) / 32768.0
            wave16 = scipy.signal.resample_poly(wave, 160, 441)
            got = {}
            for name, cast in (("exact", None), ("fp8", fp8_round)):
                kw = {} if cast is None else {"cast": cast}
                p = ref.load_params(root / cfg["paths"]["extractor_model"] / "params.npz", dev)
                maps = ref.hft_maps(wave16, p, hft_s, dev, **kw)
                p = ref.load_params(root / cfg["paths"]["separator_model"] / "params.npz", dev)
                feats = ref.separation_features(wave, p, sep_s, dev, **kw)
                p = ref.load_params(root / cfg["paths"]["beat_detector_model"] / "params.npz",
                                    dev)
                got[name] = (maps, ref.beat_activations(feats, p, beat_s, **kw))
            for head in ("onset", "offset", "mpe"):
                maps_diffs.append(abs_diff(got["fp8"][0][head], got["exact"][0][head]))
            act_diffs.append(abs_diff(got["fp8"][1], got["exact"][1]))
    readings["control_fp8"] = {"hft_maps": diff_stats(maps_diffs),
                               "beat_act": diff_stats(act_diffs)}
    return readings


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--control-seeds", default="", help="comma-separated")
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--json", required=True)
    args = parser.parse_args(argv)

    import torch

    from h100_bench import harness

    manifest = harness.load_manifest()
    cell, config, traffic = harness.cell_entries(manifest, args.workload)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    readings_of = {"catalog": decoder_readings, "song_analysis": analysis_readings}
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        ctx = harness.Context(root=harness.ROOT, workload=cell, config=config,
                              traffic=traffic, seed=seed, device=device)
        driver = harness.load_module(harness.BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                                     f"h100_bench_driver_{traffic['driver']}").Driver(ctx)
        driver.setup()
        records, window_s, _, _ = harness.run_window(driver, args.seconds, "none", None)
        driver.release()
        torch.cuda.empty_cache()
        readings = readings_of[traffic["driver"]](driver, records, seed in controls)
        row = {"seed": seed, "requests": len(records),
               "failed": sum(r["failed"] for r in records), "window_s": window_s,
               "readings": readings, "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        out.append(row)
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
        del driver, records
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
