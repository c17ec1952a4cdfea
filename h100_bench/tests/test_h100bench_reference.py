"""The plain references against the port at a small size on the CPU; the
precision controls coming out not correct; and each fault that a cell can
have, planted under the timed path, turning `correct` false.

The runs skip the harness's look for a card and drive the rest of a run
(set-up, requests, release, the check) on the CPU, with the shipped
weights, at sizes a test run holds: a few decoder streams with short bars,
one short song through Extract and Structuralize.
"""

import json

import numpy as np
import pytest
import torch

from h100_bench import control, harness

ROOT = harness.ROOT


def _load(kind, name):
    return json.loads((harness.BENCH_DIR / kind / f"{name}.json").read_text())


def _driver(name, config, traffic, seed):
    ctx = harness.Context(root=ROOT, workload={"name": "test"}, config=config,
                          traffic=traffic, seed=seed, device=torch.device("cpu"))
    return harness.load_module(harness.BENCH_DIR / "drivers" / f"{name}.py",
                               f"test_reference_{name}").Driver(ctx)


def _correct(driver, records):
    checks = driver.check(records)
    return all(r["failed"] == 0 for r in records) and all(c.ok for c in checks), checks


# ---- the decoder ----------------------------------------------------------------
@pytest.fixture(scope="module")
def decoder():
    torch.manual_seed(0)
    cfg = _load("configs", "etude_decoder")
    cfg["max_bar_token_limit"] = 48
    traffic = _load("traffic", "catalog_b864")
    traffic.update(songs_per_request=2, bars_per_section=3,
                   styles={"polyphony_bin": [0, 2], "rhythm_intensity_bin": [0, 2],
                           "sustain_bin": [1], "pitch_overlap_bin": [2]})
    traffic["check"] = dict(traffic["check"], sample_streams=8)
    d = _driver("catalog", cfg, traffic, 2147483911)
    d.setup()
    records = [d.request(0)]
    return d, records


def test_decoder_reference_agrees_with_the_port(decoder):
    d, records = decoder
    ok, checks = _correct(d, records)
    assert ok, [(c.name, c.value, c.limit) for c in checks]
    assert records[0]["cover_tokens"] > 100 and d.diagnostics["tokens"] > 100


def test_decoder_control_is_not_correct(decoder):
    """The engine's int8 path, teacher-forced on the same prompts and
    tokens, reads past the limit."""
    d, records = decoder
    readings = control.decoder_readings(d, records, control=True)
    limit = d.traffic["check"]["served_gap_q999"]
    assert readings["control_int8"]["q999"] > limit, readings


def _decoder_fault(monkeypatch, decoder, target, replacement):
    from etude_tpu_torch.models import generate_stream

    d, _ = decoder
    monkeypatch.setattr(generate_stream, target, replacement(getattr(generate_stream, target)))
    records = [d.request(1)]
    monkeypatch.undo()
    return _correct(d, records)[0]


def test_decoder_fault_token_altered(monkeypatch, decoder):
    calls = {"n": 0}

    def altered(sample):
        def wrapper(logits, *args, **kwargs):
            tok = sample(logits, *args, **kwargs)
            calls["n"] += 1
            if calls["n"] % 5 == 0:             # every fifth step, every stream
                tok = (tok + 17) % logits.shape[-1]
            return tok
        return wrapper

    assert not _decoder_fault(monkeypatch, decoder, "sample_token", altered)


def test_decoder_fault_state_unchanged(monkeypatch, decoder):
    """The cache's window is never moved on between bars."""
    def unchanged(compact):
        return lambda cache, *args, **kwargs: cache

    assert not _decoder_fault(monkeypatch, decoder, "compact_window", unchanged)


def test_decoder_fault_half_the_batch(monkeypatch, decoder):
    """Only the first half of the streams is decoded; the rest copy it."""
    def half(generate):
        def wrapper(model, x_tokens, x_lens, x_attrs, *args, **kwargs):
            B = x_tokens.shape[0] // 2
            y, counts = generate(model, x_tokens[:B], x_lens[:B],
                                 {k: v[:B] for k, v in x_attrs.items()}, *args, **kwargs)
            reps = -(-x_tokens.shape[0] // B)
            return (y.repeat(reps, 1, 1)[:x_tokens.shape[0]],
                    counts.repeat(reps, 1)[:x_tokens.shape[0]])
        return wrapper

    assert not _decoder_fault(monkeypatch, decoder, "generate_song_stream", half)


# ---- the analysis models ---------------------------------------------------------------
@pytest.fixture(scope="module")
def analysis():
    """One 9 s song (two hFT segments in one group of two), the reference
    computed once per input and reused by every check of this module."""
    from h100_bench.reference import analysis as ref

    cache = {}

    def memo(fn):
        def wrapper(*args, **kwargs):
            arrays = [a for a in args if isinstance(a, (np.ndarray, torch.Tensor))]
            key = (fn.__name__, tuple(np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                                      .tobytes().__hash__() for a in arrays),
                   kwargs.get("cast") is not None)
            if key not in cache:
                cache[key] = fn(*args, **kwargs)
            return cache[key]
        return wrapper

    saved = {n: getattr(ref, n) for n in ("hft_maps", "separation_features", "beat_activations")}
    for n, fn in saved.items():
        setattr(ref, n, memo(fn))
    cfg = _load("configs", "etude_analysis")
    cfg["program_settings"] = {"extractor": {"infer": {"segment_batch": 2}}}
    traffic = _load("traffic", "song_240s")
    traffic.update(songs=1, seconds_per_song=9.0)
    d = _driver("song_analysis", cfg, traffic, 2147483921)
    d.setup()
    records = [d.request(0)]
    yield d, records
    d.release()
    for n, fn in saved.items():
        setattr(ref, n, fn)


def test_analysis_reference_agrees_with_the_port(analysis):
    d, records = analysis
    ok, checks = _correct(d, records)
    assert ok, [(c.name, c.value, c.limit) for c in checks]
    # on the CPU the port computes in float32: the two agree to rounding
    assert d.diagnostics["hft_maps"]["max"] < 1e-3
    assert d.diagnostics["beat_act"]["max"] < 2e-3       # the port's f16 hand-off
    assert records[0]["notes"] and records[0]["beats"]["beat_pred"]


def test_analysis_control_is_not_correct(analysis):
    """The reference in float8 in the port's place reads past both limits."""
    d, records = analysis
    readings = control.analysis_readings(d, records, control=True)
    limits = d.traffic["check"]
    assert readings["control_fp8"]["hft_maps"]["q999"] > limits["hft_maps_q999_abs_diff"]
    assert readings["control_fp8"]["beat_act"]["q999"] > limits["beat_act_q999_abs_diff"]


def _analysis_fault(monkeypatch, analysis, owner, name, replacement):
    d, _ = analysis
    monkeypatch.setattr(owner, name, replacement(getattr(owner, name)))
    records = [d.request(1)]
    monkeypatch.undo()
    return _correct(d, records)[0]


def test_analysis_fault_note_altered(monkeypatch, analysis):
    from etude_tpu_torch.data import extractor

    def dropped(pick):
        return lambda *a, **k: pick(*a, **k)[1:]

    assert not _analysis_fault(monkeypatch, analysis, extractor, "activations_to_notes", dropped)


def test_analysis_fault_half_the_batch(monkeypatch, analysis):
    """The hFT's group runs on its first segment; the second gets its heads."""
    from etude_tpu_torch.models.amt import HFT

    def half(forward):
        def wrapper(self, spec, *args, **kwargs):
            out = forward(self, spec[:spec.shape[0] // 2], *args, **kwargs)
            return {k: v.repeat(2, *[1] * (v.dim() - 1)) for k, v in out.items()}
        return wrapper

    assert not _analysis_fault(monkeypatch, analysis, HFT, "forward", half)


def test_analysis_fault_activation_altered(monkeypatch, analysis):
    from etude_tpu_torch.models.beat_transformer import BeatTransformer

    def shifted(forward):
        def wrapper(*args, **kwargs):
            act, tempo = forward(*args, **kwargs)
            return act + 1.0, tempo
        return wrapper

    assert not _analysis_fault(monkeypatch, analysis, BeatTransformer, "forward", shifted)


def test_analysis_fault_beat_altered(monkeypatch, analysis):
    from etude_tpu_torch.ops.dbn import DBNBeatTracker

    def moved(call):
        def wrapper(self, activations):
            beats = call(self, activations)
            return beats + 1.0 / self.fps if len(beats) else beats
        return wrapper

    assert not _analysis_fault(monkeypatch, analysis, DBNBeatTracker, "__call__", moved)
