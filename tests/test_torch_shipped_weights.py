"""The shipped weights in the port: the params-only exports of the four
committed checkpoints (`checkpoints_torch/`, written by the repository's
`export_weights.py`) against the orbax trees they were made from, the
port's default paths reading them, the port's forwards from them against
the JAX package's from the orbax trees, and `--input` with the default
paths and no random-weight flag against the JAX pipeline with its
defaults, on the CPU.

Limits: the trees bit for bit (f16 as stored; f32 after the loaders'
promotion); the forwards at the per-module tests' f32 limits (decoder
logits 1e-4, tests/test_torch_decoder.py; Beat-Transformer activations
1e-5 relative, tests/test_torch_beat_transformer.py as tests/test_beat.py;
separation features 1e-2 dB, tests/test_torch_separation.py; hFT heads
1e-4, velocity logits 1e-3, tests/test_torch_amt.py); `--input` as
tests/test_torch_pipeline.py holds it (tempo.json equal, extract.json's
notes and velocities equal with times within 1e-4 s) plus greedy bar 0
token for token up to a near-tie: both packages decode in bf16, so where
bar 0's tokens differ, the JAX logits' top-2 margin at the first difference
must be under TIE_MARGIN (tests/test_torch_generate_stream.py, replayed
there). The extractor runs 64-frame segments two at a time and bars are
capped at 64 tokens on both sides, to keep the JAX run short on the CPU.
"""

import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import etude_tpu.models.generate_stream as jax_stream
import export_weights
import test_torch_generate_stream
from etude_tpu.config import load_config as jax_load_config
from etude_tpu.config.schema import BeatDetectorConfig as JaxBeatDetectorConfig
from etude_tpu.data import beat_detector as jax_bd
from etude_tpu.data import separation as jax_sep
from etude_tpu.models import amt as jamt
from etude_tpu.utils.model_loader import load_etude_decoder as jax_load_decoder
from etude_tpu_torch import infer
from etude_tpu_torch.config import BeatDetectorConfig, ExtractorConfig, PathConfig, load_config
from etude_tpu_torch.data import separation as sep
from etude_tpu_torch.data.beat_detector import BeatDetector
from etude_tpu_torch.data.extractor import AMTAPC_Extractor
from etude_tpu_torch.models import generate_stream
from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils.training import flatten_tree
from infer import InferencePipeline as JaxInferencePipeline
from test_torch_amt import _assert_heads_close, jax_f32_extractor  # noqa: F401  (fixture)
from test_torch_beat_transformer import _close, _features, jax_f32_detector  # noqa: F401
from test_torch_decoder import _jax_logits, _torch_logits
from test_torch_extract import TIME_ATOL
from test_torch_pipeline import ATTRS, _song
from test_torch_separation import DB_ATOL, _tone_wav, jax_f32_separator  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
EXPORTS = REPO / "checkpoints_torch"
MODELS = export_weights.MODELS
# PathConfig's field and the loader's name of each model.
FIELDS = {"decoder": ("decoder_model", "decoder"),
          "separator": ("separator_model", "separator"),
          "beat_detector": ("beat_detector_model", "beat model"),
          "extractor": ("extractor_model", "extractor")}


@pytest.fixture(scope="module")
def orbax_trees():
    """Each committed tree as stored (f16), flattened, read by orbax."""
    return {m: export_weights.orbax_tree(m) for m in MODELS}


@pytest.mark.parametrize("model", MODELS)
def test_export_equals_the_orbax_tree_bit_for_bit(model, orbax_trees):
    want = orbax_trees[model]
    with np.load(EXPORTS / model / "params.npz", allow_pickle=False) as f:
        got = {k: f[k] for k in f.files}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert value.dtype == np.float16, key
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        assert got[key].tobytes() == value.tobytes(), key


@pytest.mark.parametrize("model", MODELS)
def test_manifest_records_each_export(model, orbax_trees):
    entry = json.loads((EXPORTS / "manifest.json").read_text())["models"][model]
    path = EXPORTS / model / "params.npz"
    assert entry["sha256"] == hashlib.sha256(path.read_bytes()).hexdigest()
    assert entry["bytes"] == path.stat().st_size
    assert entry["source"] == f"checkpoints/{model}/latest.ckpt"
    assert entry["leaves"] == len(orbax_trees[model])
    assert entry["parameters"] == sum(v.size for v in orbax_trees[model].values())


def test_a_second_export_rewrites_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(export_weights, "REPO", tmp_path)
    first = export_weights.export(tmp_path / "out", models=("extractor",))
    files = [tmp_path / "out" / "extractor" / "params.npz", tmp_path / "out" / "manifest.json"]
    stamps = [f.stat().st_mtime_ns for f in files]
    assert export_weights.export(tmp_path / "out", models=("extractor",)) == first
    assert [f.stat().st_mtime_ns for f in files] == stamps
    with pytest.raises(ValueError, match="checkpoints/"):
        export_weights.export(tmp_path / "checkpoints" / "x", models=())


@pytest.mark.parametrize("model", MODELS)
def test_the_default_paths_load_the_exports(model, orbax_trees, monkeypatch):
    monkeypatch.chdir(REPO)
    field, what = FIELDS[model]
    path = getattr(PathConfig(), field)
    assert Path(path).resolve() == EXPORTS / model
    tree = model_loader.load_params(what, path, init_params=None)
    got = flatten_tree(tree)
    assert sorted(got) == sorted(orbax_trees[model])
    for key, value in orbax_trees[model].items():
        assert got[key].dtype == np.float32, key
        np.testing.assert_array_equal(got[key], value.astype(np.float32), err_msg=key)


@pytest.mark.parametrize("model", MODELS)
def test_an_orbax_path_still_raises(model):
    _, what = FIELDS[model]
    with pytest.raises(RuntimeError, match="orbax.*export_weights.py"):
        model_loader.load_params(what, REPO / "checkpoints" / model / "latest.ckpt",
                                 init_params=lambda seed: {}, allow_random_weights=True)


def test_decoder_logits_from_the_export_match_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    paths = PathConfig()
    model, config = model_loader.load_etude_decoder(paths.decoder_config, paths.decoder_model,
                                                    device="cpu")
    params, jconfig = jax_load_decoder(REPO / paths.decoder_config,
                                       REPO / "checkpoints/decoder/latest.ckpt")
    src = np.load(REPO / "dataset_distill/tokenized/0002/0002_src.npy")[:64]
    tgt = np.load(REPO / "dataset_distill/tokenized/0002/0002_tgt.npy")[:64]
    ids = np.concatenate([src, tgt])[None].astype(np.int64)
    cls = np.concatenate([np.full(64, 1), np.full(64, 2)])[None]
    attrs = {n: np.full(ids.shape, i % 3) for i, n in enumerate(ATTRIBUTE_ORDER)}
    ref = _jax_logits(params, jconfig, ids, cls, attrs)
    got = _torch_logits(model, ids, cls, attrs)
    assert np.abs(ref).max() > 1.0  # trained logits
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_beat_activations_from_the_export_match_jax(monkeypatch, jax_f32_detector):  # noqa: F811
    monkeypatch.chdir(REPO)
    paths = PathConfig()
    feats = _features(96, seed=4)
    want = jax_bd.BeatDetector(JaxBeatDetectorConfig(),
                               model_path=REPO / "checkpoints/beat_detector/latest.ckpt"
                               ).activations(feats)
    got = BeatDetector(BeatDetectorConfig(), model_path=paths.beat_detector_model,
                       device="cpu").activations(feats)
    assert got.shape == np.asarray(want).shape
    _close(got, np.asarray(want))


def test_separator_features_from_the_export_match_jax(tmp_path, monkeypatch,
                                                      jax_f32_separator):  # noqa: F811
    monkeypatch.chdir(REPO)
    path = tmp_path / "mix.wav"
    _tone_wav(path)
    want = jax_sep.SourceSeparator(model_path=REPO / "checkpoints/separator/latest.ckpt"
                                   ).separate_features(path)
    got = sep.SourceSeparator(model_path=PathConfig().separator_model, device="cpu"
                              ).separate_features(path)
    assert got.shape == want.shape == (5, 1 + 44100 // 1024, 128)
    np.testing.assert_allclose(got, want, atol=DB_ATOL, rtol=0)


def test_hft_logits_from_the_export_match_jax(monkeypatch):
    monkeypatch.chdir(REPO)
    n_frame = 32
    config = ExtractorConfig()
    config.input.num_frame = n_frame
    extractor = AMTAPC_Extractor(config, model_path=PathConfig().extractor_model, device="cpu")
    abstract = jax.eval_shape(lambda: jamt.init_params(jamt.AMTConfig(), seed=0))
    from etude_tpu.utils.training import load_params_only

    params = jax.tree.map(np.asarray, load_params_only(
        REPO / "checkpoints/extractor/latest.ckpt", abstract))
    spec = np.random.default_rng(5).normal(-6.0, 3.0, size=(2, 256, n_frame + 64)
                                           ).astype(np.float32)
    want = jamt.forward(params, jamt.AMTConfig(n_frame=n_frame), jnp.asarray(spec),
                        compute_dtype=jnp.float32)
    with torch.inference_mode():
        got = extractor.model(torch.from_numpy(spec), torch.float32)
    _assert_heads_close(got, want)


def _record(monkeypatch, cls, seen):
    """Wrap `cls.generate` to keep its condition bars and its output."""
    generate = cls.generate

    def recorded(self, model, bars, attrs, *args, **kwargs):
        out = generate(self, model, bars, attrs, *args, **kwargs)
        seen.update(engine=self, params=model, attrs=attrs,
                    condition=[list(map(int, b)) for b in bars],
                    bars=[list(map(int, b)) for b in out])
        return out

    monkeypatch.setattr(cls, "generate", recorded)


def test_input_from_the_default_paths_matches_jax(tmp_path, monkeypatch,
                                                  jax_f32_extractor, jax_f32_separator,  # noqa: F811
                                                  jax_f32_detector):  # noqa: F811
    monkeypatch.chdir(REPO)
    wav = _song(tmp_path / "song.wav")

    def settings(side):
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps({
            "paths": {"infer_output_dir": str(tmp_path / side)},
            "extractor": {"input": {"num_frame": 64}, "infer": {"segment_batch": 2}},
            "decoder": {"max_bar_token_limit": 64},
        }))
        return path

    jax_seen, port_seen = {}, {}
    _record(monkeypatch, jax_stream.StreamingGenerationEngine, jax_seen)
    _record(monkeypatch, generate_stream.StreamingGenerationEngine, port_seen)
    jax_cfg = jax_load_config(str(settings("jax")))
    assert Path(jax_cfg.paths.decoder_model) == Path("checkpoints/decoder/latest.ckpt")
    JaxInferencePipeline(jax_cfg).run(str(wav), ATTRS)
    port_cfg = load_config(settings("port"))
    assert Path(port_cfg.paths.decoder_model) == Path("checkpoints_torch/decoder")
    assert infer.main(["--config", str(settings("port")), "--input", str(wav),
                       "--device", "cpu"]) == 0

    got = {n: json.loads((tmp_path / "port" / "temp" / n).read_text())
           for n in ("extract.json", "tempo.json")}
    want = {n: json.loads((tmp_path / "jax" / "temp" / n).read_text())
            for n in ("extract.json", "tempo.json")}
    assert want["extract.json"] and want["tempo.json"], "the song should give notes and a grid"
    assert got["tempo.json"] == want["tempo.json"]
    assert len(got["extract.json"]) == len(want["extract.json"])
    for a, b in zip(got["extract.json"], want["extract.json"]):
        assert (a["pitch"], a["velocity"]) == (b["pitch"], b["velocity"])
        assert a["onset"] == pytest.approx(b["onset"], abs=TIME_ATOL)
        assert a["offset"] == pytest.approx(b["offset"], abs=TIME_ATOL)
    assert port_seen["condition"] == jax_seen["condition"]
    ours, ref = port_seen["bars"][0], jax_seen["bars"][0]
    assert len(ref) > 1, "the shipped decoder should play bar 0"
    assert (tmp_path / "port" / "output.mid").exists()
    if ours == ref:
        return
    step = next((t for t, (a, b) in enumerate(zip(ours[1:], ref[1:])) if a != b),
                min(len(ours), len(ref)) - 1)
    engine = port_seen["engine"]
    monkeypatch.setattr(test_torch_generate_stream, "BOS", engine.bar_bos_id)
    monkeypatch.setattr(test_torch_generate_stream, "EOS", engine.bar_eos_id)
    replay = dict(test_torch_generate_stream._jax_replay(
        jax_seen["engine"].config, jax_seen["params"], engine, jax_seen["condition"],
        jax_seen["attrs"], [ref]))
    margin = {t: float(np.diff(np.sort(replay[(0, t)])[-2:])[0]) for t in range(len(ref) - 1)}
    # The replay runs step by step where the JAX engine runs the song as one
    # program, so the two part at near-ties too (a top-2 margin of 0.021 on
    # this song): its argmax is the JAX token wherever the margin is more
    # than twice TIE_MARGIN.
    tie = test_torch_generate_stream.TIE_MARGIN
    assert all(int(np.argmax(replay[(0, t)])) == ref[t + 1] or margin[t] < 2 * tie
               for t in margin)
    assert margin[step] < tie, (
        f"bar 0 step {step}: greedy divergence at a margin of {margin[step]:.3g}")
