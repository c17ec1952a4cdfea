"""The port's checkpoint format (etude_tpu_torch/utils/training.py), resume
and export, on the CPU. Everything here is exact: a checkpoint stores f32
and int32 values as they are, and the CPU step is deterministic."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from etude_tpu_torch import train
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.parallel.train_step import (
    init_train_state, make_optimizer, make_train_step, reshape_for_accum,
)
from etude_tpu_torch.utils import model_loader
from etude_tpu_torch.utils.training import (
    OPT_STATE_FILE, PARAMS_FILE, load_checkpoint, load_params_only, save_checkpoint,
    save_params_only,
)
from etude_tpu_torch.weights import decoder_from_jax, decoder_to_jax, init_decoder_params_np
from test_torch_dataset import CORPUS, copy_songs
from test_torch_train_step import TINY, make_batch

PUBLISHED = CORPUS.parent / "checkpoints" / "decoder" / "etude_decoder_config.json"


def fresh_state(seed=0, lr=1e-3):
    config = EtudeDecoderConfig(**TINY)
    tx, _ = make_optimizer(learning_rate=lr, warmup_steps=2, total_steps=10)
    state = init_train_state(decoder_from_jax(init_decoder_params_np(config, seed), config), tx)
    return state, make_train_step(config, tx, compute_dtype=torch.float32), config


def tensors(state):
    return ([p.detach().clone() for p in state.params()] + state.opt_state.mu
            + state.opt_state.nu + [state.opt_state.count, state.step, state.skipped])


def assert_states_equal(a, b):
    for x, y in zip(tensors(a), tensors(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def batches(n):
    rng = np.random.default_rng(11)
    return [{k: torch.from_numpy(v) for k, v in reshape_for_accum(make_batch(rng), 2).items()}
            for _ in range(n)]


@pytest.mark.parametrize("which", ["tiny", "published"])
def test_decoder_to_jax_inverts_decoder_from_jax(which):
    config = (EtudeDecoderConfig(**TINY) if which == "tiny"
              else EtudeDecoderConfig.from_json_file(PUBLISHED))
    params = init_decoder_params_np(config, seed=5)
    back = decoder_to_jax(decoder_from_jax(params, config))
    ref_leaves, ref_def = jax.tree.flatten(params)
    leaves, tree_def = jax.tree.flatten(back)
    assert tree_def == ref_def
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_save_then_load_round_trips_exactly(tmp_path):
    state, step, config = fresh_state()
    for b in batches(3):
        step(state, b)
    save_checkpoint(tmp_path, state, epoch=3, global_step=3, model_config=config,
                    is_save_epoch=True)
    assert sorted(p.name for p in (tmp_path / "latest").iterdir()) == [OPT_STATE_FILE,
                                                                       PARAMS_FILE]
    assert (tmp_path / "epoch_0003" / PARAMS_FILE).exists()
    meta = json.loads((tmp_path / "metadata.json").read_text())
    assert set(meta) == {"epoch", "global_step", "model_config"}
    assert meta["epoch"] == 3 and meta["global_step"] == 3
    assert EtudeDecoderConfig.from_json_file(tmp_path / "etude_decoder_config.json") == config

    restored, meta2 = load_checkpoint(tmp_path, fresh_state(seed=9)[0])
    assert meta2 == meta
    assert_states_equal(restored, state)
    # The opt-state file holds the Adam moments as JAX-shaped trees.
    with np.load(tmp_path / "latest" / OPT_STATE_FILE) as f:
        assert f["mu/layers/qkv/w"].shape == (2, 32, 96)
        assert f["count"].dtype == np.int32 and int(f["step"]) == 3


def test_four_steps_equal_two_save_resume_two(tmp_path):
    data = batches(4)
    straight, step, config = fresh_state()
    for b in data:
        step(straight, b)

    first, step1, _ = fresh_state()
    for b in data[:2]:
        step1(first, b)
    save_checkpoint(tmp_path, first, epoch=1, global_step=2, model_config=config)
    resumed, step2, _ = fresh_state(seed=4)
    load_checkpoint(tmp_path, resumed)
    for b in data[2:]:
        step2(resumed, b)
    assert_states_equal(resumed, straight)


def test_recovers_latest_old_and_copies_epochs(tmp_path):
    state, step, config = fresh_state()
    step(state, batches(1)[0])
    for epoch in (1, 2):
        save_checkpoint(tmp_path, state, epoch=epoch, global_step=epoch,
                        model_config=config, is_save_epoch=epoch == 2)
    assert not (tmp_path / "epoch_0001").exists()
    assert (tmp_path / "epoch_0002" / OPT_STATE_FILE).exists()
    assert not (tmp_path / ".latest.tmp").exists() and not (tmp_path / ".latest.old").exists()
    # A kill between the two renames of a save leaves only .latest.old.
    (tmp_path / "latest").rename(tmp_path / ".latest.old")
    restored, _ = load_checkpoint(tmp_path, fresh_state(seed=3)[0])
    assert (tmp_path / "latest").exists()
    assert_states_equal(restored, state)
    shutil.rmtree(tmp_path / "latest")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path, state)


def test_params_only_export_loads_through_the_decoder_loader(tmp_path):
    state, step, config = fresh_state()
    step(state, batches(1)[0])
    step(state, batches(2)[1])
    save_params_only(tmp_path / "model", decoder_to_jax(state.model), config)
    assert [p.name for p in (tmp_path / "model").iterdir()] == [PARAMS_FILE]
    model, loaded_config = model_loader.load_etude_decoder(
        tmp_path / "etude_decoder_config.json", tmp_path / "model", device="cpu")
    assert loaded_config == config
    for (name, a), (_, b) in zip(model.named_parameters(), state.model.named_parameters()):
        assert torch.equal(a, b), name
    # The same directory through load_params (any model's weight rule).
    tree = model_loader.load_params("decoder", tmp_path / "model", lambda s: None)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(load_params_only(tmp_path / "model"))):
        np.testing.assert_array_equal(a, b)


def one_song_settings(tmp_path, **train_extra):
    """Tiny widths on one corpus song at 128-token chunks: 2 steps of 192
    rows per epoch."""
    data = copy_songs(tmp_path / "tokenized", ("0001",))
    settings = tmp_path / "tiny.json"
    settings.write_text(json.dumps({
        "paths": {"dataset_vocab": str(CORPUS / "vocab.json"), "tokenized_dir": str(data),
                  "train_output_dir": str(tmp_path / "out")},
        "env": {"compute_dtype": "float32"},
        "decoder": {k: v for k, v in TINY.items() if k != "vocab_size"}
        | {"max_position_embeddings": 128},
        "train": {"batch_size": 96, "gradient_accumulation_steps": 2, "max_seq_len": 128,
                  "num_epochs": 2, "warmup_epochs": 0.5, "save_every_n_epochs": 1,
                  "learning_rate": 1e-3} | train_extra,
    }))
    return ["--config", str(settings), "--device", "cpu"]


def test_cli_resume_across_an_epoch_equals_a_straight_run(tmp_path):
    """`--max-steps` at an epoch's end, then `--resume`: the resumed run
    sees the straight run's second epoch and ends bit-equal."""
    base = one_song_settings(tmp_path)
    straight = train.run(base + ["--run-id", "straight"])
    assert straight is not None and len(straight.losses) == 4   # 2 epochs x 2 steps
    half = train.run(base + ["--run-id", "resumed", "--max-steps", "2"])
    resumed = train.run(base + ["--run-id", "resumed", "--resume",
                                str(tmp_path / "out" / "resumed")])
    assert half.losses + resumed.losses == straight.losses
    lines = [json.loads(x) for x in
             (tmp_path / "out" / "resumed" / "metrics.jsonl").read_text().splitlines()]
    ref = [json.loads(x) for x in
           (tmp_path / "out" / "straight" / "metrics.jsonl").read_text().splitlines()]
    assert [(x["epoch"], x["step"], x["loss"], x["lr"]) for x in lines] == \
        [(x["epoch"], x["step"], x["loss"], x["lr"]) for x in ref]
    a = load_params_only(tmp_path / "out" / "straight" / "model")
    b = load_params_only(tmp_path / "out" / "resumed" / "model")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_cli_init_from_starts_from_an_export(tmp_path):
    """`init_from` loads a params-only export with a fresh optimizer: the
    new run's first update runs at rate 0, so after one step its export
    equals the one it started from, bit for bit."""
    first = train.run(one_song_settings(tmp_path) + ["--run-id", "a", "--max-steps", "2"])
    source = tmp_path / "out" / "a" / "model"
    (tmp_path / "warm").mkdir()
    warm = train.run(one_song_settings(tmp_path / "warm", init_from=str(source))
                     + ["--run-id", "b", "--max-steps", "1"])
    assert first is not None and warm is not None
    a = load_params_only(source)
    b = load_params_only(tmp_path / "warm" / "out" / "b" / "model")
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        np.testing.assert_array_equal(x, y)
    assert warm.losses[0] < first.losses[0]


def test_multi_device_settings_raise(tmp_path, monkeypatch):
    """Multi-GPU settings run one rank per card, so where the cards are
    missing they raise rather than train on fewer (here, a machine that
    shows one card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    settings = tmp_path / "fsdp.json"
    settings.write_text(json.dumps({"mesh": {"fsdp": True, "data_parallel": 2}}))
    with pytest.raises(RuntimeError, match="ask for 2 ranks, one per card, but 1 card"):
        train.main(["--config", str(settings)])
    settings.write_text(json.dumps({"mesh": {"data_parallel": 4}}))
    with pytest.raises(RuntimeError, match="ask for 4 ranks"):
        train.main(["--config", str(settings)])
