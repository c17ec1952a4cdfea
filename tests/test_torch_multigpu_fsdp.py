"""FSDP, checkpoints across rank counts, the training CLI over two ranks and
`dryrun_multichip`, on gloo ranks (tests/torch_mesh_worker.py).

- FSDP at 2 and 4 ranks against JAX's mesh step (tests/test_torch_multigpu_
  train.py's trajectory and tolerances) and against data parallelism at 2
  ranks (the same numbers: the parameters to PARAM_ATOL, the losses to
  LOSS_RTOL); each rank holds one shard (about 1/N) of the parameters and
  of both moments, and no whole parameter, between steps.
- An FSDP checkpoint restored onto a state from other weights resumes in
  every bit (loss and whole state); a 2-rank FSDP checkpoint restores on
  one device, and a one-device checkpoint on 2 FSDP ranks, to the same
  bits, and the next step's loss agrees to LOSS_RTOL.
- `python -m etude_tpu_torch.train --device cpu` with `mesh.data_parallel:
  2` (replicated and FSDP) against the root train.py with the same
  settings on the conftest's virtual devices: the epoch loss to LOSS_RTOL,
  the exports to PARAM_ATOL.
- `dryrun_multichip(4, device="cpu")`.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.utils.training import load_params_only as jax_load_params_only
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.parallel.train_step import (
    init_train_state, make_optimizer, make_train_step, reshape_for_accum,
)
from etude_tpu_torch.train import make_optimizer as cli_optimizer
from etude_tpu_torch.utils.training import (
    flatten_tree, full_moments, load_checkpoint, load_params_only, save_checkpoint,
)
from etude_tpu_torch.weights import decoder_from_jax, decoder_state_to_jax, init_decoder_params_np
from test_torch_dataset import copy_songs
from test_torch_multigpu_train import (NAN_STEP, OPT, SNAPS, check_metrics, check_snapshot,
                                       host_batches, jax_trajectory, read, spec,
                                       write_batches)
from test_torch_train_cli import settings, yaml_text
from test_torch_train_step import LOSS_RTOL, PARAM_ATOL, TINY, assert_params_close
from torch_mesh_worker import launch
from train import main as jax_train_main

REPO = Path(__file__).resolve().parent.parent
SAVE_AFTER = SNAPS[-1]   # the FSDP worlds checkpoint after their fourth step
UPDATES = {1: 2, 3: 3}   # updates applied by the end of each snapshot's step


def whole(state):
    """A one-device state's parameters and moments as flat JAX trees."""
    config = state.model.config
    mu, nu = full_moments(state)
    flat = {}
    named = dict(state.model.named_parameters())
    for name, tensors in (("params", named), ("mu", mu), ("nu", nu)):
        flat.update(flatten_tree(decoder_state_to_jax(tensors, config), f"{name}/"))
    return flat


def one_device(seed=0):
    config = EtudeDecoderConfig(**TINY)
    tx, _ = make_optimizer(**OPT)
    state = init_train_state(decoder_from_jax(init_decoder_params_np(config, seed), config), tx)
    return state, make_train_step(config, tx, compute_dtype=torch.float32), config


def device_batch(host):
    return {k: torch.from_numpy(v) for k, v in reshape_for_accum(host, 2).items()}


def load_npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_fsdp")
    batches = host_batches(n=5)
    path = write_batches(tmp / "batches.npz", batches)
    # A one-device checkpoint after two steps, for 2 FSDP ranks to resume.
    state, step, config = one_device()
    for host in batches[:2]:
        step(state, device_batch(host))
    save_checkpoint(tmp / "one", state, epoch=0, global_step=2, model_config=config)
    one_saved = whole(state)
    one_next = float(step(state, device_batch(batches[2]))["loss"])
    fsdp = dict(snap=list(SNAPS), nan_step=NAN_STEP, save_after=SAVE_AFTER,
                resume_check=True)
    outs = launch([spec(4, "fsdp", path, ckpt=str(tmp / "ckpt4"), **fsdp),
                   spec(2, "fsdp", path, ckpt=str(tmp / "ckpt2"), **fsdp),
                   spec(2, "dp", write_batches(tmp / "four.npz", batches[:4]),
                        snap=list(SNAPS), nan_step=NAN_STEP),
                   spec(2, "fsdp", write_batches(tmp / "third.npz", batches[2:3]),
                        load=str(tmp / "one"))],
                  tmp)
    return {"fsdp4": outs[0], "fsdp2": outs[1], "dp2": outs[2], "resume2": outs[3],
            "tmp": tmp, "batches": batches, "one_saved": one_saved, "one_next": one_next,
            "jax": jax_trajectory(batches[:4])}


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_steps_match_jax(runs, world):
    out = runs[f"fsdp{world}"]
    ref, snaps = runs["jax"]
    ranks = read(out, world)
    for i in range(4):
        if i != NAN_STEP:   # JAX's NaN is in every row, the port's in one rank's
            check_metrics(ranks[0]["metrics"][i], ref[i])
    assert ranks[0]["metrics"][NAN_STEP]["grads_finite"] == ref[NAN_STEP]["grads_finite"] == 0
    for i in SNAPS:
        check_snapshot(out / f"snap{i}.npz", snaps[i], UPDATES[i])
    for r in ranks:
        assert r["metrics"][:4] == ranks[0]["metrics"][:4]
        assert r["kept"] is True and r["skipped"] == 1


def test_fsdp_matches_data_parallelism(runs):
    fsdp, dp = read(runs["fsdp2"], 2)[0]["metrics"], read(runs["dp2"], 2)[0]["metrics"]
    for a, b in zip(fsdp[:4], dp):
        assert a["grads_finite"] == b["grads_finite"]
        if np.isfinite(b["loss"]):
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_RTOL)
            np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=LOSS_RTOL)
    for i in SNAPS:
        a, b = load_npz(runs["fsdp2"] / f"snap{i}.npz"), load_npz(runs["dp2"] / f"snap{i}.npz")
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_rank_holds_one_shard(runs, world):
    """Between steps a rank holds its shard of the parameters and of each
    moment, ceil(padded / N) elements (each parameter padded to a multiple
    of 16 elements, the shard too), and no whole parameter."""
    for r in read(runs[f"fsdp{world}"], world):
        res = r["resident"]
        n_params = len(one_device()[0].params())
        bound = -(-(res["params"] + 15 * n_params) // world) + 15
        assert res["shard"] == res["mu"] == res["nu"] <= bound
        assert res["shard"] * world >= res["params"]
        assert res["model_bytes"] == 0


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_checkpoint_resumes_bitwise(runs, world):
    for r in read(runs[f"fsdp{world}"], world):
        resume = r["resume"]
        assert resume["direct"] == resume["resumed"] and np.isfinite(resume["direct"])
        assert resume["same_state"] is True


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_checkpoint_resumes_on_one_device(runs, world):
    """The files hold the whole tree: one device restores the N-rank state
    bit for bit, and its next step agrees with the ranks' direct one."""
    state, step, _ = one_device(seed=1)
    load_checkpoint(runs["tmp"] / f"ckpt{world}", state)
    saved = load_npz(runs[f"fsdp{world}"] / f"snap{SAVE_AFTER}.npz")
    restored = whole(state)
    assert saved.keys() == restored.keys()
    for k in saved:
        np.testing.assert_array_equal(restored[k], saved[k], err_msg=k)
    loss = float(step(state, device_batch(runs["batches"][SAVE_AFTER + 1]))["loss"])
    direct = read(runs[f"fsdp{world}"], world)[0]["resume"]["direct"]
    np.testing.assert_allclose(loss, direct, rtol=LOSS_RTOL)


def test_one_device_checkpoint_resumes_on_two_fsdp_ranks(runs):
    loaded = load_npz(runs["resume2"] / "loaded.npz")
    assert loaded.keys() == runs["one_saved"].keys()
    for k, v in runs["one_saved"].items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
    ranks = read(runs["resume2"], 2)
    np.testing.assert_allclose(ranks[0]["metrics"][0]["loss"], runs["one_next"],
                               rtol=LOSS_RTOL)
    assert ranks[0]["step"] == 3 and ranks[0]["count"] == 3


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The root train.py and the port's CLI, both data-parallel over 2, the
    port replicated and FSDP, on three corpus songs at tiny widths."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    data = copy_songs(tmp / "tokenized")
    mesh = {"data_parallel": 2}
    (tmp / "jax.yaml").write_text(
        yaml_text({**settings(data, tmp / "jax"), "mesh": mesh}) + "\n")
    common = ["--run-id", "r", "--max-steps", "3"]
    procs = []
    for name, extra in (("dp", {}), ("fsdp", {"fsdp": True})):
        (tmp / f"{name}.json").write_text(json.dumps(
            {**settings(data, tmp / name), "mesh": {**mesh, **extra}}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "etude_tpu_torch.train", "--config", str(tmp / f"{name}.json"),
             "--device", "cpu", *common], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    assert jax_train_main(["--config", str(tmp / "jax.yaml"), *common]) == 0
    for proc in procs:
        try:
            log, _ = proc.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
        assert proc.returncode == 0, log[-3000:]
    return tmp


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_cli_over_two_ranks_matches_jax_cli(cli_runs, name):
    tmp = cli_runs

    def metrics(run):
        return [json.loads(x) for x in (tmp / run / "r" / "metrics.jsonl").read_text().splitlines()]

    ours, ref = metrics(name), metrics("jax")
    assert len(ours) == len(ref) == 1
    assert ours[0]["step"] == ref[0]["step"] == 3
    assert ours[0]["skipped_updates"] == ref[0]["skipped_updates"] == 0
    np.testing.assert_allclose(ours[0]["loss"], ref[0]["loss"], rtol=LOSS_RTOL)
    config = JaxConfig.from_json_file(tmp / "jax" / "r" / "etude_decoder_config.json")
    ref_params = jax_load_params_only(tmp / "jax" / "r" / "model",
                                      init_params(config, abstract=True), cache=False)
    rates = sum(float(cli_optimizer(1e-3, 1, 3)[1](s)) for s in range(3))
    assert_params_close(load_params_only(tmp / name / "r" / "model"),
                        jax.device_get(ref_params), 2 * rates)
    # Rank 0 alone writes: one metrics line, one set of files.
    assert {p.name for p in (tmp / name / "r").iterdir()} == {
        "metrics.jsonl", "metadata.json", "etude_decoder_config.json", "vocab.json",
        "latest", "epoch_0001", "model"}


def test_dryrun_multichip_on_four_cpu_ranks():
    proc = subprocess.run(
        [sys.executable, "-c", "from etude_tpu_torch.entry import dryrun_multichip; "
         "dryrun_multichip(4, device='cpu')"],
        cwd=REPO, capture_output=True, text=True, timeout=150)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "dryrun_multichip(4) on cpu: ok" in proc.stdout


def test_dryrun_multichip_refuses_missing_cards():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from etude_tpu_torch.entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4)
