"""The port's training step over a mesh of 2 and 4 gloo ranks
(etude_tpu_torch/parallel/; each rank a process of tests/torch_mesh_worker.py)
against the JAX package's `make_train_step(mesh=make_mesh(data_parallel=4))`
on the conftest's virtual CPU devices, f32, from the same parameter tree, on
`make_batch`'s batches, whose padded row gives the ranks unequal label
counts.

Four steps: two ordinary ones, a third in which the last rank's activations
turn NaN (JAX: a NaN bias, which skips its update as the port's must), and a
fourth after the skip. Tolerances are those of tests/test_torch_train_step.py:
losses and grad norms to LOSS_RTOL (1e-5) relative, accuracy to 1e-6,
parameters and Adam moments to PARAM_ATOL (1e-6) after steps 2 and 4 (the key
biases outside the rotary dims, whose gradient is exactly zero, to twice the
rates applied). The control divides each rank's loss by its own label count
times the world size, the average of per-rank means that
DistributedDataParallel computes: it must fail the loss check.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.parallel.mesh import make_mesh as jax_make_mesh
from etude_tpu.parallel.train_step import init_train_state as jax_init_state
from etude_tpu.parallel.train_step import make_optimizer as jax_optimizer
from etude_tpu.parallel.train_step import make_train_step as jax_train_step
from etude_tpu.parallel.train_step import reshape_for_accum as jax_reshape
from etude_tpu_torch.parallel.train_step import make_optimizer
from etude_tpu_torch.utils.training import unflatten_tree
from test_torch_train_step import (LOSS_RTOL, PARAM_ATOL, TINY, adam_moments,
                                   assert_params_close, assert_trees_close, make_batch)
from torch_mesh_worker import launch

OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10, clip_grad_norm=1.0)
ACCUM = 2
N_STEPS = 4
NAN_STEP = 2        # 0-based: the third step
SNAPS = (1, 3)      # whole state compared after steps 2 and 4


def host_batches(n=N_STEPS, seed=11):
    rng = np.random.default_rng(seed)
    return [make_batch(rng) for _ in range(n)]


def write_batches(path, batches):
    np.savez(path, **{f"b{i}/{k}": v for i, b in enumerate(batches) for k, v in b.items()})
    return str(path)


def spec(world, mode, batches, **extra):
    return {"world": world, "mode": mode, "batches": batches, "config": TINY, "opt": OPT,
            "accum": ACCUM, **extra}


def rates(n):
    """The sum of the rates of the first n updates (the bound on the
    zero-gradient key biases, as tests/test_torch_train_step.py Pair.rates)."""
    schedule = make_optimizer(**OPT)[1]
    return sum(float(schedule(s)) for s in range(n))


def jax_trajectory(batches, nan_step=NAN_STEP):
    """JAX's mesh step over `batches` (4 data-parallel devices), with the
    attribute-projection bias NaN for step `nan_step` only. Returns per-step
    metrics and the (params, mu, nu, count) after each step in SNAPS."""
    config = JaxConfig(**TINY)
    tx, _ = jax_optimizer(**OPT)
    state = jax_init_state(init_params(config, seed=0), tx)
    step = jax_train_step(config, tx, mesh=jax_make_mesh(data_parallel=4),
                          compute_dtype=jnp.float32)
    metrics, snaps = [], {}
    for i, batch in enumerate(batches):
        good = state.params["attr_proj"]["b"]
        if i == nan_step:
            state = state._replace(params={**state.params, "attr_proj": {
                **state.params["attr_proj"], "b": good.at[0].set(jnp.nan)}})
        state, m = step(state, jax_reshape(batch, ACCUM))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == nan_step:
            state = state._replace(params={**state.params, "attr_proj": {
                **state.params["attr_proj"], "b": state.params["attr_proj"]["b"].at[0].set(
                    good[0])}})
        if i in SNAPS:
            mu, nu, count = adam_moments(state.opt_state)
            snaps[i] = jax.device_get((state.params, mu, nu, count))
    return metrics, snaps


def read(out, world):
    return [json.loads((out / f"rank{r}.json").read_text()) for r in range(world)]


def check_metrics(ours, ref):
    assert ours["grads_finite"] == ref["grads_finite"]
    for key in ("loss", "grad_norm"):
        if np.isnan(ref[key]):
            assert np.isnan(ours[key]), key
        else:
            np.testing.assert_allclose(ours[key], ref[key], rtol=LOSS_RTOL, err_msg=key)
    if not np.isnan(ref["accuracy"]):
        np.testing.assert_allclose(ours["accuracy"], ref["accuracy"], atol=1e-6)


def check_snapshot(path, ref, n_updates):
    with np.load(path) as f:
        tree = unflatten_tree({k: f[k] for k in f.files})
    params, mu, nu, _ = ref
    assert_params_close(tree["params"], params, 2 * rates(n_updates))
    assert_trees_close(tree["mu"], mu, PARAM_ATOL, "mu")
    assert_trees_close(tree["nu"], nu, PARAM_ATOL, "nu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Data parallelism at 2 and 4 ranks, and the control at 4, at once."""
    tmp = tmp_path_factory.mktemp("mesh_dp")
    batches = host_batches()
    path = write_batches(tmp / "batches.npz", batches)
    outs = launch([spec(2, "dp", path, snap=list(SNAPS), nan_step=NAN_STEP),
                   spec(4, "dp", path, snap=list(SNAPS), nan_step=NAN_STEP),
                   spec(4, "mean", write_batches(tmp / "two.npz", batches[:2]))],
                  tmp)
    return {2: outs[0], 4: outs[1], "mean": outs[2]}, jax_trajectory(batches)


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_steps_match_jax(runs, world):
    outs, (ref, snaps) = runs
    ranks = read(outs[world], world)
    for i in (0, 1, 3):
        check_metrics(ranks[0]["metrics"][i], ref[i])
    check_snapshot(outs[world] / "snap1.npz", snaps[1], 2)
    check_snapshot(outs[world] / "snap3.npz", snaps[3], 3)
    assert ranks[0]["count"] == snaps[3][3] == 3


@pytest.mark.parametrize("world", [2, 4])
def test_every_rank_reports_the_whole_batch(runs, world):
    """The metrics are reduced: every rank reads the same numbers, and the
    label count is the whole batch's."""
    outs, _ = runs
    ranks = read(outs[world], world)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
    want = [int((h["labels"] != -100).sum()) for h in host_batches()]
    assert [int(m["n_tokens"]) for m in ranks[0]["metrics"]] == want


@pytest.mark.parametrize("world", [2, 4])
def test_nan_on_one_rank_skips_every_rank(runs, world):
    outs, (ref, _) = runs
    for r in read(outs[world], world):
        m = r["metrics"][NAN_STEP]
        assert m["grads_finite"] == ref[NAN_STEP]["grads_finite"] == 0
        assert np.isnan(m["loss"]) and np.isnan(ref[NAN_STEP]["loss"])
        assert r["kept"] is True          # parameters and moments keep their bits
        assert r["step"] == N_STEPS and r["skipped"] == 1 and r["count"] == N_STEPS - 1


@pytest.mark.parametrize("world", [2, 4])
def test_step_after_the_skip_matches_jax(runs, world):
    outs, (ref, snaps) = runs
    check_metrics(read(outs[world], world)[0]["metrics"][3], ref[3])
    check_snapshot(outs[world] / "snap3.npz", snaps[3], 3)


def test_per_rank_mean_control_fails(runs):
    """The control, DistributedDataParallel's average of per-rank means,
    misses JAX's loss: the check above must catch it."""
    outs, (ref, _) = runs
    ours = read(outs["mean"], 4)[0]["metrics"]
    for i in range(2):
        with pytest.raises(AssertionError):
            np.testing.assert_allclose(ours[i]["loss"], ref[i]["loss"], rtol=LOSS_RTOL)
    assert ref[0]["loss"] > 0
