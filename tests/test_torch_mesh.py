"""The port's mesh helpers (etude_tpu_torch/parallel/mesh.py) against the JAX
package's (etude_tpu/parallel/mesh.py) on the conftest's 8 virtual CPU
devices, in one process: make_mesh's sizing and errors, the rows each rank
keeps (JAX's P(None, data) shards of the same numpy batch, exactly), the
flat FSDP partition, the CLI's data-axis sizing (JAX train.py:146-152), and
the streaming sweep spread over several devices (tokens equal to the
one-device run and to JAX's mesh run, exactly, as
tests/test_stream_sharded.py holds JAX's mesh run to its one-device run);
and `spawn_ranks`, which starts the ranks of the CLI, the dryrun and the
benchmark.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.models.generate_stream import StreamingGenerationEngine as JaxEngine
from etude_tpu.parallel.mesh import make_mesh as jax_make_mesh
from etude_tpu.parallel.train_step import reshape_for_accum as jax_reshape
from etude_tpu_torch.models.decoder import EtudeDecoderConfig
from etude_tpu_torch.models.generate import ATTR_KEYS
from etude_tpu_torch.models.generate_stream import StreamingGenerationEngine
from etude_tpu_torch.parallel.mesh import (FLAT_ALIGN, Mesh, flat_layout, fsdp_param_sharding,
                                           make_mesh, shard_batch)
from etude_tpu_torch.parallel.train_step import reshape_for_accum
from etude_tpu_torch.train import data_parallel_size
from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np
from test_torch_train_step import TINY, make_batch


@pytest.mark.parametrize("dp,mp,n", [(4, 1, 2), (3, 2, 4), (2, 4, 7), (9, 1, 8)])
def test_make_mesh_raises_as_jax_on_too_few_devices(dp, mp, n):
    with pytest.raises(ValueError, match="needs") as ours:
        make_mesh(data_parallel=dp, model_parallel=mp, devices=["cpu"] * n)
    with pytest.raises(ValueError, match="needs") as ref:
        jax_make_mesh(data_parallel=dp, model_parallel=mp, devices=jax.devices()[:n])
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("dp,mp,n", [(-1, 1, 1), (-1, 0, 1), (1, 0, 3), (1, 1, 8)])
def test_make_mesh_sizes_as_jax(dp, mp, n):
    """A one-rank job: JAX's sizing where it gives one position (-1 takes
    n // model_parallel; model_parallel < 1 counts as 1)."""
    ours = make_mesh(data_parallel=dp, model_parallel=mp, devices=["cpu"] * n)
    ref = jax_make_mesh(data_parallel=dp, model_parallel=mp, devices=jax.devices()[:n])
    assert (ours.data_parallel, ours.model_parallel) == (ref.shape["data"], ref.shape["model"])
    assert ours.group is None and ours.rank == 0 and ours.device == torch.device("cpu")


@pytest.mark.parametrize("dp", [2, 8])
def test_make_mesh_must_cover_every_rank(dp):
    """Unlike JAX, a grid larger than the job's ranks raises: the port runs
    one rank per device."""
    jax_make_mesh(data_parallel=dp, devices=jax.devices()[:dp])
    with pytest.raises(ValueError, match="start one rank per position"):
        make_mesh(data_parallel=dp, devices=["cpu"] * dp)


def mesh_of(dp: int, rank: int) -> Mesh:
    return Mesh(dp, 1, rank, torch.device("cpu"), None)


@pytest.mark.parametrize("dp", [1, 2, 4])
def test_shard_batch_keeps_the_rows_of_jax_shards(dp):
    batch = jax_reshape(make_batch(np.random.default_rng(5)), 2)       # [2, 4, 16]
    sharding = NamedSharding(jax_make_mesh(data_parallel=dp, devices=jax.devices()[:dp]),
                             P(None, "data"))
    for key, value in batch.items():
        shards = jax.device_put(value, sharding).addressable_shards
        for rank in range(dp):
            want = next(np.asarray(s.data) for s in shards
                        if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(shard_batch(batch, mesh_of(dp, rank))[key], want)
    # The global label count of each micro-batch, as JAX's loss_fn counts it.
    labels = batch["labels"]
    for rank in range(dp):
        counts = shard_batch(batch, mesh_of(dp, rank))["n_labels"]
        assert counts.tolist() == [max(int((labels[i] != -100).sum()), 1) for i in range(2)]


def test_shard_batch_refuses_rows_that_do_not_split():
    batch = reshape_for_accum(make_batch(np.random.default_rng(0), B=6), 2)   # 3 rows
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(batch, mesh_of(2, 0))


@pytest.mark.parametrize("dp", [1, 2, 3, 4, 7])
def test_flat_partition_holds_each_element_once(dp):
    config = EtudeDecoderConfig(**TINY)
    params = list(decoder_from_jax(init_decoder_params_np(config, 0), config).parameters())
    layouts = [fsdp_param_sharding(mesh_of(dp, r), params) for r in range(dp)]
    owner = np.zeros(layouts[0].padded, np.int64)
    for layout in layouts:
        assert layout.shard % FLAT_ALIGN == 0 and layout.padded == layout.shard * dp
        for j, a, b in layout.pieces():
            owner[layout.lo + a: layout.lo + b] += 1
    for off, p in zip(layouts[0].offsets, params):
        assert off % FLAT_ALIGN == 0
        assert (owner[off:off + p.numel()] == 1).all()
    assert owner.sum() == sum(p.numel() for p in params)
    assert layouts[0].shard <= math.ceil((sum(p.numel() for p in params)
                                          + FLAT_ALIGN * len(params)) / dp) + FLAT_ALIGN
    assert flat_layout(params).offsets == layouts[0].offsets


def jax_data_parallel(n_devices, model_parallel, batch_size):
    """JAX train.py:146-152, verbatim."""
    dp = min(n_devices // model_parallel, batch_size)
    while dp > 1 and batch_size % dp:
        dp -= 1
    return dp


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("batch", [1, 2, 3, 5, 6, 7, 8, 9, 10, 12])
@pytest.mark.parametrize("mp", [1, 2])
def test_data_parallel_size_is_jax_rule(n, batch, mp):
    got = data_parallel_size(-1, mp, n, batch)
    assert got == max(jax_data_parallel(n, mp, batch), 1)
    assert batch % got == 0
    assert data_parallel_size(3, mp, n, batch) == 3      # a set size is kept


def test_data_parallel_size_on_a_batch_four_does_not_divide():
    assert data_parallel_size(-1, 1, 4, 6) == 3
    assert data_parallel_size(-1, 1, 4, 10) == 2
    assert data_parallel_size(-1, 1, 4, 9) == 3
    assert data_parallel_size(-1, 1, 4, 7) == 1


SWEEP = dict(vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_position_embeddings=128, attribute_emb_dim=8)
ENGINE = dict(bar_bos_id=4, bar_eos_id=5, pad_id=0, max_bar_token_limit=32,
              x_len_buckets=(16,), bars_bucket=8)


@pytest.fixture(scope="module")
def sweep_models():
    params = init_params(JaxConfig(**SWEEP), seed=0)
    config = EtudeDecoderConfig(**SWEEP)
    return params, decoder_from_jax(init_decoder_params_np(config, seed=0), config), config


def song(n_streams, seed):
    rng = np.random.default_rng(seed)
    bars = [[4] + rng.integers(6, 32, 3).tolist() + [5] for _ in range(5)]
    attrs = [[{k: (i + j) % 3 for k in ATTR_KEYS} for j in range(len(bars))]
             for i in range(n_streams)]
    return [bars] * n_streams, attrs


@pytest.mark.parametrize("n_streams", [5, 8])
def test_sweep_over_three_devices_matches_one_device_and_jax_mesh(sweep_models, n_streams):
    params, model, config = sweep_models
    xs, ats = song(n_streams, seed=n_streams)
    engine = StreamingGenerationEngine(config, **ENGINE)
    one = engine.generate_batch(model, xs, ats, temperature=0.0, seed=3)
    chunks_one = engine.stats["single_token_chunks"]
    spread = engine.generate_batch(model, xs, ats, temperature=0.0, seed=3,
                                   devices=["cpu"] * 3)
    assert spread == one
    assert len(spread) == n_streams
    # Each share counts its own S = 1 chunks; the engine sums them.
    assert engine.stats["single_token_chunks"] > chunks_one
    ref = JaxEngine(JaxConfig(**SWEEP), **ENGINE).generate_batch(
        params, xs, ats, temperature=0.0, seed=3, mesh=jax_make_mesh(data_parallel=8))
    assert spread == ref


def test_sampled_sweep_repeats_for_a_seed_and_device_count(sweep_models):
    _, model, config = sweep_models
    xs, ats = song(5, seed=1)
    engine = StreamingGenerationEngine(config, **ENGINE)
    kw = dict(temperature=1.0, top_p=0.9, seed=7)
    a = engine.generate_batch(model, xs, ats, devices=["cpu"] * 2, **kw)
    b = engine.generate_batch(model, xs, ats, devices=["cpu"] * 2, **kw)
    assert a == b
    assert engine.generate_batch(model, xs, ats, devices=["cpu"] * 2, **{**kw, "seed": 8}) != a


# A world of spawn_ranks runs in a subprocess killed past this deadline
# (the ranks' own group times out after torch_mesh_worker.TIMEOUT_S).
SPAWN_DEADLINE_S = 120


def _spawn_ranks(world: int, fail_rank: int) -> subprocess.CompletedProcess:
    tests = Path(__file__).resolve().parent
    code = (f"import json, sys; sys.path[:0] = [{str(tests.parent)!r}, {str(tests)!r}]; "
            "from etude_tpu_torch.parallel.mesh import spawn_ranks; "
            "from torch_mesh_worker import spawn_probe; "
            f"print(json.dumps(spawn_ranks(spawn_probe, {world}, {fail_rank})))")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=SPAWN_DEADLINE_S)


@pytest.mark.parametrize("world", [1, 3])
def test_spawn_ranks_returns_rank_zeros_record(world):
    proc = _spawn_ranks(world, -1)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"world": world,
                                                        "sum": world * (world - 1) // 2}


def test_spawn_ranks_raises_when_a_rank_fails():
    """The failing rank ends the others (waiting at the rendezvous) and the
    error reaches the caller."""
    proc = _spawn_ranks(2, 1)
    assert proc.returncode != 0
    assert "rank 1 fails on purpose" in proc.stderr
