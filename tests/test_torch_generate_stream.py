"""The port's streaming engine (etude_tpu_torch/models/generate_stream.py)
against the JAX package's (etude_tpu/models/generate_stream.py), mirroring
tests/test_generate_stream.py.

The port's cache is [L, B, H, C, D] where JAX's is [L, B, H, D, C]; the
tests transpose. The tiny decoder is drawn with init std 0.1, not the
published 0.02: its logits then have a std of about 0.55 (not 0.11), and
greedy bars run to the 32-token limit instead of stopping after one token,
so the engine comparison covers whole bars.

Tolerances, from the bf16 spread measured between the two packages on these
chunks: logits differ by at most 1.3e-2 (8.7e-3 on S = 1 steps), held to
atol 2e-2, under 4% of a logit's std; K/V by at most one bf16 ulp at
|x| <= 2, held to atol = rtol = 2e-2; cache bookkeeping (slot_pos,
compaction) agrees exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.models import generate_stream as jgs
from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.models.generate import ATTR_KEYS
from etude_tpu_torch.data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
from etude_tpu_torch.models import generate_stream as tgs
from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig
from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

LOGIT_TOL = dict(atol=2e-2, rtol=0)
KV_TOL = dict(atol=2e-2, rtol=2e-2)
# A greedy divergence is accepted only at a near-tie: the JAX logits' top-2
# margin at the diverging step must be below this. Each logit of an S = 1
# step moves by at most 8.7e-3 between the packages, so the two logits of a
# pair can close a margin of twice that; the median top-2 margin is
# 0.07-0.3.
TIE_MARGIN = 1.75e-2
TINY = dict(vocab_size=32, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128, attribute_emb_dim=8,
            initializer_range=0.1)
BOS, EOS = 4, 5
ENGINE_KW = dict(bar_bos_id=BOS, bar_eos_id=EOS, pad_id=0,
                 max_bar_token_limit=32, x_len_buckets=(16, 32), bars_bucket=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run one small op after another: with pytest's
    workers sharing the cores, torch's thread pool only contends. One
    thread, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    jconfig, config = JaxConfig(**TINY), EtudeDecoderConfig(**TINY)
    params = init_params(jconfig, seed=0)
    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config)
    return jconfig, params, config, model


def _song(n_bars=6, notes_per_bar=3, seed=0):
    rng = np.random.default_rng(seed)
    bars = [[BOS] + rng.integers(6, 32, notes_per_bar).tolist() + [EOS]
            for _ in range(n_bars)]
    attrs = [{k: int(rng.integers(0, 3)) for k in ATTR_KEYS} for _ in range(n_bars)]
    return bars, attrs


def _cache_to_torch(cache):
    return {
        "k": torch.tensor(np.asarray(cache["k"].astype(jnp.float32)).transpose(0, 1, 2, 4, 3)).bfloat16(),
        "v": torch.tensor(np.asarray(cache["v"].astype(jnp.float32)).transpose(0, 1, 2, 4, 3)).bfloat16(),
        "slot_pos": torch.tensor(np.asarray(cache["slot_pos"]), dtype=torch.long),
    }


def _assert_cache_close(ours, ref):
    np.testing.assert_array_equal(ours["slot_pos"].numpy(), np.asarray(ref["slot_pos"]))
    for key in ("k", "v"):
        np.testing.assert_allclose(
            ours[key].float().numpy(),
            np.asarray(ref[key].astype(jnp.float32)).transpose(0, 1, 2, 4, 3), **KV_TOL)


def test_stream_chunk_matches_jax_seed_condition_and_decode(setup):
    """Each chunk kind from the same cache state: the seed chunk (S = 16),
    a condition chunk with padding (valid_len), and an S = 1 decode step."""
    jconfig, params, config, model = setup
    rng = np.random.default_rng(0)
    B, C, hist, X = 2, 64, 24, 12
    jcache = jgs.init_stream_cache(jconfig, B, C)
    zero = np.zeros(B, np.int64)
    seed_ids = np.tile([BOS, EOS] * 8, (B, 1))
    seed_cls = np.tile(([SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2) * 4, (B, 1))
    x = rng.integers(6, 32, (B, X))
    attr = {n: rng.integers(0, 3, (B, 1)) for n in ATTRIBUTE_ORDER}
    chunks = [
        dict(ids=seed_ids, cls=seed_cls, attrs={n: np.ones((B, 16), np.int64) for n in ATTRIBUTE_ORDER},
             start=zero, win=zero, off=0, valid=None),
        dict(ids=x, cls=np.full((B, X), SRC_CLASS_ID),
             attrs={n: np.repeat(a, X, 1) for n, a in attr.items()},
             start=zero + 16, win=zero + 2, off=hist, valid=np.array([X, 7])),
        dict(ids=np.full((B, 1), BOS), cls=np.full((B, 1), TGT_CLASS_ID), attrs=attr,
             start=np.array([16 + X, 23]), win=zero + 2, off=hist + X, valid=None),
        dict(ids=rng.integers(6, 32, (B, 1)), cls=np.full((B, 1), TGT_CLASS_ID), attrs=attr,
             start=np.array([17 + X, 24]), win=zero + 2, off=hist + X + 1,
             valid=np.array([1, 0])),
    ]
    for c in chunks:
        cache = _cache_to_torch(jcache)
        j32 = lambda a: None if a is None else jnp.asarray(a, jnp.int32)  # noqa: E731
        ref_logits, jcache = jgs.stream_chunk(
            params, jconfig, jcache, j32(c["ids"]), j32(c["cls"]),
            {k: j32(v) for k, v in c["attrs"].items()},
            start_pos=j32(c["start"]), win_start=j32(c["win"]),
            slot_offset=jnp.int32(c["off"]), valid_len=j32(c["valid"]),
        )
        t = lambda a: None if a is None else torch.tensor(a, dtype=torch.long)  # noqa: E731
        with torch.no_grad():
            logits, cache = tgs.stream_chunk(
                model, cache, t(c["ids"]), t(c["cls"]),
                {k: t(v) for k, v in c["attrs"].items()},
                start_pos=t(c["start"]), win_start=t(c["win"]),
                slot_offset=c["off"], valid_len=t(c["valid"]),
            )
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **LOGIT_TOL)
        _assert_cache_close(cache, jcache)


@pytest.mark.parametrize("regress", [False, True])
def test_compact_window_equals_jax(setup, regress):
    """Random cache contents and slot positions; the regressed-start case
    (mirror of test_generate_stream.py:237) must keep dropped positions
    dead."""
    jconfig, *_ = setup
    rng = np.random.default_rng(4 + regress)
    B, C, hist = 3, 40, 16
    L, H, D = jconfig.num_hidden_layers, jconfig.num_attention_heads, jconfig.head_dim
    jcache = jgs.init_stream_cache(jconfig, B, C)
    jcache["k"] = jnp.asarray(rng.normal(size=(L, B, H, D, C)), jnp.bfloat16)
    jcache["v"] = jnp.asarray(rng.normal(size=(L, B, H, D, C)), jnp.bfloat16)
    slot_pos = np.full((B, C), -1, np.int32)
    for b in range(B):  # live positions scattered over both regions
        live = rng.choice(C, 20, replace=False)
        slot_pos[b, live] = 30 + rng.permutation(20)
    jcache["slot_pos"] = jnp.asarray(slot_pos)
    cur = jnp.asarray([50, 50, 45], jnp.int32)
    win = jnp.asarray([34, 30, 38], jnp.int32)
    if regress:  # cut at one start, then regress to an earlier one
        jcache = jgs.compact_window(jcache, win + 4, cur, hist)
    cache = _cache_to_torch(jcache)
    ref = jgs.compact_window(jcache, win, cur, hist)
    out = tgs.compact_window(cache, torch.tensor(np.asarray(win), dtype=torch.long),
                             torch.tensor(np.asarray(cur), dtype=torch.long), hist)
    np.testing.assert_array_equal(out["slot_pos"].numpy(), np.asarray(ref["slot_pos"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(
            out[key].float().numpy(),
            np.asarray(ref[key].astype(jnp.float32)).transpose(0, 1, 2, 4, 3))
    if regress:
        assert (out["slot_pos"].numpy()[:, :4] == -1).all()


def test_stream_window_respected(setup):
    """Tokens before win_start must not influence the logits (mirror of
    test_generate_stream.py:270)."""
    *_, model = setup
    rng = np.random.default_rng(1)
    B, S = 1, 8
    ids = torch.tensor(rng.integers(4, 32, (B, S)))
    cls = torch.full((B, S), TGT_CLASS_ID)
    attrs = {n: torch.ones((B, S), dtype=torch.long) for n in ATTRIBUTE_ORDER}

    def run(prefix):
        cache = tgs.init_stream_cache(model.config, B, 64)
        pos = torch.zeros(B, dtype=torch.long)
        win = torch.full((B,), 4)
        with torch.no_grad():
            tgs.stream_chunk(model, cache, prefix, cls, attrs, pos, win, 0)
            logits, _ = tgs.stream_chunk(
                model, cache, ids[:, :1], cls[:, :1],
                {k: v[:, :1] for k, v in attrs.items()}, pos + S, win, S)
        return logits.numpy()

    mutated = ids.clone()
    mutated[:, :4] = 7
    np.testing.assert_allclose(run(ids), run(mutated), atol=1e-5)


def test_stream_batch_lockstep(setup):
    """Streams of different lengths batched together give what each gives
    alone (greedy; mirror of test_generate_stream.py:99, which also checks
    a sampled run: torch's generator draws depend on the batch shape)."""
    *_, config, model = setup
    engine = tgs.StreamingGenerationEngine(config, **ENGINE_KW)
    bars1, attrs1 = _song(n_bars=5, seed=1)
    bars2, attrs2 = _song(n_bars=3, seed=2)
    outs = engine.generate_batch(model, [bars1, bars2], [attrs1, attrs2])
    assert len(outs[0]) == 5 and len(outs[1]) == 3
    assert outs[0] == engine.generate_batch(model, [bars1], [attrs1])[0]
    assert outs[1] == engine.generate_batch(model, [bars2], [attrs2])[0]


def test_stream_sampled_structure_and_budget(setup):
    *_, config, model = setup
    engine = tgs.StreamingGenerationEngine(config, **ENGINE_KW)
    bars, attrs = _song(n_bars=14, notes_per_bar=8, seed=9)
    out = engine.generate(model, bars, attrs, temperature=0.7, seed=1)
    assert len(out) == 14
    for bar in out:
        assert bar[0] == BOS and len(bar) <= 33
        if EOS in bar:
            assert bar.index(EOS) == len(bar) - 1
    again = engine.generate(model, bars, attrs, temperature=0.7, seed=1)
    assert again == out
    short = engine.generate(model, bars[:8], attrs[:8], temperature=0.9, seed=2,
                            max_output_tokens=10)
    assert 1 <= len(short) < 8


_jax_chunk = jax.jit(jgs.stream_chunk, static_argnums=(1,), static_argnames=("max_hi",))


def _jax_replay(jconfig, params, engine, bars, attrs, jax_bars, quant=False):
    """Replays the JAX stream for one song, teacher-forced with the JAX
    engine's own tokens; yields ((bar, step), logits) for every logits
    vector the engine sampled from. `quant` replays the int8 cache."""
    packed = engine.pack([bars], [attrs])
    X, hist, n_ctx = packed["X"], packed["hist"], jconfig.context_num_past_xy_pairs
    kw = dict(max_hi=packed["max_hi"])
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    cache = jgs.init_stream_cache(jconfig, 1, packed["cache_len"], quant=quant)
    seed_ids = i32([[BOS, EOS] * (2 * n_ctx)])
    seed_cls = i32([([SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2) * n_ctx])
    ones = {n: jnp.ones_like(seed_ids) for n in ATTRIBUTE_ORDER}
    _, cache = _jax_chunk(params, jconfig, cache, seed_ids, seed_cls, ones,
                          i32([0]), i32([0]), jnp.int32(0), **kw)
    pair_starts, cur = [4 * j for j in range(n_ctx + 1)], 4 * n_ctx
    for i, y in enumerate(jax_bars):
        n_x = int(packed["x_lens"][0, i])
        attrs_i = {n: i32([[int(a[0, i])]]) for n, a in packed["x_attrs"].items()}
        win, x_end = pair_starts[0], cur + n_x
        if x_end - win > engine.prompt_cap - 1:
            win = x_end - engine.prompt_keep
        cache = jgs.compact_window(cache, i32([win]), i32([cur]), hist)
        _, cache = _jax_chunk(
            params, jconfig, cache, i32(packed["x_tokens"][:, i]), i32([[SRC_CLASS_ID] * X]),
            {n: jnp.broadcast_to(a, (1, X)) for n, a in attrs_i.items()},
            i32([cur]), i32([win]), jnp.int32(hist), valid_len=i32([n_x]), **kw)
        tokens = [BOS] + y[1:]
        for step, tok in enumerate(tokens):
            logits, cache = _jax_chunk(
                params, jconfig, cache, i32([[tok]]), i32([[TGT_CLASS_ID]]), attrs_i,
                i32([x_end + step]), i32([win]), jnp.int32(hist + X + step), **kw)
            if step + 1 < len(tokens):
                yield (i, step), np.asarray(logits[0, 0])
        cur = x_end + len(tokens)
        pair_starts = pair_starts[1:] + [cur]


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_greedy_engine_matches_jax(setup, seed):
    """Token for token up to the first divergence, if any; there the JAX
    logits must be a near-tie (top-2 margin below TIE_MARGIN)."""
    jconfig, params, config, model = setup
    bars, attrs = _song(n_bars=6, seed=seed)
    jax_out = jgs.StreamingGenerationEngine(jconfig, **ENGINE_KW).generate(
        params, bars, attrs, temperature=0.0)
    engine = tgs.StreamingGenerationEngine(config, **ENGINE_KW)
    ours = engine.generate(model, bars, attrs, temperature=0.0)
    assert len(ours) == len(jax_out)
    diverged = next(((i, s - 1) for i, (a, b) in enumerate(zip(ours, jax_out))
                     for s in range(max(len(a), len(b)))
                     if s >= min(len(a), len(b)) or a[s] != b[s]), None)
    if diverged is None:
        return
    logits = next(l for at, l in _jax_replay(jconfig, params, engine, bars, attrs,
                                               jax_out) if at == diverged)
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] < TIE_MARGIN, (
        f"bar {diverged[0]} step {diverged[1]}: greedy divergence at a margin "
        f"of {top2[1] - top2[0]:.3g}")


def test_replay_reproduces_jax_engine(setup):
    """The replay used above is faithful: at every step of every bar its
    argmax is the JAX engine's next token."""
    jconfig, params, config, _ = setup
    bars, attrs = _song(n_bars=3, seed=3)
    jax_out = jgs.StreamingGenerationEngine(jconfig, **ENGINE_KW).generate(
        params, bars, attrs, temperature=0.0)
    engine = tgs.StreamingGenerationEngine(config, **ENGINE_KW)
    steps = 0
    for (i, step), logits in _jax_replay(jconfig, params, engine, bars, attrs, jax_out):
        assert int(np.argmax(logits)) == jax_out[i][step + 1], (i, step)
        steps += 1
    assert steps == sum(len(b) - 1 for b in jax_out)


def test_single_token_chunks_are_counted(setup):
    """The engine counts its S = 1 chunks: per bar, the Bar_BOS chunk and
    one chunk per generated token."""
    *_, config, model = setup
    engine = tgs.StreamingGenerationEngine(config, **ENGINE_KW)
    bars, attrs = _song(n_bars=4, seed=6)
    out = engine.generate(model, bars, attrs)
    assert engine.stats["single_token_chunks"] == sum(len(b) for b in out)
