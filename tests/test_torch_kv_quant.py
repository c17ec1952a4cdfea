"""The port's int8 KV cache (etude_tpu_torch/models/generate_stream.py,
`kv_quant`) against the JAX package's (etude_tpu/models/generate_stream.py,
`init_stream_cache(quant=True)`, `_quantize_kv`, the quant branch of
`stream_chunk`), on the same seeded weights and inputs.

The port's cache is [L, B, H, C, D] where JAX's is [L, B, H, D, C]; the
scales are [L, B, H, C] in both. Tolerances:
- `_quantize_kv` is the same f32 arithmetic (amax/127, a division, round
  half to even): bit-equal.
- The chunk logits: both sides quantize the same bf16-computed K/V, q and
  probabilities, and their integer dots are exact, so they differ only by
  the bf16 rounding of the stream test (tests/test_torch_generate_stream.py)
  plus the rare int8 step that rounding moves: atol 2e-2. The cache holds
  the stream test's K/V tolerance, 2e-2 of a row's full scale: int8 values
  within 2 steps of 127 (one bf16 ulp of a value and of its row's amax can
  move it by up to 1.5); scales within rtol 2e-2.
- The greedy engine follows the stream test's near-tie rule: a divergence
  only where the JAX logits' top-2 margin is below 1.75e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.models import generate_stream as jgs
from etude_tpu_torch.data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
from etude_tpu_torch.models import generate_stream as tgs
from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER
from etude_tpu_torch.ops.decode_attention import decode_attention
from test_torch_generate_stream import (BOS, ENGINE_KW, EOS, LOGIT_TOL, TIE_MARGIN,  # noqa: F401
                                        _jax_replay, _song, setup)

SCALE_TOL = dict(rtol=2e-2, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run one small op after another: with pytest's
    workers sharing the cores, torch's thread pool only contends. One
    thread, restored after the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("shape,seed", [((2, 1, 4, 8), 0), ((3, 17, 8, 64), 1), ((1, 5, 2, 32), 2)])
def test_quantize_kv_bit_equal_to_jax(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * rng.choice([1e-3, 1.0, 40.0], size=shape[:-1])[..., None])
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: scale 0, values 0
    x[-1, -1, -1, : shape[-1] // 2] = 0.5 * x[-1, -1, -1].max()  # halves at .5
    values, scales = tgs._quantize_kv(torch.from_numpy(x))
    j_values, j_scales = jgs._quantize_kv(jnp.asarray(x))
    assert values.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))


def _jax_quant_attention(q, k_l, v_l, ks_l, vs_l, bias):
    """The JAX engine's int8 attention, inline in its `stream_chunk`
    (generate_stream.py:398-419), as a function of the same operands (its
    layout: k_l/v_l [B, H, D, C])."""
    q_q, q_s = jgs._quantize_kv(q)
    s32 = jnp.einsum("bqhd,bhdc->bhqc", q_q, k_l, preferred_element_type=jnp.int32)
    scores = (s32.astype(jnp.float32) * q_s.transpose(0, 2, 1)[:, :, :, None]
              * ks_l[:, :, None, :]) / np.sqrt(q.shape[-1])
    probs = jax.nn.softmax(scores + bias, axis=-1)
    pv = probs * vs_l[:, :, None, :]
    p_scale = jnp.max(pv, axis=-1) / 127.0
    p_q = jnp.round(pv / jnp.maximum(p_scale[..., None], 1e-12)).astype(jnp.int8)
    c32 = jnp.einsum("bhqc,bhdc->bqhd", p_q, v_l, preferred_element_type=jnp.int32)
    return (c32.astype(jnp.float32) * p_scale.transpose(0, 2, 1)[..., None]
            ).astype(jnp.bfloat16)


@pytest.mark.parametrize("S,C", [(1, 40), (5, 700), (1, 1300)])
def test_quant_attention_equals_jax(S, C):
    """The same operands through both: the integer dots are exact and the
    f32 steps the same, so the contexts agree bit for bit but where the two
    softmaxes' last bit moves a probability across a rounding midpoint
    (under 1% of the entries, by at most two bf16 ulps)."""
    rng = np.random.default_rng(S + C)
    B, H, D = 2, 3, 64
    q = (rng.normal(size=(B, S, H, D)) * 2.0).astype(np.float32)
    k = rng.integers(-127, 128, (B, H, C, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, H, C, D)).astype(np.int8)
    ks = rng.uniform(0.001, 0.05, (B, H, C)).astype(np.float32)
    vs = rng.uniform(0.001, 0.05, (B, H, C)).astype(np.float32)
    bias = np.where(rng.random((B, 1, S, C)) < 0.2, -1e9, 0.0).astype(np.float32)
    ref = np.asarray(_jax_quant_attention(
        jnp.asarray(q), jnp.asarray(k.transpose(0, 1, 3, 2)), jnp.asarray(v.transpose(0, 1, 3, 2)),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(bias)).astype(jnp.float32))
    out = tgs._quant_attention(*(torch.from_numpy(a) for a in (q, k, v, ks, vs, bias)))
    assert out.dtype == torch.bfloat16 and out.shape == (B, S, H, D)
    out = out.float().numpy()
    assert (out != ref).mean() < 0.01
    np.testing.assert_allclose(out, ref, rtol=2.0 ** -7, atol=0)


def _cache_to_torch(cache):
    return {
        "k": torch.tensor(np.asarray(cache["k"]).transpose(0, 1, 2, 4, 3)),
        "v": torch.tensor(np.asarray(cache["v"]).transpose(0, 1, 2, 4, 3)),
        "slot_pos": torch.tensor(np.asarray(cache["slot_pos"]), dtype=torch.long),
        "k_scale": torch.tensor(np.asarray(cache["k_scale"])),
        "v_scale": torch.tensor(np.asarray(cache["v_scale"])),
    }


def _assert_cache_close(ours, ref):
    np.testing.assert_array_equal(ours["slot_pos"].numpy(), np.asarray(ref["slot_pos"]))
    for key in ("k", "v"):
        assert ours[key].dtype == torch.int8
        got = ours[key].numpy().astype(np.int32)
        want = np.asarray(ref[key]).astype(np.int32).transpose(0, 1, 2, 4, 3)
        np.testing.assert_allclose(got, want, atol=2, rtol=0)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]), **SCALE_TOL)


def test_quant_chunks_match_jax(setup):
    """The seed chunk (S = 16), a condition chunk with padding, the Bar_BOS
    chunk and an S = 1 step with a parked stream, each from the JAX cache
    state, on int8 caches; then the window compaction of the scales."""
    jconfig, params, config, model = setup
    rng = np.random.default_rng(0)
    B, C, hist, X = 2, 64, 24, 12
    jcache = jgs.init_stream_cache(jconfig, B, C, quant=True)
    zero = np.zeros(B, np.int64)
    seed_ids = np.tile([BOS, EOS] * 8, (B, 1))
    seed_cls = np.tile(([SRC_CLASS_ID] * 2 + [TGT_CLASS_ID] * 2) * 4, (B, 1))
    x = rng.integers(6, 32, (B, X))
    attr = {n: rng.integers(0, 3, (B, 1)) for n in ATTRIBUTE_ORDER}
    chunks = [
        dict(ids=seed_ids, cls=seed_cls,
             attrs={n: np.ones((B, 16), np.int64) for n in ATTRIBUTE_ORDER},
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
    before = decode_attention.launches
    for c in chunks:
        cache = _cache_to_torch(jcache)
        j32 = lambda a: None if a is None else jnp.asarray(a, jnp.int32)  # noqa: E731
        ref_logits, jcache = jgs.stream_chunk(
            params, jconfig, jcache, j32(c["ids"]), j32(c["cls"]),
            {k: j32(v) for k, v in c["attrs"].items()},
            start_pos=j32(c["start"]), win_start=j32(c["win"]),
            slot_offset=jnp.int32(c["off"]), valid_len=j32(c["valid"]))
        t = lambda a: None if a is None else torch.tensor(a, dtype=torch.long)  # noqa: E731
        with torch.no_grad():
            logits, cache = tgs.stream_chunk(
                model, cache, t(c["ids"]), t(c["cls"]), {k: t(v) for k, v in c["attrs"].items()},
                start_pos=t(c["start"]), win_start=t(c["win"]), slot_offset=c["off"],
                valid_len=t(c["valid"]))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **LOGIT_TOL)
        _assert_cache_close(cache, jcache)
    assert decode_attention.launches == before  # the int8 path has no kernel

    win, cur = jnp.asarray([18, 20], jnp.int32), jnp.asarray([30, 24], jnp.int32)
    ref = jgs.compact_window(jcache, win, cur, hist)
    out = tgs.compact_window(_cache_to_torch(jcache),
                             torch.tensor(np.asarray(win), dtype=torch.long),
                             torch.tensor(np.asarray(cur), dtype=torch.long), hist)
    np.testing.assert_array_equal(out["slot_pos"].numpy(), np.asarray(ref["slot_pos"]))
    for key in ("k", "v"):
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(ref[key]).transpose(0, 1, 2, 4, 3))
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))


def test_quant_init_and_bytes(setup):
    *_, config, _ = setup
    bf16 = tgs.init_stream_cache(config, 3, 40)
    int8 = tgs.init_stream_cache(config, 3, 40, quant=True)
    assert int8["k"].dtype == torch.int8 and int8["k"].shape == bf16["k"].shape
    assert int8["k_scale"].shape == bf16["k"].shape[:-1]
    kv_bytes = {name: sum(c[k].numel() * c[k].element_size() for k in c if k != "slot_pos")
                for name, c in (("bf16", bf16), ("int8", int8))}
    D = config.head_dim
    assert kv_bytes["int8"] * 2 * D == kv_bytes["bf16"] * (D + 4)


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_greedy_quant_engine_matches_jax(setup, seed):
    """Token for token up to the first divergence, if any; there the JAX
    int8 logits must be a near-tie."""
    jconfig, params, config, model = setup
    bars, attrs = _song(n_bars=6, seed=seed)
    jax_out = jgs.StreamingGenerationEngine(jconfig, kv_quant=True, **ENGINE_KW).generate(
        params, bars, attrs, temperature=0.0)
    engine = tgs.StreamingGenerationEngine(config, kv_quant=True, **ENGINE_KW)
    ours = engine.generate(model, bars, attrs, temperature=0.0)
    assert len(ours) == len(jax_out)
    diverged = next(((i, s - 1) for i, (a, b) in enumerate(zip(ours, jax_out))
                     for s in range(max(len(a), len(b)))
                     if s >= min(len(a), len(b)) or a[s] != b[s]), None)
    if diverged is None:
        return
    logits = next(l for at, l in _jax_replay(jconfig, params, engine, bars, attrs, jax_out,
                                               quant=True) if at == diverged)
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] < TIE_MARGIN, (
        f"bar {diverged[0]} step {diverged[1]}: greedy divergence at a margin "
        f"of {top2[1] - top2[0]:.3g}")


def test_quant_replay_reproduces_jax_engine(setup):
    """The int8 replay is faithful: its argmax at every step is the JAX
    engine's next token."""
    jconfig, params, config, _ = setup
    bars, attrs = _song(n_bars=3, seed=3)
    jax_out = jgs.StreamingGenerationEngine(jconfig, kv_quant=True, **ENGINE_KW).generate(
        params, bars, attrs, temperature=0.0)
    engine = tgs.StreamingGenerationEngine(config, kv_quant=True, **ENGINE_KW)
    for (i, step), logits in _jax_replay(jconfig, params, engine, bars, attrs, jax_out,
                                          quant=True):
        assert int(np.argmax(logits)) == jax_out[i][step + 1], (i, step)


@pytest.mark.cuda
def test_quant_chunks_on_card_match_cpu(setup):
    """The int8 engine on the card against the CPU: the same int8 arithmetic
    on both, so the greedy songs agree up to a near-tie in the card's own
    logits, and no kernel is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    *_, config, model = setup
    from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

    card = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda")
    engine = tgs.StreamingGenerationEngine(config, kv_quant=True, **ENGINE_KW)
    bars, attrs = _song(n_bars=4, seed=2)
    before = decode_attention.launches
    on_card = engine.generate(card, bars, attrs)
    assert decode_attention.launches == before
    assert len(on_card) == len(engine.generate(model, bars, attrs)) == 4
