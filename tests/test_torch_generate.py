"""The port's KV-cache forward and rebuild engine
(etude_tpu_torch/models/decoder.py `forward_with_cache`,
models/generate.py) against the JAX package's (etude_tpu/models/decoder.py,
models/generate.py), on the same seeded weights and inputs.

The port's cache is [L, B, H, T, D] where JAX's is [L, B, T, H, D]; the
tests transpose. The tiny decoder is drawn with init std 0.1, as in
tests/test_torch_generate_stream.py, so greedy bars run to their limit and
the comparison covers whole bars. Tolerances follow that file: both sides
compute in bf16 with f32 rotary, LayerNorm, softmax and LM head, so logits
are held to atol 2e-2 (the packages differed by at most 1.3e-2 on the
stream engine's chunks) and K/V to one bf16 ulp at |x| <= 2 (atol = rtol =
2e-2). A greedy divergence is accepted only at a near-tie: the JAX logits'
top-2 margin at the diverging step must be below 1.75e-2. Prompt assembly
and packing are host integer work and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.models import decoder as jdec
from etude_tpu.models import generate as jgen
from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu_torch.data.tokenizer import SRC_CLASS_ID, TGT_CLASS_ID
from etude_tpu_torch.models import generate as tgen
from etude_tpu_torch.models.decoder import (ATTRIBUTE_ORDER, EtudeDecoderConfig,
                                            forward_with_cache, init_cache)
from etude_tpu_torch.ops.decode_attention import decode_attention
from etude_tpu_torch.weights import decoder_from_jax, init_decoder_params_np

LOGIT_TOL = dict(atol=2e-2, rtol=0)
KV_TOL = dict(atol=2e-2, rtol=2e-2)
TIE_MARGIN = 1.75e-2
TINY = dict(vocab_size=32, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=128, attribute_emb_dim=8,
            initializer_range=0.1)
BOS, EOS = 4, 5
ENGINE_KW = dict(bar_bos_id=BOS, bar_eos_id=EOS, pad_id=0, prompt_buckets=(32, 64, 96),
                 max_bar_token_limit=32)


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
    params = jdec.init_params(jconfig, seed=0)
    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config)
    return jconfig, params, config, model


def _song(n_bars=6, notes_per_bar=3, seed=0):
    rng = np.random.default_rng(seed)
    bars = [[BOS] + rng.integers(6, 32, notes_per_bar).tolist() + [EOS]
            for _ in range(n_bars)]
    attrs = [{k: int(rng.integers(0, 3)) for k in jgen.ATTR_KEYS} for _ in range(n_bars)]
    return bars, attrs


def _jax_cache_layout(t):
    """Port cache [L, B, H, T, D] → JAX's [L, B, T, H, D], as f32 numpy."""
    return t.float().numpy().transpose(0, 1, 3, 2, 4)


def test_forward_with_cache_matches_jax(setup):
    """A left-padded prefill (S = 16) and 8 S = 1 steps, from the same
    cache, against JAX's `forward_with_cache`: logits and the cache."""
    jconfig, params, config, model = setup
    rng = np.random.default_rng(0)
    B, P, steps = 2, 16, 8
    C = P + steps
    visible_from = np.array([3, 0])
    ids = rng.integers(6, 32, (B, P))
    cls = rng.integers(1, 3, (B, P))
    attrs = {n: rng.integers(0, 3, (B, P)) for n in ATTRIBUTE_ORDER}
    positions = np.maximum(np.arange(P)[None] - visible_from[:, None], 0)
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.long)  # noqa: E731

    jcache = jdec.init_cache(jconfig, B, length=C)
    cache = init_cache(config, B, length=C)
    ref, jcache = jdec.forward_with_cache(
        params, jconfig, jcache, i32(ids), i32(cls), {k: i32(v) for k, v in attrs.items()},
        write_pos=jnp.int32(0), positions=i32(positions), visible_from=i32(visible_from))
    with torch.no_grad():
        out, cache = forward_with_cache(model, cache, t(ids), t(cls),
                                        {k: t(v) for k, v in attrs.items()}, 0,
                                        t(positions), t(visible_from))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)

    before = decode_attention.launches
    for step in range(steps):
        tok = rng.integers(6, 32, (B, 1))
        step_attrs = {n: rng.integers(0, 3, (B, 1)) for n in ATTRIBUTE_ORDER}
        pos = (P + step - visible_from)[:, None]
        ref, jcache = jdec.forward_with_cache(
            params, jconfig, jcache, i32(tok), i32(np.full((B, 1), TGT_CLASS_ID)),
            {k: i32(v) for k, v in step_attrs.items()}, write_pos=jnp.int32(P + step),
            positions=i32(pos), visible_from=i32(visible_from))
        with torch.no_grad():
            out, cache = forward_with_cache(model, cache, t(tok),
                                            t(np.full((B, 1), TGT_CLASS_ID)),
                                            {k: t(v) for k, v in step_attrs.items()},
                                            P + step, t(pos), t(visible_from))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **LOGIT_TOL)
    assert decode_attention.launches == before  # CPU tensors take the plain version
    for key in ("k", "v"):
        np.testing.assert_allclose(_jax_cache_layout(cache[key]),
                                   np.asarray(jcache[key].astype(jnp.float32)), **KV_TOL)


def _history(n, seed):
    rng = np.random.default_rng(seed)
    return [([BOS] + rng.integers(6, 32, int(rng.integers(0, 9))).tolist() + [EOS],
             [BOS] + rng.integers(6, 32, int(rng.integers(0, 12))).tolist() + [EOS],
             {k: int(rng.integers(0, 3)) for k in jgen.ATTR_KEYS})
            for _ in range(n)]


@pytest.mark.parametrize("n_hist,x_len", [(0, 3), (2, 5), (4, 7), (7, 2), (6, 80)],
                         ids=["empty", "short", "full", "long-history", "truncated"])
def test_build_and_pack_prompts_equal_jax(setup, n_hist, x_len):
    """The prompt contract (history pairs, neutral empty bars, the target
    attributes on the condition bar, Bar_BOS, truncation to max_pos x
    overlap) and the left-padded bucket packing, value for value."""
    jconfig, _, config, _ = setup
    jengine = jgen.GenerationEngine(jconfig, **ENGINE_KW)
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    assert engine.prompt_buckets == jengine.prompt_buckets
    assert engine.prompt_cap == jengine.prompt_cap
    rng = np.random.default_rng(n_hist + x_len)
    prompts = []
    for b in range(3):
        history = _history(n_hist, seed=10 * b + n_hist)
        x = [BOS] + rng.integers(6, 32, x_len + b).tolist() + [EOS]
        attrs = {k: int(rng.integers(0, 3)) for k in jgen.ATTR_KEYS}
        ours = engine.build_prompt(history, x, attrs)
        assert ours == jengine.build_prompt(history, x, attrs)
        prompts.append(ours)
    assert len(prompts[-1][0]) <= engine.prompt_cap
    ids, cls, attrs, visible_from, P = engine._pack_prompts(prompts)
    j_ids, j_cls, j_attrs, j_visible, j_P = jengine._pack_prompts(prompts)
    assert P == j_P
    np.testing.assert_array_equal(ids, j_ids)
    np.testing.assert_array_equal(cls, j_cls)
    np.testing.assert_array_equal(visible_from, j_visible)
    for k in jgen.ATTR_KEYS:
        np.testing.assert_array_equal(attrs[k], j_attrs[k])


_jax_fwc = jax.jit(jdec.forward_with_cache, static_argnums=(1,))


def _jax_bar_logits(jconfig, params, engine, prompt, cur_attrs, tokens):
    """The JAX logits each token of a bar was sampled from, teacher-forced
    with `tokens` (the bar without its Bar_BOS): one prompt, B = 1."""
    ids, cls, attrs, visible_from, P = engine._pack_prompts([prompt])
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    cache = jdec.init_cache(jconfig, 1, length=P + len(tokens))
    positions = np.maximum(np.arange(P)[None] - visible_from[:, None], 0)
    logits, cache = _jax_fwc(params, jconfig, cache, i32(ids), i32(cls),
                             {jgen._ATTR_KEY_TO_NAME[k]: i32(v) for k, v in attrs.items()},
                             jnp.int32(0), i32(positions), i32(visible_from))
    out = [np.asarray(logits[0, -1])]
    step_attrs = {jgen._ATTR_KEY_TO_NAME[k]: i32([[v]]) for k, v in cur_attrs.items()}
    for step, tok in enumerate(tokens[:-1]):
        logits, cache = _jax_fwc(params, jconfig, cache, i32([[tok]]), i32([[TGT_CLASS_ID]]),
                                 step_attrs, jnp.int32(P + step),
                                 i32([[P + step - visible_from[0]]]), i32(visible_from))
        out.append(np.asarray(logits[0, 0]))
    return out


def _first_divergence(ours, ref):
    """(bar, step) of the first token that differs, else None; a bar whose
    length differs diverges where the shorter one ends."""
    return next(((i, s - 1) for i, (a, b) in enumerate(zip(ours, ref))
                 for s in range(max(len(a), len(b)))
                 if s >= min(len(a), len(b)) or a[s] != b[s]), None)


def _assert_near_tie(logits, where):
    top2 = np.sort(logits)[-2:]
    assert top2[1] - top2[0] < TIE_MARGIN, (
        f"{where}: greedy divergence at a margin of {top2[1] - top2[0]:.3g}")


def test_generate_bar_matches_jax(setup):
    """One bar for 3 left-padded streams, greedy: token for token against
    JAX's `generate_bar` up to a near-tie."""
    jconfig, params, config, model = setup
    jengine = jgen.GenerationEngine(jconfig, **ENGINE_KW)
    rng = np.random.default_rng(7)
    prompts, cur = [], []
    for b in range(3):
        x = [BOS] + rng.integers(6, 32, 3 + 4 * b).tolist() + [EOS]
        attrs = {k: int(rng.integers(0, 3)) for k in jgen.ATTR_KEYS}
        prompts.append(jengine.build_prompt(_history(b + 1, seed=b), x, attrs))
        cur.append(attrs)
    ids, cls, attrs_np, visible_from, _ = jengine._pack_prompts(prompts)
    cur_np = {jgen._ATTR_KEY_TO_NAME[k]: np.array([c[k] for c in cur]) for k in jgen.ATTR_KEYS}
    i32 = lambda a: jnp.asarray(a, jnp.int32)  # noqa: E731
    t = lambda a: torch.tensor(np.asarray(a), dtype=torch.long)  # noqa: E731
    j_tokens, j_counts = jgen.generate_bar(
        params, jconfig, i32(ids), i32(cls),
        {jgen._ATTR_KEY_TO_NAME[k]: i32(v) for k, v in attrs_np.items()}, i32(visible_from),
        {k: i32(v) for k, v in cur_np.items()}, jax.random.PRNGKey(0), jnp.float32(0.0),
        jnp.float32(0.9), max_new_tokens=32, bar_eos_id=EOS, pad_id=0)
    stats = {}
    tokens, counts = tgen.generate_bar(
        model, t(ids), t(cls), {jgen._ATTR_KEY_TO_NAME[k]: t(v) for k, v in attrs_np.items()},
        t(visible_from), {k: t(v) for k, v in cur_np.items()}, None, 0.0, 0.9,
        max_new_tokens=32, bar_eos_id=EOS, pad_id=0, stats=stats)
    assert 1 <= stats["single_token_steps"] <= 32
    ref = [np.asarray(j_tokens)[b, :int(j_counts[b])].tolist() for b in range(3)]
    ours = [tokens[b, :int(counts[b])].tolist() for b in range(3)]
    for b in range(3):
        assert (tokens[b, int(counts[b]):] == 0).all()
        at = _first_divergence([ours[b]], [ref[b]])
        if at is not None:
            logits = _jax_bar_logits(jconfig, params, jengine, prompts[b], cur[b], ref[b])
            _assert_near_tie(logits[at[1] + 1], f"stream {b} step {at[1] + 1}")


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_greedy_engine_matches_jax(setup, seed):
    """A whole song, greedy: bar for bar up to the first divergence, if any;
    there the JAX logits must be a near-tie."""
    jconfig, params, config, model = setup
    bars, attrs = _song(n_bars=6, seed=seed)
    jengine = jgen.GenerationEngine(jconfig, **ENGINE_KW)
    jax_out = jengine.generate(params, bars, attrs, temperature=0.0)
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    ours = engine.generate(model, bars, attrs, temperature=0.0)
    assert len(ours) == len(jax_out) == len(bars)
    at = _first_divergence(ours, jax_out)
    if at is None:
        return
    i, step = at
    history = [(bars[j], jax_out[j], attrs[j]) for j in range(i)]
    prompt = jengine.build_prompt(history, bars[i], attrs[i])
    logits = _jax_bar_logits(jconfig, params, jengine, prompt, attrs[i], jax_out[i][1:])
    _assert_near_tie(logits[step], f"bar {i} step {step}")


def test_jax_bar_replay_reproduces_the_jax_engine(setup):
    """The replay used above is faithful: its argmax at every step of every
    bar is the JAX engine's next token."""
    jconfig, params, _, _ = setup
    bars, attrs = _song(n_bars=3, seed=3)
    jengine = jgen.GenerationEngine(jconfig, **ENGINE_KW)
    jax_out = jengine.generate(params, bars, attrs, temperature=0.0)
    for i, bar in enumerate(jax_out):
        history = [(bars[j], jax_out[j], attrs[j]) for j in range(i)]
        prompt = jengine.build_prompt(history, bars[i], attrs[i])
        logits = _jax_bar_logits(jconfig, params, jengine, prompt, attrs[i], bar[1:])
        assert [int(np.argmax(l)) for l in logits] == bar[1:]


def test_engine_structure_budget_and_steps(setup):
    """Sampled bars are well formed and reproducible for a seed; the global
    budget keeps the bar that crosses it; the engine counts one S = 1 step
    per generated token of the longest stream of each bar."""
    *_, config, model = setup
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    bars, attrs = _song(n_bars=5, notes_per_bar=6, seed=9)
    out = engine.generate(model, bars, attrs, temperature=0.8, seed=1)
    assert len(out) == 5
    for bar in out:
        assert bar[0] == BOS and len(bar) <= 33
        if EOS in bar:
            assert bar.index(EOS) == len(bar) - 1
    assert engine.generate(model, bars, attrs, temperature=0.8, seed=1) == out
    engine.stats["single_token_steps"] = 0
    greedy = engine.generate(model, bars, attrs)
    assert engine.stats["single_token_steps"] == sum(len(b) - 1 for b in greedy)
    short = engine.generate(model, bars, attrs, max_output_tokens=10)
    assert 1 <= len(short) < 5


def test_batch_lockstep_equals_single_streams(setup):
    """Streams of different lengths batched together give what each gives
    alone (greedy)."""
    *_, config, model = setup
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    bars1, attrs1 = _song(n_bars=4, seed=1)
    bars2, attrs2 = _song(n_bars=2, seed=2)
    outs = engine.generate_batch(model, [bars1, bars2], [attrs1, attrs2])
    assert len(outs[0]) == 4 and len(outs[1]) == 2
    assert outs[0] == engine.generate(model, bars1, attrs1)
    assert outs[1] == engine.generate(model, bars2, attrs2)


@pytest.mark.cuda
def test_rebuild_engine_on_card_launches_the_kernel_per_step():
    """On the card every S = 1 step launches the decode-attention kernel on
    each layer, and a bar's first logits agree with the CPU's (a decoder
    with the kernel's head width, 64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    config = EtudeDecoderConfig(**dict(TINY, hidden_size=128, num_attention_heads=2,
                                       intermediate_size=256))
    model = decoder_from_jax(init_decoder_params_np(config, seed=0), config)
    card = decoder_from_jax(init_decoder_params_np(config, seed=0), config, "cuda")
    engine = tgen.GenerationEngine(config, **ENGINE_KW)
    bars, attrs = _song(n_bars=3, seed=4)
    before = decode_attention.launches
    engine.generate(card, bars, attrs)
    torch.cuda.synchronize()
    assert (decode_attention.launches - before
            == engine.stats["single_token_steps"] * config.num_hidden_layers > 0)
    prompt = engine.build_prompt([], bars[0], attrs[0])
    ids, cls, attrs_np, visible_from, P = engine._pack_prompts([prompt])
    positions = np.maximum(np.arange(P)[None] - visible_from[:, None], 0)
    outs = []
    for m in (model, card):
        dev = next(m.parameters()).device
        t = lambda a: torch.tensor(np.asarray(a), dtype=torch.long, device=dev)  # noqa: E731
        with torch.no_grad():
            logits, cache = forward_with_cache(
                m, init_cache(config, 1, P + 1, dev), t(ids), t(cls),
                {tgen._ATTR_KEY_TO_NAME[k]: t(v) for k, v in attrs_np.items()}, 0,
                t(positions), t(visible_from))
            step, _ = forward_with_cache(
                m, cache, t([[7]]), t([[TGT_CLASS_ID]]),
                {tgen._ATTR_KEY_TO_NAME[k]: t([[v]]) for k, v in attrs[0].items()}, P,
                t([[P - visible_from[0]]]), t(visible_from))
        outs.append(torch.cat([logits[:, -1], step[:, 0]]).float().cpu())
    torch.testing.assert_close(outs[1], outs[0], **LOGIT_TOL)
