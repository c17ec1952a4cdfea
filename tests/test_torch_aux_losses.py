"""The auxiliary models' objectives in the port (etude_tpu_torch/models/
{beat_transformer,amt,separator}.py `loss_fn`) against the JAX package's, f32
on both sides, at narrow widths, on the same numpy parameters (the port's
`init_*_params_np`, bit-equal to the JAX `init_params`) and the same numpy
batches; and the reverse weight bridges.

Tolerances: losses and metrics to 1e-5 relative (the same arithmetic summed
in another order). Gradients leaf by leaf, carried into the JAX tree by the
reverse bridges, to 1e-4 of that leaf's largest |g|, or of 1e-6 of the
model's largest |g| where that is more: f32 sums round relative to their
terms, not to their result, so a leaf whose gradient nearly cancels (the
hFT's time-layer key matrix at initialisation, 5e-8 of the model's largest
|g|) carries noise of that order in both packages. The attention key biases
are the extreme case, as in tests/test_torch_train_step.py: they add the
same q·b to every key's score, which the softmax cancels, so their true
gradient is zero; the test checks that JAX's is below 1e-6 of the model's.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.models import amt as jax_amt
from etude_tpu.models import beat_transformer as jax_bt
from etude_tpu.models import separator as jax_sep
from etude_tpu_torch.models import amt, beat_transformer as bt, separator as sep
from etude_tpu_torch.weights import (
    amt_from_jax, amt_to_jax, beat_transformer_from_jax, beat_transformer_to_jax,
    init_amt_params_np, init_beat_params_np, init_separator_params_np,
    separator_from_jax, separator_to_jax,
)

REL = 1e-5
GRAD_REL = 1e-4
ZERO_GRAD_REL = 1e-6

BEAT = dict(dmodel=32, nhead=8, d_hid=64, nlayers=4, instr_layers=(1, 2))
AMT = dict(n_margin=4, n_frame=12, n_bin=24, hid_dim=16, pf_dim=32, encoder_n_layer=2,
           decoder_n_layer=3, encoder_n_head=2, decoder_n_head=2, n_velocity=16)
# At least two channels per GroupNorm group, as at the published widths (with
# one channel per group a conv bias has no gradient).
SEP = dict(base_channels=8, depth=2, freq_bins=32, channel_cap=16)
# Leaves whose true gradient is zero (the key biases), by their JAX path.
ZERO_GRAD = {"beat": r"layers/\d+/(instr/)?k/b$", "amt": r"(attn|self|cross)/k/b$",
             "separator": None}


def flat(tree, prefix=""):
    """{"/"-joined path: numpy array} of a JAX-layout tree."""
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for key, value in items:
        path = f"{prefix}{key}"
        if isinstance(value, (dict, list)):
            out.update(flat(value, path + "/"))
        else:
            out[path] = np.asarray(value)
    return out


def beat_batch(seed, mask):
    rng = np.random.default_rng(seed)
    B, T = 2, 40
    act = rng.choice([0.0, 0.5, 1.0], size=(B, T, 2), p=[0.8, 0.1, 0.1]).astype(np.float32)
    batch = {"x": rng.uniform(-80, 0, size=(B, 5, T, 128)).astype(np.float32),
             "activations": act, "tempo": rng.integers(0, 300, B).astype(np.int32)}
    if mask:
        m = np.ones((B, T), np.float32)
        m[1, 25:] = 0.0
        batch["mask"] = m
    return batch


def amt_batch(seed, config):
    rng = np.random.default_rng(seed)
    B, T, N = 2, config.n_frame, config.n_note
    width = config.n_frame + 2 * config.n_margin
    onset = np.where(rng.random((B, T, N)) < 0.05, rng.random((B, T, N)), 0).astype(np.float32)
    offset = np.where(rng.random((B, T, N)) < 0.05, rng.random((B, T, N)), 0).astype(np.float32)
    mpe = (rng.random((B, T, N)) < 0.1).astype(np.float32)
    velocity = np.where(mpe > 0, rng.integers(1, config.n_velocity, (B, T, N)), 0).astype(np.int32)
    return {"spec": rng.normal(-6, 3, size=(B, config.n_bin, width)).astype(np.float32),
            "onset": onset, "offset": offset, "mpe": mpe, "velocity": velocity}


def sep_batch(seed):
    rng = np.random.default_rng(seed)
    stems = rng.gamma(1.0, 0.5, size=(2, 5, 12, 40)).astype(np.float32)
    return {"mix_mag": stems.sum(axis=1), "stem_mags": stems}


def torch_batch(batch):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}


AMT_WEIGHTS = {"onset": 120.0, "offset": 60.0, "mpe": 3.0, "velocity": 1.0,
               "velocity_silent": 0.0}
AMT_SCALES = {"onset": 5.0, "offset": 5.0, "mpe": 1.0, "velocity": 0.1}


def case(name, variant):
    """(port model, port loss, JAX params, JAX loss, to_jax) for one model."""
    if name == "beat":
        cfg, jcfg = bt.BeatTransformerConfig(**BEAT), jax_bt.BeatTransformerConfig(**BEAT)
        params = init_beat_params_np(cfg, seed=3)
        batch = beat_batch(4, mask=variant == "mask")
        model = beat_transformer_from_jax(params, cfg)
        return (model, lambda m: bt.loss_fn(m, torch_batch(batch), torch.float32),
                params, lambda p: jax_bt.loss_fn(p, jcfg, batch, jnp.float32),
                beat_transformer_to_jax)
    if name == "amt":
        cfg, jcfg = amt.AMTConfig(**AMT), jax_amt.AMTConfig(**AMT)
        params = init_amt_params_np(cfg, seed=5)
        batch = amt_batch(6, cfg)
        kw = ({"pos_weights": AMT_WEIGHTS, "head_scales": AMT_SCALES}
              if variant == "weighted" else {})
        model = amt_from_jax(params, cfg)
        return (model, lambda m: amt.loss_fn(m, torch_batch(batch), torch.float32, **kw),
                params, lambda p: jax_amt.loss_fn(p, jcfg, batch, jnp.float32, **kw),
                amt_to_jax)
    cfg, jcfg = sep.SeparatorConfig(**SEP), jax_sep.SeparatorConfig(**SEP)
    params = init_separator_params_np(cfg, seed=7)
    batch = sep_batch(8)
    model = separator_from_jax(params, cfg)

    def jax_loss(p):
        value = jax_sep.loss_fn(p, jcfg, batch, jnp.float32)
        return value, {"loss": value}

    def port_loss(m):
        value = sep.loss_fn(m, torch_batch(batch), torch.float32)
        return value, {"loss": value}

    return model, port_loss, params, jax_loss, separator_to_jax


CASES = [("beat", "plain"), ("beat", "mask"), ("amt", "plain"), ("amt", "weighted"),
         ("separator", "plain")]


@pytest.mark.parametrize("name,variant", CASES)
def test_loss_metrics_and_gradients_match_jax(name, variant):
    model, port_loss, params, jax_loss, to_jax = case(name, variant)
    model.train().requires_grad_(True)
    loss, metrics = port_loss(model)
    loss.backward()
    grads = flat(to_jax(model, {n: p.grad for n, p in model.named_parameters()}))

    jparams = jax.tree.map(jnp.asarray, params)
    (jloss, jmetrics), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jparams)
    assert set(metrics) == set(jmetrics)
    for key in jmetrics:
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]), rtol=REL,
                                   err_msg=key)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=REL)

    jgrads = flat(jgrads)
    assert set(grads) == set(jgrads)
    top = max(np.abs(g).max() for g in jgrads.values())
    for key, ref in jgrads.items():
        if ZERO_GRAD[name] and re.search(ZERO_GRAD[name], key):
            assert np.abs(ref).max() <= ZERO_GRAD_REL * top, key
        floor = max(np.abs(ref).max(), ZERO_GRAD_REL * top)
        np.testing.assert_allclose(grads[key], ref, rtol=0, atol=GRAD_REL * floor,
                                   err_msg=key)


def test_amt_gradient_reaches_the_folded_front_end():
    """The front end is folded per call (conv and token embedding into one
    filter); its gradient reaches conv_w, conv_b and tok_emb."""
    model, port_loss, *_ = case("amt", "plain")
    model.train().requires_grad_(True)
    port_loss(model)[0].backward()
    for p in (model.conv_w, model.conv_b, model.tok_emb.weight, model.tok_emb.bias):
        assert p.grad is not None and p.grad.abs().max() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_amt_remat_equals_no_remat(dtype):
    """torch.utils.checkpoint recomputes the same layer bodies: the loss and
    every gradient are bit-equal with and without remat."""
    cfg = amt.AMTConfig(**AMT)
    batch = torch_batch(amt_batch(9, cfg))
    results = []
    for remat in (False, True):
        model = amt_from_jax(init_amt_params_np(cfg, seed=1), cfg).train().requires_grad_(True)
        loss, _ = amt.loss_fn(model, batch, dtype, remat=remat, pos_weights=AMT_WEIGHTS,
                              head_scales=AMT_SCALES)
        loss.backward()
        results.append((loss.detach(), [p.grad for p in model.parameters()]))
    (l0, g0), (l1, g1) = results
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["beat", "amt", "separator"])
def test_reverse_bridges_are_exact_inverses(name):
    """*_to_jax(*_from_jax(tree)) is the tree, bit for bit, lists included."""
    model, _, params, _, to_jax = case(name, "plain")
    back = to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for key, value in flat(params).items():
        got = flat(back)[key]
        assert got.dtype == np.float32 and got.shape == value.shape, key
        np.testing.assert_array_equal(got, value, err_msg=key)


@pytest.mark.parametrize("name", ["beat", "amt", "separator"])
def test_param_count_matches_jax(name):
    model, _, params, _, _ = case(name, "plain")
    count = {"beat": bt, "amt": amt, "separator": sep}[name].param_count(model)
    jax_count = {"beat": jax_bt, "amt": jax_amt, "separator": jax_sep}[name].param_count(
        jax.tree.map(jnp.asarray, params))
    assert count == jax_count
