"""The port's training step (etude_tpu_torch/parallel/train_step.py) against
the JAX package's (etude_tpu/parallel/train_step.py), f32 on both sides, on
the tiny config of tests/test_train.py, both packages starting from the same
parameter tree (init_decoder_params_np, bit-exact with the JAX init_params).

Tolerances: the schedule to one f32 ulp of the peak rate (both evaluate it in
f32; XLA's and PyTorch's cos may differ in the last bit); per step, losses
and grad norms to 1e-5 relative, accuracy to 1e-6, step and grads_finite
equal, every parameter and Adam moment to 1e-6 absolute (the same math
summed in another order; the parameters are O(0.02) and a step moves them by
at most about the rate, 1e-3). One exception, `key_bias_noise`: the key
biases outside the rotary dims have an exactly zero gradient (they add the
same q·b to every key's score, which the softmax cancels), so what each
package computes there is rounding noise, which Adam's normalization turns
into steps of either sign as large as the rate; those entries are held to
twice the sum of the rates applied so far instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from etude_tpu.models.decoder import EtudeDecoderConfig as JaxConfig
from etude_tpu.models.decoder import init_params
from etude_tpu.parallel.train_step import init_train_state as jax_init_state
from etude_tpu.parallel.train_step import make_lr_schedule as jax_schedule
from etude_tpu.parallel.train_step import make_optimizer as jax_optimizer
from etude_tpu.parallel.train_step import make_train_step as jax_train_step
from etude_tpu.parallel.train_step import reshape_for_accum as jax_reshape
from etude_tpu_torch.models.decoder import ATTRIBUTE_ORDER, EtudeDecoderConfig, loss_fn
from etude_tpu_torch.parallel.train_step import (
    init_train_state, make_lr_schedule, make_optimizer, make_train_step,
    reshape_for_accum,
)
from etude_tpu_torch.weights import decoder_from_jax, decoder_to_jax, init_decoder_params_np

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64, attribute_emb_dim=8)
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5


def make_batch(rng, vocab=64, B=8, T=16):
    """The batch of tests/test_train.py `_batch`, with padded rows so the
    attention mask matters."""
    ids = rng.integers(4, vocab, (B, T)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1).astype(np.int32)
    labels[:, -1] = -100
    labels[:, : T // 2] = -100
    mask = np.ones((B, T), np.int32)
    mask[1, 12:] = 0
    labels[1, 11:] = -100
    batch = {
        "input_ids": ids,
        "class_ids": rng.integers(1, 3, (B, T)).astype(np.int32),
        "labels": labels,
        "attention_mask": mask,
    }
    for name in ATTRIBUTE_ORDER:
        batch[f"{name}_bin_ids"] = rng.integers(0, 3, (B, T)).astype(np.int32)
    return batch


def adam_moments(opt_state):
    """(mu, nu, count) of the JAX optimizer state."""
    adam = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return adam[0].mu, adam[0].nu, int(adam[0].count)


def port_moments(state):
    names = [n for n, _ in state.model.named_parameters()]
    from etude_tpu_torch.weights import decoder_state_to_jax

    mu = decoder_state_to_jax(dict(zip(names, state.opt_state.mu)), state.model.config)
    nu = decoder_state_to_jax(dict(zip(names, state.opt_state.nu)), state.model.config)
    return mu, nu, int(state.opt_state.count)


def key_bias_noise(config) -> np.ndarray:
    """Mask over layers/qkv/b ([L, 3H]) of the key-bias entries outside the
    rotary dims (per head the slots are [q_h | k_h | v_h])."""
    D, H = config.head_dim, config.num_attention_heads
    mask = np.zeros((config.num_hidden_layers, 3 * config.hidden_size), bool)
    for h in range(H):
        mask[:, h * 3 * D + D + config.rotary_dim: h * 3 * D + 2 * D] = True
    return mask


def assert_trees_close(ours, ref, atol, what):
    ref_leaves, ref_def = jax.tree.flatten(ref)
    our_leaves, our_def = jax.tree.flatten(ours)
    assert ref_def == our_def
    for a, b in zip(our_leaves, ref_leaves):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=atol, err_msg=what)


def assert_params_close(ours, ref, noise_atol):
    noise = key_bias_noise(EtudeDecoderConfig(**TINY))
    qkv_b, ref_qkv_b = ours["layers"]["qkv"]["b"], np.asarray(ref["layers"]["qkv"]["b"])
    np.testing.assert_allclose(qkv_b[noise], ref_qkv_b[noise], rtol=0, atol=noise_atol)
    ours = jax.tree.map(lambda a: a, ours)
    ours["layers"]["qkv"]["b"] = np.where(noise, ref_qkv_b, qkv_b)
    assert_trees_close(ours, ref, PARAM_ATOL, "params")


class Pair:
    """The JAX step and the port's step side by side, from the same tree."""

    def __init__(self, clip=1.0, lr=1e-3, warmup=2, total=10, seed=0):
        kw = dict(learning_rate=lr, warmup_steps=warmup, total_steps=total,
                  clip_grad_norm=clip)
        tx, _ = jax_optimizer(**kw)
        self.jax_state = jax_init_state(init_params(JaxConfig(**TINY), seed=seed), tx)
        self.jax_step = jax_train_step(JaxConfig(**TINY), tx, compute_dtype=jnp.float32)
        config = EtudeDecoderConfig(**TINY)
        model = decoder_from_jax(init_decoder_params_np(config, seed), config)
        ptx, _ = make_optimizer(**kw)
        self.state = init_train_state(model, ptx)
        self.step_fn = make_train_step(config, ptx, compute_dtype=torch.float32)
        self.schedule = ptx.schedule
        self.rates = 0.0   # the sum of the rates applied so far

    def step(self, batch):
        self.rates += float(self.schedule(self.state.opt_state.count))
        return self._step(batch)

    def _step(self, batch):
        jb = {k: jnp.asarray(v) for k, v in jax_reshape(batch, 2).items()}
        self.jax_state, jm = self.jax_step(self.jax_state, jb)
        tb = {k: torch.from_numpy(v) for k, v in reshape_for_accum(batch, 2).items()}
        m = self.step_fn(self.state, tb)
        return ({k: float(v) for k, v in m.items()},
                {k: float(v) for k, v in jm.items()})

    def check(self, ours, ref):
        assert ours["grads_finite"] == ref["grads_finite"]
        for key in ("loss", "grad_norm"):
            if np.isnan(ref[key]):
                assert np.isnan(ours[key])
            else:
                np.testing.assert_allclose(ours[key], ref[key], rtol=LOSS_RTOL)
        np.testing.assert_allclose(ours["accuracy"], ref["accuracy"], atol=1e-6)
        assert int(self.state.step) == int(self.jax_state.step)
        assert int(self.state.skipped) == int(self.jax_state.skipped)
        assert_params_close(decoder_to_jax(self.state.model), self.jax_state.params,
                            2 * self.rates)
        mu, nu, count = port_moments(self.state)
        jmu, jnu, jcount = adam_moments(self.jax_state.opt_state)
        assert count == jcount
        assert_trees_close(mu, jmu, PARAM_ATOL, "mu")
        assert_trees_close(nu, jnu, PARAM_ATOL, "nu")


@pytest.mark.parametrize("warmup,total", [(10, 100), (2, 10), (1, 5), (0, 1), (7, 7)])
def test_schedule_equals_optax(warmup, total):
    ours = make_lr_schedule(2e-4, warmup, total)
    ref = jax_schedule(2e-4, warmup, total)
    steps = np.arange(0, total + 3)
    got = np.array([float(ours(torch.tensor(s, dtype=torch.int32))) for s in steps])
    want = np.array([float(ref(jnp.int32(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(np.float32(2e-4)))
    assert got[0] == 0.0


@pytest.mark.parametrize("clip", [1e3, 1e-3], ids=["no-clip", "clip"])
def test_six_accumulated_steps_match_jax(clip):
    pair = Pair(clip=clip)
    rng = np.random.default_rng(7)
    norms = []
    for _ in range(6):
        ours, ref = pair.step(make_batch(rng))
        pair.check(ours, ref)
        norms.append(ref["grad_norm"])
    # The clip case clips every step; the other never does.
    assert all((n >= clip) == (clip < 1) for n in norms)
    assert int(pair.state.opt_state.count) == 6


def test_nonfinite_gradients_skip_then_next_step_matches_jax():
    pair = Pair()
    rng = np.random.default_rng(3)
    pair.check(*pair.step(make_batch(rng)))

    # Poison the attribute-projection bias (tests/test_train.py:104-111).
    bias = pair.jax_state.params["attr_proj"]["b"]
    good = float(bias[0])
    pair.jax_state = pair.jax_state._replace(params={
        **pair.jax_state.params,
        "attr_proj": {**pair.jax_state.params["attr_proj"], "b": bias.at[0].set(jnp.nan)},
    })
    with torch.no_grad():
        pair.state.model.attr_proj.bias[0] = float("nan")
    before = [t.clone() for t in pair.state.params()]
    moments = [t.clone() for t in pair.state.opt_state.mu + pair.state.opt_state.nu]
    count = int(pair.state.opt_state.count)
    ours, ref = pair.step(make_batch(rng))
    assert ours["grads_finite"] == ref["grads_finite"] == 0
    assert int(pair.state.step) == 2 and int(pair.state.skipped) == 1
    assert int(pair.state.opt_state.count) == count
    for a, b in zip(pair.state.params(), before):
        assert torch.equal(a, b) or torch.equal(a.isnan(), b.isnan())
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(pair.state.opt_state.mu + pair.state.opt_state.nu, moments):
        assert torch.equal(a, b)
    pair.check(ours, ref)

    # Repaired, the next step runs at the count before the skip, as JAX's.
    pair.jax_state = pair.jax_state._replace(params={
        **pair.jax_state.params,
        "attr_proj": {**pair.jax_state.params["attr_proj"],
                      "b": pair.jax_state.params["attr_proj"]["b"].at[0].set(good)},
    })
    with torch.no_grad():
        pair.state.model.attr_proj.bias[0] = good
    pair.check(*pair.step(make_batch(rng)))
    assert int(pair.state.step) == 3 and int(pair.state.opt_state.count) == 2


def test_remat_gives_the_same_loss_and_gradients():
    config = EtudeDecoderConfig(**TINY)
    model = decoder_from_jax(init_decoder_params_np(config, 0), config).requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in
             make_batch(np.random.default_rng(0)).items()}
    results = []
    for remat in (False, True):
        model.zero_grad()
        loss, metrics = loss_fn(model, batch, torch.float32, remat=remat)
        loss.backward()
        results.append((loss.detach(), metrics["accuracy"],
                        [p.grad.clone() for p in model.parameters()]))
    (l0, a0, g0), (l1, a1, g1) = results
    assert torch.equal(l0, l1) and torch.equal(a0, a1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
