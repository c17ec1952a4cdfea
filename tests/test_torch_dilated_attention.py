"""The port's dilated attention (etude_tpu_torch/ops/dilated_attention.py)
against the JAX package's `dilated_attention`, `dilated_attention_stacked`
and `dilated_attention_pallas` (interpret mode on the CPU, as
tests/test_beat.py runs it), on the same numpy inputs.

Tolerances: in f32 the plain version and the JAX functions do the same
arithmetic in another summation order, so they agree to 1e-5 (the
precedent of tests/test_beat.py). In bf16 the plain version rounds once, at
its output, so it must equal its own f32 result rounded to bf16. On the
card the kernel sums in another order than the plain version, which can
flip an output rounding: two bf16 ulps of the largest |o|.

The gradient: on the CPU autograd differentiates the plain version, held
against jax.vjp of the JAX `dilated_attention` in f32 to 1e-5. On the card
the backward kernel K2b is held against that autograd in f32 from the same
bf16 inputs: dq, dk and dv within two bf16 ulps of each tensor's largest
|value| (they are rounded once to bf16), der within 1e-3 of its largest
|value| (f32 sums over B·T in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.ops.dilated_attention import (
    dilated_attention as jax_dilated,
    dilated_attention_pallas,
    dilated_attention_stacked,
    head_offsets as jax_head_offsets,
)
from etude_tpu_torch.ops.dilated_attention import (
    BWD_TILE,
    backward_tiles,
    dilated_attention,
    dilated_attention_backward,
    dilated_attention_backward_plain,
    dilated_attention_plain,
    head_offsets,
    strided_order,
)

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(B, H, T, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, T, d)).astype(np.float32) for _ in range(3))
    er = (0.1 * rng.normal(size=(H, d, 5))).astype(np.float32)
    return q, k, v, er


def _port(q, k, v, er, dilation, head7_bug=False):
    return dilated_attention(*(torch.tensor(a) for a in (q, k, v, er)), dilation,
                             head7_bug=head7_bug).numpy()


@pytest.mark.parametrize("n_heads", [8, 4])
def test_head_offsets_match_jax(n_heads):
    np.testing.assert_array_equal(head_offsets(n_heads, 5), jax_head_offsets(n_heads, 5))
    # Every head's slots include the query's own row, so no row is fully masked.
    assert (head_offsets(n_heads, 5) == 0).any(axis=1).all()


# B1 H8 T128 d32 at dilations 1 and 8 (tests/test_beat.py:218-236); T not a
# multiple of 128; dilation >= T/2 and > T (layer 8 on a short input).
CASES = [(1, 128, 1), (1, 128, 8), (2, 200, 3), (1, 100, 64), (1, 100, 128),
         (1, 100, 256)]


@pytest.mark.parametrize("B,T,dilation", CASES)
def test_plain_matches_jax_functions(B, T, dilation):
    q, k, v, er = _inputs(B, 8, T, 32, seed=T + dilation)
    out = _port(q, k, v, er, dilation)
    jq = [jnp.asarray(a) for a in (q, k, v, er)]
    np.testing.assert_allclose(out, np.asarray(jax_dilated(*jq, dilation)), **TOL)
    np.testing.assert_allclose(out, np.asarray(dilated_attention_stacked(*jq, dilation)),
                               **TOL)
    assert np.isfinite(out).all()


@pytest.mark.parametrize("B,T,dilation", CASES)
def test_plain_matches_pallas_interpret(B, T, dilation):
    q, k, v, er = _inputs(B, 8, T, 32, seed=T + dilation)
    ref = dilated_attention_pallas(*(jnp.asarray(a) for a in (q, k, v, er)), dilation,
                                   interpret=True)
    np.testing.assert_allclose(_port(q, k, v, er, dilation), np.asarray(ref), **TOL)


@pytest.mark.parametrize("dilation", [1, 8])
def test_head7_bug_matches_jax(dilation):
    q, k, v, er = _inputs(1, 8, 128, 32, seed=70 + dilation)
    jq = [jnp.asarray(a) for a in (q, k, v, er)]
    out = _port(q, k, v, er, dilation, head7_bug=True)
    np.testing.assert_allclose(
        out, np.asarray(jax_dilated(*jq, dilation, head7_bug=True)), **TOL)
    np.testing.assert_allclose(
        out, np.asarray(dilated_attention_stacked(*jq, dilation, head7_bug=True)), **TOL)
    # Only head 7 changes, and it does.
    plain = _port(q, k, v, er, dilation)
    np.testing.assert_array_equal(out[:, :7], plain[:, :7])
    assert np.abs(out[:, 7] - plain[:, 7]).max() > 1e-3


def test_other_head_counts_and_widths_match_jax():
    """The plain version follows head_offsets for any head count (no skewed
    heads unless H = 8) and any head width."""
    q, k, v, er = _inputs(2, 4, 50, 8, seed=3)
    ref = jax_dilated(*(jnp.asarray(a) for a in (q, k, v, er)), 2)
    np.testing.assert_allclose(_port(q, k, v, er, 2), np.asarray(ref), **TOL)


def test_bf16_rounds_once_at_the_output():
    q, k, v, er = (torch.tensor(a).bfloat16() for a in _inputs(2, 8, 96, 32, seed=9))
    out = dilated_attention_plain(q, k, v, er, 4)
    assert out.dtype == torch.bfloat16
    expect = dilated_attention_plain(q.float(), k.float(), v.float(), er.float(), 4)
    torch.testing.assert_close(out, expect.bfloat16(), atol=0, rtol=0)


def test_cpu_path_is_the_plain_version_and_counts_no_launch():
    q, k, v, er = (torch.tensor(a) for a in _inputs(1, 8, 64, 32, seed=4))
    before = dilated_attention.launches
    out = dilated_attention(q, k, v, er, 2)
    assert dilated_attention.launches == before
    torch.testing.assert_close(out, dilated_attention_plain(q, k, v, er, 2),
                               atol=0, rtol=0)


def test_tensors_off_cpu_and_off_cuda_raise():
    """Anything but all-CPU tensors goes to the kernel or raises; it never
    quietly takes the plain version."""
    q, k, v, er = (torch.empty(s, device="meta") for s in
                   [(1, 8, 16, 32)] * 3 + [(8, 32, 5)])
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        dilated_attention(q, k, v, er, 1)


# A block tiles 128 queries in the strided view (by residue mod the
# dilation): T = 10,336 (a 240 s song, not a multiple of any dilation > 32)
# gives classes of two lengths at every dilation; T < dilation gives
# classes of one query; head7_bug at both ends of the dilations.
CARD_CASES = (
    [(77, 1, False), (2048, 256, False), (10336, 1, False), (12288, 16, False),
     (12288, 8, True)]
    + [(10336, 2 ** i, False) for i in range(1, 9)]
    + [(77, 128, False), (200, 256, False), (12288, 1, True), (12288, 256, True)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("T,dilation,head7_bug", CARD_CASES)
def test_kernel_matches_plain_on_card(T, dilation, head7_bug):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, er = (torch.tensor(a).bfloat16().cuda()
                   for a in _inputs(5, 8, T, 32, seed=T + dilation))
    before = dilated_attention.launches
    out = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    again = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    torch.cuda.synchronize()
    assert dilated_attention.launches == before + 2
    assert torch.equal(out, again)
    ref = dilated_attention_plain(q, k, v, er, dilation, head7_bug=head7_bug).float()
    top = ref.abs().max().item()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=2 * 2.0 ** (np.floor(np.log2(top)) - 7))


def _grads_port(q, k, v, er, g, dilation, head7_bug):
    inputs = [torch.tensor(a, requires_grad=True) for a in (q, k, v, er)]
    out = dilated_attention(*inputs, dilation, head7_bug=head7_bug)
    return [t.numpy() for t in torch.autograd.grad(out, inputs, torch.tensor(g))]


def _grads_jax(q, k, v, er, g, dilation, head7_bug):
    def f(*args):
        return jax_dilated(*args, dilation, head7_bug=head7_bug)

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v, er)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("head7_bug", [False, True])
@pytest.mark.parametrize("dilation", range(1, 9))
def test_gradient_matches_jax(dilation, head7_bug):
    """dq, dk, dv and der of the port's CPU path (autograd of the plain
    version) against jax.vjp of the JAX function, f32, T not a multiple of
    any dilation above 1."""
    q, k, v, er = _inputs(2, 8, 45, 32, seed=300 + dilation)
    g = np.random.default_rng(dilation).normal(size=q.shape).astype(np.float32)
    port = _grads_port(q, k, v, er, g, dilation, head7_bug)
    ref = _grads_jax(q, k, v, er, g, dilation, head7_bug)
    for name, a, b in zip(("dq", "dk", "dv", "der"), port, ref):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    if head7_bug:
        # Head 7's keys serve no query; head 6's serve heads 6 and 7.
        assert not port[1][:, 7].any()
        plain = _grads_port(q, k, v, er, g, dilation, False)[1]
        assert np.abs(port[1][:, 6] - plain[:, 6]).max() > 1e-3


def test_backward_plain_is_autograd_of_the_plain_version():
    q, k, v, er = (torch.tensor(a).bfloat16() for a in _inputs(1, 8, 40, 32, seed=5))
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(0)).bfloat16()
    got = dilated_attention_backward_plain(q, k, v, er, g, 4, head7_bug=True)
    inputs = [t.float().requires_grad_(True) for t in (q, k, v, er)]
    out = dilated_attention_plain(*inputs, 4, head7_bug=True)
    for a, b in zip(got, torch.autograd.grad(out, inputs, g.float())):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_backward_kernel_refuses_cpu_tensors():
    """K2b's wrapper is for CUDA tensors; on the CPU autograd differentiates
    the plain version, and calling the kernel's wrapper raises."""
    q, k, v, er = (torch.tensor(a).bfloat16() for a in _inputs(1, 8, 16, 32, seed=6))
    before = dilated_attention_backward.launches
    with pytest.raises((RuntimeError, ValueError)):
        dilated_attention_backward(q, k, v, er, torch.zeros_like(q), 1)
    assert dilated_attention_backward.launches == before


@pytest.mark.parametrize("dilation", range(1, 257))
@pytest.mark.parametrize("T", [77, 200, 512, 10336, 12288])
def test_backward_tiles_partition_and_windows(T, dilation):
    """K2b's partition (`backward_tiles`, the kernel's tile arithmetic in
    Python) for every head offset: the tiles' own positions, where each
    block writes dq, dk and dv, cover every position exactly once; every
    staged window lies inside the class of the tile end it extends; a
    query's slot a lies first + a strided rows on (the kernel's staged-row
    arithmetic); and the staged q rows hold every query that reaches the
    tile's key rows, with all of those queries' keys inside the staged k
    rows (so p and ds are complete for every term the tile sums)."""
    order = strided_order(T, dilation)                 # u -> position t
    np.testing.assert_array_equal(order % dilation, np.sort(order % dilation))
    inv = np.empty(T, dtype=np.int64)
    inv[order] = np.arange(T)
    cls = order % dilation
    own_tile = np.arange(T) // BWD_TILE
    for first in np.unique(head_offsets(8, 5)[:, 0]):
        tiles = backward_tiles(T, dilation, int(first))
        u0, n, k_lo, k_hi, q_lo, q_hi = tiles.T
        assert len(tiles) == -(-T // BWD_TILE)
        assert (n > 0).all() and u0[0] == 0 and u0[-1] + n[-1] == T
        np.testing.assert_array_equal(u0[1:], u0[:-1] + n[:-1])
        for lo, hi in ((k_lo, k_hi), (q_lo, q_hi)):
            assert (lo >= 0).all() and (hi <= T).all()
            assert (lo <= u0).all() and (hi >= u0 + n).all()
            assert (cls[lo] == cls[u0]).all() and (cls[hi - 1] == cls[u0 + n - 1]).all()
        assert (u0 - k_lo <= 4).all() and (k_hi - u0 - n <= 4).all()
        assert (q_hi - q_lo - n <= 4).all()
        # Every staged query of every tile, with its tile.
        lengths = q_hi - q_lo
        staged_tile = np.repeat(np.arange(len(tiles)), lengths)
        staged_u = (np.arange(lengths.sum()) - np.repeat(np.cumsum(lengths) - lengths, lengths)
                    + np.repeat(q_lo, lengths))
        for a in range(5):
            tk = order + (first + a) * dilation
            valid = (tk >= 0) & (tk < T)
            uq = np.arange(T)[valid]
            uk = inv[tk[valid]]
            np.testing.assert_array_equal(uk, uq + first + a)
            # The query reaching key row uk is staged by uk's tile.
            kt = own_tile[uk]
            assert ((uq >= q_lo[kt]) & (uq < q_hi[kt])).all()
            # Every staged query's valid keys are staged by the same tile.
            ts = order[staged_u] + (first + a) * dilation
            ok = (ts >= 0) & (ts < T)
            us = inv[ts[ok]]
            st = staged_tile[ok]
            assert ((us >= k_lo[st]) & (us < k_hi[st])).all()


def _ulps2(ref):
    """Two bf16 ulps of the largest |value|; 0 for an all-zero reference (at
    T <= dilation every query sees only itself: p = 1, so ds, dq and dk are 0)."""
    top = ref.abs().max().item()
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


# The training shape (B = 40 rows: 8 clips x 5 stems, T = 512) at every
# dilation, the serving bucket at three, head7_bug both ways, and a 240 s
# song (T = 10,336: classes of two lengths at every dilation above 32) at
# every dilation.
BWD_CARD_CASES = ([(40, 512, 2 ** i, False) for i in range(9)]
                  + [(5, 12288, d, False) for d in (1, 16, 256)]
                  + [(40, 512, d, True) for d in (1, 8, 256)]
                  + [(2, 77, 128, True), (3, 200, 3, False)]
                  + [(5, 10336, 2 ** i, False) for i in range(9)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dilation,head7_bug", BWD_CARD_CASES)
def test_backward_kernel_matches_plain_on_card(B, T, dilation, head7_bug):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, er = (torch.tensor(a).bfloat16().cuda()
                   for a in _inputs(B, 8, T, 32, seed=T + dilation))
    g = torch.randn(q.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(dilation)).bfloat16()
    before = dilated_attention_backward.launches
    got = dilated_attention_backward(q, k, v, er, g, dilation, head7_bug=head7_bug)
    again = dilated_attention_backward(q, k, v, er, g, dilation, head7_bug=head7_bug)
    torch.cuda.synchronize()
    assert dilated_attention_backward.launches == before + 2
    ref = dilated_attention_backward_plain(q, k, v, er, g, dilation, head7_bug=head7_bug)
    for name, a, b, r in zip(("dq", "dk", "dv", "der"), got, again, ref):
        assert torch.equal(a, b), name
        assert torch.isfinite(a.float()).all(), name
        tol = _ulps2(r) if name != "der" else 1e-3 * r.abs().max().item()
        torch.testing.assert_close(a.float(), r, rtol=0, atol=tol, msg=name)
    if head7_bug:
        assert not got[1][:, 7].any()


@pytest.mark.cuda
def test_autograd_on_card_goes_through_the_backward_kernel():
    """The card's output carries a gradient: backward() through
    `dilated_attention` launches K2b (one kernel) once and fills every
    input's grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v = (torch.tensor(a).bfloat16().cuda().requires_grad_(True)
               for a in _inputs(2, 8, 300, 32, seed=8)[:3])
    er32 = torch.zeros(8, 32, 5, device="cuda", requires_grad=True)
    before = dilated_attention_backward.launches
    out = dilated_attention(q, k, v, er32.bfloat16(), 4)
    out.float().square().sum().backward()
    assert dilated_attention_backward.launches == before + 1
    for t in (q, k, v, er32):
        assert t.grad is not None and torch.isfinite(t.grad.float()).all()
    assert er32.grad.dtype == torch.float32 and er32.grad.abs().max() > 0
