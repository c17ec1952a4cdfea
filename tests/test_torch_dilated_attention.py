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
"""

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
    dilated_attention,
    dilated_attention_plain,
    head_offsets,
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


@pytest.mark.cuda
@pytest.mark.parametrize("T,dilation,head7_bug", [
    (77, 1, False), (2048, 256, False), (10336, 1, False), (12288, 16, False),
    (12288, 8, True),
])
def test_kernel_matches_plain_on_card(T, dilation, head7_bug):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, er = (torch.tensor(a).bfloat16().cuda()
                   for a in _inputs(5, 8, T, 32, seed=T + dilation))
    before = dilated_attention.launches
    out = dilated_attention(q, k, v, er, dilation, head7_bug=head7_bug)
    torch.cuda.synchronize()
    assert dilated_attention.launches == before + 1
    ref = dilated_attention_plain(q, k, v, er, dilation, head7_bug=head7_bug).float()
    top = ref.abs().max().item()
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref, rtol=0,
                               atol=2 * 2.0 ** (np.floor(np.log2(top)) - 7))
