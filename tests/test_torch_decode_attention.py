"""The port's decode attention (etude_tpu_torch/ops/decode_attention.py)
against the JAX package's Pallas kernel (interpret mode on the CPU) and the
`stream_chunk` S = 1 einsum form, on the same numpy inputs.

Layouts differ by design: the port takes k/v [B, H, C, D] and q [B, H, D];
the JAX side gets k/v [B, H, D, C] and q [B, 1, H, D].

Tolerances follow the output's real size: o is a softmax-weighted mean of
N(0, 1) rows, so |o| is about 0.05-0.3 over a few hundred visible slots and
up to about 2 over a handful. On the CPU the plain version and the JAX side
round at the same three points (bf16 q, p and o), so they must agree to
2^-8 max|o|, at most one bf16 ulp of the largest output. On the card the
kernel sums in another order, which can flip a rounding of p or o: two bf16
ulps of the largest output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etude_tpu.ops.decode_attention import decode_attention_pallas
from etude_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
)

H, D = 8, 64


def _cpu_atol(ref):
    """2^-8 of the largest |output|: at most one bf16 ulp there."""
    return 2.0 ** -8 * float(np.abs(np.asarray(ref)).max())


def _card_atol(ref):
    """Two bf16 ulps (2^(e-7) for 2^e <= |x|) of the largest |output|."""
    top = float(np.abs(np.asarray(ref)).max())
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _inputs(B, C, seed):
    """q f32, k/v bf16-representable, bias with a hidden tail on stream 0
    and (B > 1) a fully hidden last stream."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k = rng.normal(size=(B, H, C, D)).astype(np.float32)
    v = rng.normal(size=(B, H, C, D)).astype(np.float32)
    k = torch.tensor(k).bfloat16()
    v = torch.tensor(v).bfloat16()
    visible = rng.random((B, C)) < 0.7
    visible[0, (C + 1) // 2:] = False
    if B > 1:
        visible[-1] = False
    bias = np.where(visible, 0.0, -1e9).astype(np.float32)
    return torch.tensor(q), k, v, torch.tensor(bias)


def _to_jax(q, k, v, bias):
    kj = jnp.asarray(k.float().numpy().transpose(0, 1, 3, 2), jnp.bfloat16)
    vj = jnp.asarray(v.float().numpy().transpose(0, 1, 3, 2), jnp.bfloat16)
    qj = jnp.asarray(q.numpy()[:, None])                      # [B, 1, H, D]
    bj = jnp.asarray(bias.numpy()[:, None, None, :])          # [B, 1, 1, C]
    return qj, kj, vj, bj


CASES = [(1, 7), (1, 200), (3, 7), (3, 200)]


@pytest.mark.parametrize("B,C", CASES)
def test_plain_matches_pallas_interpret(B, C):
    q, k, v, bias = _inputs(B, C, seed=B * 1000 + C)
    ref = decode_attention_pallas(*_to_jax(q, k, v, bias), interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))[:, 0]          # [B, H, D]
    out = decode_attention_plain(q, k, v, bias).float().numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=_cpu_atol(ref), rtol=0)


@pytest.mark.parametrize("B,C", CASES)
def test_plain_matches_stream_chunk_einsums(B, C):
    """The XLA form that generate_stream.py:369-399 computes for S = 1."""
    q, k, v, bias = _to_jax(*_inputs(B, C, seed=7 + B + C))
    scores = jnp.einsum("bqhd,bhdc->bhqc", q.astype(jnp.bfloat16), k,
                        preferred_element_type=jnp.float32) / np.sqrt(D)
    probs = jax.nn.softmax(scores + bias, axis=-1)
    ctx = jnp.einsum("bhqc,bhdc->bqhd", probs.astype(jnp.bfloat16), v)
    ref = np.asarray(ctx.astype(jnp.float32))[:, 0]
    out = decode_attention_plain(*_inputs(B, C, seed=7 + B + C)).float().numpy()
    np.testing.assert_allclose(out, ref, atol=_cpu_atol(ref), rtol=0)


def test_fully_hidden_row_is_uniform_average():
    """A parked stream (every slot -1) must give the finite uniform average
    of its V rows, as the plain version and the JAX kernel do, never NaN."""
    q, k, v, bias = _inputs(3, 33, seed=5)
    out = decode_attention_plain(q, k, v, bias)[-1].float()
    mean = v[-1].float().mean(dim=1)                          # [H, D]
    p = torch.tensor(1.0 / 33).bfloat16().float()             # bf16(p)
    expect = (mean * 33 * p).numpy()
    np.testing.assert_allclose(out.numpy(), expect, atol=_cpu_atol(expect), rtol=0)


def test_wrapper_on_cpu_takes_plain_path_and_counts_nothing():
    q, k, v, bias = _inputs(3, 200, seed=11)
    before = decode_attention.launches
    out = decode_attention(q, k, v, bias)
    assert decode_attention.launches == before == 0
    assert out.dtype == torch.bfloat16 and out.shape == (3, H, D)
    torch.testing.assert_close(out, decode_attention_plain(q, k, v, bias),
                               rtol=0, atol=0)


def test_scale_is_inverse_sqrt_head_dim():
    """Scores are q.k / sqrt(D): with q.k = 8 on slot 0 and 0 on slot 1 at
    D = 64, the weights are softmax([1, 0]), rounded to bf16 before PV."""
    _, _, v, _ = _inputs(1, 2, seed=3)
    q = torch.zeros(1, H, D)
    q[..., 0] = 1.0
    k = torch.zeros(1, H, 2, D, dtype=torch.bfloat16)
    k[:, :, 0, 0] = 8.0
    out = decode_attention_plain(q, k, v, torch.zeros(1, 2)).float()
    p = torch.softmax(torch.tensor([1.0, 0.0]), 0).bfloat16().float()
    expect = p[0] * v[0, :, 0].float() + p[1] * v[0, :, 1].float()
    np.testing.assert_allclose(out[0].numpy(), expect.numpy(),
                               atol=_cpu_atol(expect.numpy()), rtol=0)


def test_cluster_shared_memory_caps_the_cache_length():
    """The wrapper's limit on C is the cluster's: each of CLUSTER blocks
    keeps its chunk's scores in one block's shared memory."""
    from etude_tpu_torch.ops.decode_attention import (
        _MAX_SMEM, _check_cuda_inputs, max_cache_len, smem_bytes,
    )

    top = max_cache_len()
    assert smem_bytes(top) <= _MAX_SMEM < smem_bytes(top + 1)
    assert top > 1217   # the serving shape's C fits

    def meta(C):   # shapes and types only, no storage
        return (torch.empty(1, H, D, device="meta"),
                *(torch.empty(1, H, C, D, dtype=torch.bfloat16, device="meta")
                  for _ in range(2)),
                torch.empty(1, C, device="meta"))

    _check_cuda_inputs(*meta(top))
    with pytest.raises(ValueError, match="shared memory"):
        _check_cuda_inputs(*meta(top + 1))


# The cluster splits C into CLUSTER = 4 chunks of ceil(C / 4) slots: C = 1
# leaves three blocks with no slot, C = 5 one short chunk and one empty,
# C = 7 one short chunk, C = 9 one empty (C below 4 x the chunk), C = 1217
# (the serving shape) ends on a short chunk. The last stream of every B > 1
# case is fully hidden.
CARD_CASES = [(1, 769), (16, 769), (27, 1353), (1, 1), (1, 7), (16, 5), (16, 7),
              (16, 9), (16, 1217), (1, 1217), (27, 1217)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", CARD_CASES)
def test_kernel_matches_plain_on_card(B, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    q, k, v, bias = (t.cuda() for t in _inputs(B, C, seed=B + C))
    before = decode_attention.launches
    out = decode_attention(q, k, v, bias)
    again = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    assert torch.equal(out, again)   # fixed summation order: the same bits
    ref = decode_attention_plain(q, k, v, bias)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_card_atol(ref.float().cpu()), rtol=0)


@pytest.mark.cuda
def test_kernel_at_the_largest_cache_len_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import ctypes

    from etude_tpu_torch.ops import _build
    from etude_tpu_torch.ops.decode_attention import max_cache_len, smem_bytes

    lib = _build.load("decode_attention")
    lib.decode_attention_smem_bytes.restype = ctypes.c_size_t
    for C in (1, 7, 1217, max_cache_len()):
        assert lib.decode_attention_smem_bytes(C) == smem_bytes(C)
    g = torch.Generator(device="cuda").manual_seed(3)
    C = max_cache_len()
    q = torch.randn(1, H, D, device="cuda", generator=g)
    k, v = (torch.randn(1, H, C, D, device="cuda", generator=g).bfloat16() for _ in range(2))
    bias = torch.where(torch.rand(1, C, device="cuda", generator=g) < 0.7, 0.0, -1e9).float()
    out = decode_attention(q, k, v, bias)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q, k, v, bias)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=_card_atol(ref.float().cpu()), rtol=0)
    with pytest.raises(ValueError, match="shared memory"):
        decode_attention(q, *(torch.cat([t, t[:, :, :1]], dim=2) for t in (k, v)),
                         torch.cat([bias, bias[:, :1]], dim=1))


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body + "\n")
    script.chmod(0o755)
    return str(script)


def test_build_caches_by_source_hash(tmp_path, monkeypatch):
    """The build step (nvcc itself runs only on a GPU machine) compiles a
    source once per content hash; a changed source gets a new library."""
    from etude_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "decode_attention.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # The fake compiler writes the file named after -o.
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; echo ok > "$2"')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)

    first = _build.build(["decode_attention"])
    assert list(first) == ["decode_attention"]
    path = _build.library_path("decode_attention")
    assert path.exists() and path.parent == tmp_path / "build"
    assert _build.build(["decode_attention"]) == {}
    (csrc / "decode_attention.cu").write_text("// v2\n")
    assert _build.library_path("decode_attention") != path
    assert list(_build.build(["decode_attention"])) == ["decode_attention"]


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    from etude_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no such intrinsic"; exit 1')
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["decode_attention"])
    assert not list((tmp_path / "build").glob("*.so"))
