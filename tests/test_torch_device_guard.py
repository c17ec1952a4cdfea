"""The kernel wrappers' launch counters under several threads, and (on a
machine with two or more cards) their launches on a card other than the
current one. Imports torch and the port only: the card tests run where JAX
is not wanted.

The counters are what chip_smoke.py reads to show that a path went through
a kernel; the streams of a sweep spread over cards launch K1 from one
thread per card, so a lost update would undercount.
"""

from __future__ import annotations

import sys
import threading

import pytest
import torch

from etude_tpu_torch.ops import _build
from etude_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain
from etude_tpu_torch.ops.dilated_attention import (dilated_attention,
                                                   dilated_attention_backward,
                                                   dilated_attention_plain)


@pytest.mark.parametrize("wrapper", [decode_attention, dilated_attention,
                                     dilated_attention_backward],
                         ids=["K1", "K2", "K2b"])
def test_launch_counter_loses_no_update_across_threads(wrapper):
    threads, per = 16, 2000
    before = sys.getswitchinterval()
    wrapper.launches = 0
    sys.setswitchinterval(1e-6)   # switch threads as often as the interpreter can
    try:
        workers = [threading.Thread(target=lambda: [_build.count_launch(wrapper)
                                                    for _ in range(per)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
        assert wrapper.launches == threads * per
    finally:
        sys.setswitchinterval(before)
        wrapper.launches = 0


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    torch.cuda.set_device(0)


@pytest.mark.cuda
def test_k1_launches_on_its_tensors_card(two_cards):
    """From a thread whose current card is 0, K1 on cuda:1 runs there and
    agrees with its plain version; the launch is counted."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 8, 64, generator=g)
    k, v = (torch.randn(4, 8, 300, 64, generator=g).bfloat16() for _ in range(2))
    bias = torch.zeros(4, 300)
    want = decode_attention_plain(q, k, v, bias)
    decode_attention.launches = 0
    out = decode_attention(*(t.to("cuda:1") for t in (q, k, v, bias)))
    torch.cuda.synchronize(1)
    assert out.device == torch.device("cuda:1") and torch.cuda.current_device() == 0
    assert decode_attention.launches == 1
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=0, atol=2e-2)


@pytest.mark.cuda
def test_k2_and_k2b_launch_on_their_tensors_card(two_cards):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 8, 256, 32, generator=g).bfloat16() for _ in range(3))
    er = torch.randn(8, 32, 5, generator=g)
    want = dilated_attention_plain(q, k, v, er, 4)
    dilated_attention.launches = dilated_attention_backward.launches = 0
    ins = [t.to("cuda:1").requires_grad_(True) for t in (q, k, v, er)]
    out = dilated_attention(*ins, 4)
    out.float().sum().backward()
    torch.cuda.synchronize(1)
    assert out.device == torch.device("cuda:1") and torch.cuda.current_device() == 0
    assert dilated_attention.launches == 1 and dilated_attention_backward.launches == 1
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=0, atol=3e-2)
