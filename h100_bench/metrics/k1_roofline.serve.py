"""K1 (the decode-attention kernel) in the traced requests: the least time
its bytes need at the card's HBM bandwidth (K and V over all C cache slots,
q, the bias, the output: counted by the benchmark), over the kernel's time
in the trace, in percent."""

from h100_bench.frozen.counts import HBM_BYTES_PER_S, decode_attention_bytes
from h100_bench.harness import note

KERNEL = "decode_attention_kernel"


def read(run):
    trace = run.traced
    mask = trace.kernel_mask(KERNEL)
    launches = int(mask.sum())
    if not launches:
        return None
    cfg = run.ctx.config
    layers, heads = cfg["num_hidden_layers"], cfg["num_attention_heads"]
    head_dim = cfg["hidden_size"] // heads
    expected = n_bytes = 0
    for r in run.traced_records:
        n = r["single_token_chunks"] * layers
        expected += n
        n_bytes += n * decode_attention_bytes(r["attempted"], heads,
                                              run.driver.cache_slots(r), head_dim)
    if launches != expected:
        note(f"k1_roofline: {launches} K1 launches traced, {expected} expected")
        n_bytes = n_bytes * launches / expected
    return 100.0 * (n_bytes / HBM_BYTES_PER_S) / trace.device_s(mask)
