"""The decoder's FLOPs for the window's cover tokens, each at its visible
context (counted from shapes by the benchmark), over the window and the
card's bf16 peak, in percent."""

from h100_bench.frozen.counts import PEAK_BF16_FLOPS


def read(run):
    flops = sum(run.driver.cover_flops(r) for r in run.records)
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS) if flops else None
