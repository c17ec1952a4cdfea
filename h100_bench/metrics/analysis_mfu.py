"""The three forwards' FLOPs (the hFT over the song's segments, the
separator U-Net over its spectrogram, the Beat-Transformer over its frames;
counted from shapes by the benchmark) over the traced window's device time
and the card's bf16 peak, in percent."""

from h100_bench.frozen.counts import PEAK_BF16_FLOPS


def read(run):
    busy = run.traced.busy_s()
    if not busy:
        return None
    flops = sum(run.driver.song_flops(r) for r in run.traced_records)
    return 100.0 * flops / (busy * PEAK_BF16_FLOPS)
