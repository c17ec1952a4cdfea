"""K2 (the dilated-attention kernel) in the traced window: the least time
its bytes need at the card's HBM bandwidth (q, k, v and the output of
every stem's sequence at the beat model's width, read and written once),
over the kernel's time, in percent. Each Beat-Transformer forward launches
it once per dilated layer, on the song's frames padded to the model's
bucket."""

from h100_bench.frozen.counts import HBM_BYTES_PER_S, dilated_attention_bytes

KERNEL = "dilated_attention_kernel"


def read(run):
    trace = run.traced
    mask = trace.kernel_mask(KERNEL)
    launches = int(mask.sum())
    if not launches:
        return None
    beat = run.ctx.config["beat_model"]
    frames = run.driver.beat_frames()
    per_launch = dilated_attention_bytes(beat["instr"], beat["nhead"], frames,
                                         beat["dmodel"] // beat["nhead"], beat["attn_len"])
    return 100.0 * (launches * per_launch / HBM_BYTES_PER_S) / trace.device_s(mask)
