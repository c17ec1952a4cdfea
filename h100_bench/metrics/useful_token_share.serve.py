"""Cover tokens over stream-steps: the share of the S = 1 steps' stream
slots that served a token (the engine's `single_token_chunks` counter times
the streams in each request), in percent."""


def read(run):
    slots = sum(r["single_token_chunks"] * r["attempted"] for r in run.records)
    if not slots:
        return None
    return 100.0 * sum(r["cover_tokens"] for r in run.records) / slots
