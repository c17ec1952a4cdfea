"""Cover tokens served (each bar's tokens up to its Bar_EOS, no parked
stream's padding) over the whole window, first request start to last end."""


def read(run):
    return sum(r["cover_tokens"] for r in run.records) / run.window_s
