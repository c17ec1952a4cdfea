"""The window's wall time per S = 1 step of the engine, in ms (host clock)."""


def read(run):
    chunks = sum(r["single_token_chunks"] for r in run.records)
    return 1e3 * run.window_s / chunks if chunks else None
