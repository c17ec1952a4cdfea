"""The host's wall time per song through the three stages (host clock),
averaged over the window's songs."""


def read(run):
    return sum(r["seconds"] for r in run.records) / len(run.records)
