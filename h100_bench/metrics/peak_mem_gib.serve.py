"""The allocator's peak of device memory over set-up and window, in GiB."""


def read(run):
    return run.memory_peak_bytes / 2 ** 30
