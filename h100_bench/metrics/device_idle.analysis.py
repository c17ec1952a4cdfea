"""The share of the traced window in which no operation ran on the device
(the union of kernels, copies and sets over all streams), in percent."""


def read(run):
    window = run.traced_records[-1]["t_end"]
    return 100.0 * max(0.0, 1.0 - run.traced.busy_s() / window)
