"""Card time per second of analysed audio: the union of the device
operations' intervals (over all streams) in the window, read from a
device-only profile, over the seconds of audio of the window's songs."""


def read(run):
    return 1e3 * run.traced.busy_s() / run.driver.audio_seconds(run.records)
