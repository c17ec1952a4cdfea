"""Device time of the extract stage per second of audio, in the traced
window: the summed time of the device operations launched inside the
stage's span (its own thread, on its own stream)."""


def read(run):
    seconds = run.traced.device_s(run.traced.launched_in("bench.extract"))
    if not seconds:
        return None
    return 1e3 * seconds / run.driver.audio_seconds(run.traced_records)
