"""device_idle.train: the share of the traced training steps in which no
operation ran on the device."""


def read(r):
    if r.traced is None or not r.traced.device or r.traffic["kind"] != "train":
        return None
    return 100.0 * (1.0 - r.traced.busy_s / r.traced.window_s)
