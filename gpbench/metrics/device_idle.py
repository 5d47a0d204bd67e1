"""Share (%) of the traced window in which no operation ran on the device.
One reader for device_idle.fit and device_idle.repredict."""


def read(rec, name):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
