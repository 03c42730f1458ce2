"""The deformable core's forward (K1 and whatever prepares it) against its
roofline: the least time of each call of the profiled steps from its
shapes and data (`bounds.deform_fwd_seconds`), over the device time of
everything launched inside the call, in percent."""


def read(rec):
    m = rec.get("msda")
    if not m or m["fwd_device_s"] <= 0:
        return None
    return 100.0 * m["fwd_least_s"] / m["fwd_device_s"]
