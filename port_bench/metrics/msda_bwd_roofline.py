"""The deformable core's backward (K2's passes, its sort and whatever else
its autograd node launches) against its roofline
(`bounds.deform_bwd_seconds`), over the device time launched inside the
node, in percent."""


def read(rec):
    m = rec.get("msda")
    if not m or m["bwd_device_s"] <= 0:
        return None
    return 100.0 * m["bwd_least_s"] / m["bwd_device_s"]
