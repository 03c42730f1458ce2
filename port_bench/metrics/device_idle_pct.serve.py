"""Share of the profiled stretch of requests in which no kernel, copy or
memset runs on the device, in percent."""


def read(rec):
    if rec.get("kind") != "serve" or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
