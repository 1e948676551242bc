"""Device milliseconds a frame of host-to-device copies (the profiler's
memcpy records): the upload of the source planes, and of whatever else
the program sends to the card every frame."""


def read(rec):
    ns = sum(e - s for _, k, s, e in rec["device"] if k == "memcpy_htod")
    return ns * 1e-6 / rec["frames"] if ns and rec["frames"] else None
