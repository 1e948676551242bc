"""Device milliseconds a frame of device-to-host copies (the profiler's
memcpy records): the transcoder's download of the encoder's planes into
pinned host memory."""


def read(rec):
    ns = sum(e - s for _, k, s, e in rec["device"] if k == "memcpy_dtoh")
    return ns * 1e-6 / rec["frames"] if ns and rec["frames"] else None
