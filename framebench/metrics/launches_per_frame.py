"""Device operations (kernels, copies and fills) a frame issues: those
in the traced sub-window over its frames."""


def read(rec):
    return len(rec["device"]) / rec["frames"] if rec["frames"] else None
