"""Device operations (kernels, copies, sets) a frame launches: the API and
host layer's launch count, from the device trace."""


def read(t):
    return len(t.device) / t.frames if t.frames and t.device else None
