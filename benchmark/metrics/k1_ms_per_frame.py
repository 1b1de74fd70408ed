"""Device milliseconds a frame spends in K1, the packed closest-hit
kernel (csrc/packed_tracer.cu)."""


def read(t):
    ms = t.device_s("k1") * 1e3
    return ms / t.frames if t.frames and ms > 0 else None
