"""Device milliseconds a frame spends in K3, the shadow rays' any-hit
kernel (csrc/rows_occlusion.cu)."""


def read(t):
    ms = t.device_s("k3") * 1e3
    return ms / t.frames if t.frames and ms > 0 else None
