"""Device milliseconds a frame spends in kernels that are not the
program's own CUDA kernels: the frame core's eager torch operations."""


def read(t):
    us = sum(e.dur for e in t.device
             if e.cat == "kernel" and not t.is_kernel(e, "port"))
    return us * 1e-3 / t.frames if t.frames and us > 0 else None
