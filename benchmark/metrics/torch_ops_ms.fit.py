"""torch_ops_ms.fit: the card's time per fit step of the kernels launched
inside PyTorch operators (autograd's reductions, the loss, the quantize
pass, SGD), from the traced window."""


def read(run):
    t = run.trace
    return 1e3 * t.device_s("frame", launcher="torch") / t.frames
