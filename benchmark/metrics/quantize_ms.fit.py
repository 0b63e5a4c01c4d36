"""quantize_ms.fit: the card's time per fit step of the backward's quantize
pass (the float32 volume to the bytes B5 reads), from the kernels launched
inside the program's ``vr.voxel_grad.quantize`` spans in the traced window.
Nothing where the program has no ``vr.voxel_grad`` span; 0 where its
voxel gradient quantizes nothing."""


def read(run):
    t = run.trace
    if not t.ranges.get("vr.voxel_grad"):
        return None
    return 1e3 * t.device_s("vr.voxel_grad.quantize") / t.frames
