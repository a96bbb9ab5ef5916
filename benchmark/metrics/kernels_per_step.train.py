"""Device kernels per update step in the traced epochs: the kernels the
profiler recorded in the traced window (its device activities less copies
and fills: "Memcpy ..." and "Memset ..."), over the update steps of the
traced epochs (the epochs traced times the steps an epoch, rec.attempted
over rec.units). A replayed CUDA graph's kernels are recorded one by one,
so it counts the captured step's launches, with the epoch's loss read
spread over its steps."""

COPIES = ("Memcpy", "Memset")


def read(rec):
    if rec.kind != "train" or rec.trace is None or not rec.units or not rec.trace.units:
        return None
    steps = rec.trace.units * rec.attempted / rec.units
    kernels = sum(1 for *_, name in rec.trace.device if not name.startswith(COPIES))
    if steps <= 0 or not kernels:
        return None
    return kernels / steps
