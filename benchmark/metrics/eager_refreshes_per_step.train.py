"""Correction steps whose physics refresh runs as the eager physics_refresh
chain, per update step: the program's counter model.eager_refreshes, which
a driver records while its set-up builds the update step (on the card the
capture's warm-ups and the captured step), over the steps built. K while
the training step takes the eager refresh at every correction step; 0 once
a fused refresh does. None where the driver recorded no such counter (a
program without it, or a driver that does not record it)."""


def read(rec):
    if rec.kind != "train":
        return None
    return rec.detail.get("eager_refreshes_per_step")
