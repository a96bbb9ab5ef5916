"""Model FLOPs completed in the window over the window, as a share of one
H100's float32 peak outside the tensor cores (lib/counts.py: 67 TFLOP/s at
700 W; the run prints the card's power limit). The FLOPs are those of the
configuration's MLP products (lib/counts.py forward_flops; a training step
counts three forwards)."""

from benchmark.lib.counts import FP32_FLOPS


def read(rec):
    if rec.kind != "train" or rec.window_s <= 0 or rec.flops <= 0:
        return None
    return 100.0 * rec.flops / rec.window_s / FP32_FLOPS
