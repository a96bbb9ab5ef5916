"""Host ms a traced request waiting for the model step: the program's span
"serve.readback" (the .cpu() reads of v, theta and last_loss in
GNSPredictor.predict, which block until the device has finished), over the
traced requests whose program spans map onto the trace
(lib/program_spans.py)."""

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "serve":
        return None
    return ps.ms_per_unit(ps.mapped(rec.trace, "request"), "serve.readback")
