"""Host ms a traced request in the upload of the batch: the program's span
"serve.upload" (models/gns.py batch_tensors as GNSPredictor.predict calls
it, the copy from pageable host memory included), over the traced requests
whose program spans map onto the trace (lib/program_spans.py)."""

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "serve":
        return None
    return ps.ms_per_unit(ps.mapped(rec.trace, "request"), "serve.upload")
