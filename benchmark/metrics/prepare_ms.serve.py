"""Host ms a traced request in the per-grid preparation of request
packing: the program's span "pack.prepare" (utils/prepare.py
batch_from_cases, its prepare_case calls), over the traced requests whose
program spans map onto the trace (lib/program_spans.py)."""

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "serve":
        return None
    return ps.ms_per_unit(ps.mapped(rec.trace, "request"), "pack.prepare")
