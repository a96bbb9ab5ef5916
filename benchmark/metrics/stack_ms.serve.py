"""Host ms a traced request in the stacking of request packing: the
program's span "pack.stack" (utils/prepare.py batch_from_cases, its
_stack_to_batch call), over the traced requests whose program spans map
onto the trace (lib/program_spans.py)."""

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "serve":
        return None
    return ps.ms_per_unit(ps.mapped(rec.trace, "request"), "pack.stack")
