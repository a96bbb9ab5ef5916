"""Host ms of one correction step in a traced request: the program's spans
"model.step" (models/gns.py run_steps, one for each of the K steps of the
forward GNSPredictor.predict runs), their mean in each traced request whose
program spans map onto the trace (lib/program_spans.py), and the median of
those means over the requests. On the card it is the time the host takes
to queue one step's kernels. None where the program records no such span."""

import statistics

from benchmark.lib import program_spans as ps


def read(rec):
    if rec.kind != "serve":
        return None
    m = ps.mapped(rec.trace, "request")
    if m is None:
        return None
    per_unit = {}
    for a, b, name, unit in m.spans:
        if name == "model.step":
            per_unit.setdefault(unit, []).append(b - a)
    if not per_unit:
        return None
    return statistics.median(sum(d) / len(d) for d in per_unit.values()) / 1e3
