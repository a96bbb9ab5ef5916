"""Host ms a request in request packing: batch_from_cases and
extract_shared_topology as GNSPredictor.predict calls them, from the
benchmark's spans around those calls (span "pack"), over the window's
requests."""


def read(rec):
    if rec.kind != "serve" or rec.spans is None or not rec.units:
        return None
    return 1e3 * rec.spans.seconds["pack"] / rec.units
