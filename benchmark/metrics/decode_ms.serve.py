"""Host ms a request in the serving decode: align_slack_angle as
GNSPredictor.predict calls it for every grid, from the benchmark's span
around each call (span "decode"), over the window's requests."""


def read(rec):
    if rec.kind != "serve" or rec.spans is None or not rec.units:
        return None
    return 1e3 * rec.spans.seconds["decode"] / rec.units
