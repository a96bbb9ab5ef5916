"""CUDA-event ms of a request's forward (gns_forward as predict calls it),
the mean over the window's requests: from the device reaching an event
recorded before the call to it reaching one recorded after, launch gaps
included."""


def read(rec):
    if rec.kind != "serve" or not rec.forward_ms:
        return None
    return sum(rec.forward_ms) / len(rec.forward_ms)
