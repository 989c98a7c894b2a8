"""The device's idle share while a request is served, in %: 1 - the union
of the device events' intervals inside the traced window's 'request'
spans (from the start of a request's serving to its synchronise) over
the spans' length. The traced window runs at the cell's own rate; the
card's idle time between requests is not counted."""


def read(r):
    busy, length = r.trace.busy_within('request')
    return 100 * (1 - busy / length) if length else None
