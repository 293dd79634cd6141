"""request_p95_ms.serve: the nearest-rank 95th percentile of the untraced
window's request latencies (each from when it was due to the last byte
of its response; a failed request misses any limit), in ms."""


def read(m: dict):
    return m.get("p95_ms")
