"""decode_call_ms.serve: host time of the engine's decode stage per padded
device call in the untraced window, from the benchmark's wrapper around
`InferenceEngine.decode` (synchronous: it reads its output back), in ms."""


def read(m: dict):
    if not m.get("decode_calls"):
        return None
    return 1000.0 * m["decode_s"] / m["decode_calls"]
