"""decode_fill.serve: the rows of the padded decode calls that carried a
mesh in the untraced window: meshes decoded over (the engine's
`calls["decode"]` x its batch), in %, from the program's counter and the
rows the benchmark's wrapper saw."""


def read(m: dict):
    if not m.get("decode_calls"):
        return None
    return 100.0 * m["decode_rows"] / (m["decode_calls"] * m["batch_size"])
