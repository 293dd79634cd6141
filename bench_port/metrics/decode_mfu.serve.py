"""decode_mfu.serve: the operations of one padded /sample generation (the
condition nets and the decoder at the serving batch, `flops.Counter.
decode_call`) over decode_call_ms, as a share of the card's peak in the
compute dtype, in %."""


def read(m: dict):
    if not m.get("decode_calls") or "decode_call_ops" not in m:
        return None
    return 100.0 * m["decode_call_ops"] / (m["decode_s"] / m["decode_calls"]) / m["peak_flops"]
