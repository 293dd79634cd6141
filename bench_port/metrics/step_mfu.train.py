"""step_mfu.train: the operations one train step needs (`flops.Counter.
train_step`) over the untraced window's time per step, as a share of the
card's peak in the compute dtype (`roofline.PEAK_FLOP_PER_S`), in %."""


def read(m: dict):
    if "step_ops" not in m or "step_s" not in m:
        return None
    return 100.0 * m["step_ops"] / m["step_s"] / m["peak_flops"]
