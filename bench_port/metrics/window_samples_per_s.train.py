"""window_samples_per_s.train: the rows of all the untraced window's steps
over the time from its start to the end of its last chunk, synchronised:
train_samples_per_s as a run takes it, kept per layer in the cells whose
runs spread too widely on the host's clock for it to hold a bound."""


def read(m: dict):
    return m.get("window_samples_per_s")
