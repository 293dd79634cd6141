"""Training: schedules, the G/D optimizer, the GAN step, checkpoints,
metrics and TensorBoard events, the loop."""
