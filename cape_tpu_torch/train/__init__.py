"""Training: schedules, the G/D optimizer, the GAN step, checkpoints, the loop."""
