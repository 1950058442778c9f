"""Training: the step (dense autograd edge stage), losses, AdamW under the Noam
schedule, checkpoints and run-dir logging."""
