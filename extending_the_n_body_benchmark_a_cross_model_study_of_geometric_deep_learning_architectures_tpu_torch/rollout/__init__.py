"""Self-feed rollout."""
