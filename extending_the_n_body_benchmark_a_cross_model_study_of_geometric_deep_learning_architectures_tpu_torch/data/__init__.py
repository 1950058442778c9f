"""Fresh ground-truth gravity trajectories."""
