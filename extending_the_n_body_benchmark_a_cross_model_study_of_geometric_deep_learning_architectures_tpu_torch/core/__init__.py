"""Scene, targets, dense graph geometry and softened-gravity physics."""
