"""Model conversion: reference GKGNet checkpoints into the port's format."""
