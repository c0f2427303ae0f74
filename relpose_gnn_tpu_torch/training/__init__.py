"""Pose fusion for evaluation (the trainer comes with the training slice)."""
