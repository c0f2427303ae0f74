"""Training: criteria, the trainer (train and eval steps, Adam), checkpoints
and the experiment loop (run_training, run_eval)."""
