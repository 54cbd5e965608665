"""Command-line front ends of the port that drive the model on the
device (ports of the repository's root-level `scripts/`); each runs as
`python -m no_time_to_train_tpu_torch.scripts.<name>`."""
