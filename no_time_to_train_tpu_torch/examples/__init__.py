"""Examples on the port (ports of the repository's root-level
`examples/`); each runs as
`python -m no_time_to_train_tpu_torch.examples.<name>`."""
