"""Host tools of the port (ports of the repository's root-level `tools/`);
each runs as `python -m no_time_to_train_tpu_torch.tools.<name>`."""
