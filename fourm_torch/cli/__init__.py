"""Command-line entry points of the port (`python -m fourm_torch.cli.train_4m`)."""
