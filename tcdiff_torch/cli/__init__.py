"""Command-line entry points (`python -m tcdiff_torch.cli.<name>`)."""
