"""Measurement scripts for the port's kernels, run on the card
(``python -m paddle_tpu_torch.tools.<name>``)."""
