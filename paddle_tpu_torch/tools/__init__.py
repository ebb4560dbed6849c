"""Measurement scripts of the port, run on the card (``python3 -m
paddle_tpu_torch.tools.<name>``)."""
