"""Models of the port (``gpt.py`` <- ``paddle_tpu/models/gpt.py``)."""
