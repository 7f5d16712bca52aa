"""The benchmark of the PyTorch port (``fei_tpu_torch``): see run.py."""
