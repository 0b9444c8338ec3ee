"""The benchmark of the PyTorch and CUDA port (`dissect_tpu_torch`)."""
