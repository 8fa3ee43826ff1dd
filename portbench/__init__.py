"""The PyTorch and CUDA port's benchmark: whole MFM trials on MOSI."""
