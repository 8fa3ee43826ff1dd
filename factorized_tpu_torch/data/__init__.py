"""Data adapters of the port: the synthetic MOSI set (``mosi``)."""
