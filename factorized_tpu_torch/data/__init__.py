"""Data adapters of the port: MOSI (``mosi``, the real files and the
synthetic set), MOUD (``moud``), YouTube (``youtube``) and MMMO
(``mmmo``), each with its synthetic set where its files are absent."""
