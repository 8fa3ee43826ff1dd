"""Data adapters of the port: MOSI (``mosi``, the real files and the
synthetic set), MOUD (``moud``), YouTube (``youtube``), MMMO (``mmmo``),
the POM- and IEMOCAP-style multi-trait sets (``multitrait``), each
with its synthetic set where its files are absent, and the
CMU-MultimodalSDK ``.csd`` files of MOSI, MOSEI and POM (``mmsdk``)."""
