"""The plain float32 reference: MFM and its ablation M_B, Adam, the
plateau schedule. Imports nothing of the program."""
