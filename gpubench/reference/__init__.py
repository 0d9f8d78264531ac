"""The plain reference: plain PyTorch and NumPy that imports nothing of
the port."""
