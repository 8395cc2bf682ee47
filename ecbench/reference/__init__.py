"""The plain reference: NumPy and PyTorch only, nothing of the program."""
