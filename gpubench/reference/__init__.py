"""Plain fp32 PyTorch references, independent of the program."""
