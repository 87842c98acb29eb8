"""The plain reference: float32 PyTorch, importing nothing of the program."""
