"""The plain PyTorch reference the benchmark's answers are held against.
It imports nothing of the program under test."""
