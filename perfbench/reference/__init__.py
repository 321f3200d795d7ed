"""Plain references, one module per configuration (plus the serving
reference): plain PyTorch and NumPy only, importing nothing of the
program."""
