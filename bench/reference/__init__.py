"""Plain PyTorch references, one file a model family. They import nothing
of the program."""
