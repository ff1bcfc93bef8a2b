"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
command, ``python3 bench/run.py``, driven by the files beside it."""
