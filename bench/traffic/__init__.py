"""Traffic: each mix is a data file (``<mix>.json``) naming its kind and
parameters; each kind is the code that drives it (``<kind>.py``, a class
``Kind``)."""
