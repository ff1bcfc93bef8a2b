"""Launchers of the port: the train, prefill and serve steps, the training
and serving CLIs."""
