"""The benchmark's own count of a step's work, one file a model family:
what the inputs need, whatever implements them."""
