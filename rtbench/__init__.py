"""The port's benchmark: a harness driven by the data files beside it."""
