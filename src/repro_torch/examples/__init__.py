"""The JAX package's six examples (``examples/``), on the port: one
module each, with the same name, run as ``python -m
repro_torch.examples.<name>``. Each takes ``--device`` (default the card;
it raises without one unless ``--device cpu`` is given) beside the JAX
script's own arguments, and calls the port's counterparts of the modules
the JAX script calls."""
