"""The plain reference: the served models' forward pass in plain PyTorch
float32, with no kernel, cache or batching of the port. It imports
nothing of ``repro`` or ``repro_torch`` and takes only the configuration
file's numbers and the benchmark's weights."""
