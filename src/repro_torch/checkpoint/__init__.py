from repro_torch.checkpoint.io import load_params, save_params  # noqa: F401
