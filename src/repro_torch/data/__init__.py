from repro_torch.data.pipeline import (SyntheticLM,  # noqa: F401
                                       text_to_tokens)
