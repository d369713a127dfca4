from repro_torch.data.synthetic import (SyntheticConfig, SyntheticLM,
                                        batch_struct, make_batch)

__all__ = ["SyntheticConfig", "SyntheticLM", "batch_struct", "make_batch"]
