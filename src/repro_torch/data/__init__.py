from repro_torch.data.pipeline import (DataConfig, batch_for_model,
                                       data_iterator, lm_batch)

__all__ = ["DataConfig", "lm_batch", "batch_for_model", "data_iterator"]
