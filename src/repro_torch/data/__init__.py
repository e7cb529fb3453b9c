"""The data pipeline; port of `repro.data`."""
from repro_torch.data.pipeline import (SyntheticLMDataset,  # noqa: F401
                                       TokenIterator)
